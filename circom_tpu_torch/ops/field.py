"""Batched prime-field arithmetic in PyTorch over base-2^16 limb planes.

An element batch is ``uint32[..., L, B]``: little-endian 16-bit limbs,
limb-major, batch-minor, the layout of the JAX package's field library.
`TorchField` is the plain version of the field kernels: the CPU path of
the port and the reference its CUDA kernels (ops/cuda/field.cuh) are
held against, bit for bit.  It is also the per-op library of the per-op
backend (backend/perop.py), the counterpart of the JAX package's
JaxField (see the section of that name below).

The kernels' plain versions compute in int64 and convert only at the
edges: torch's CPU uint32 has no add, shift or compare.  A limb product
is < 2^32 and a column of L of them < 2^36, so nothing here overflows.
The Montgomery reduction yields (V + M·p)/R with the unique M < R that
clears the low limbs, followed by one conditional subtract of p; those
values depend on V alone, so the int64 column sums here give the same
bits as the 16-bit-split columns of the kernels.  One subtract makes that
value canonical when V < R·p; a lazy dot's V reaches n·p² for n terms,
so its reduction (`mont_reduce_dot64`) subtracts up to
`dot_subtractions` times.
"""

import torch

from ..field.primes import LIMB_BITS, FieldSpec
from .limbs import spec_constants

MASK = (1 << LIMB_BITS) - 1
GOLDILOCKS_P = 18446744069414584321


def as_i64(x):
    """uint32/int32/int64 tensor (or numpy array) -> int64 tensor.  uint32
    converts through an int32 view: PyTorch's uint32 casts are missing on
    some devices."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return x.to(torch.int64)


def as_u32(x):
    """int64 tensor of values in [0, 2^32) -> uint32 (via int32)."""
    return x.to(torch.int32).view(torch.uint32)


def dot_subtractions(p, n_terms, n_bits):
    """S_n, the conditional subtracts of p that leave a lazy dot of n_terms
    canonical: V = sum x_i·c_i + k <= n·(p - 1)² + p - 1 for canonical
    operands, one Montgomery reduction leaves (V + M·p)/R <= (V + (R -
    1)·p)/R, R = 2^n_bits, and that over p rounds down to S_n.  1 at p/R
    below about 1/(n + 1); 2 and 3 for dot2 and dot3 at secq256r1 and
    goldilocks, where p is just under R (ops/cuda/dot32.cuh
    dot_subtractions, the same count for K1)."""
    R = 1 << n_bits
    return (n_terms * (p - 1) ** 2 + p - 1 + (R - 1) * p) // (R * p)


def mont_edge_values(spec: FieldSpec):
    """Edge operands of the Montgomery product, canonical ints: 0, 1,
    p - 1, R^2 mod p, and the values whose limbs below the top are all
    0xFFFF under a top limb of 0 and of p's top limb - 1."""
    L, p = spec.n_limbs, spec.p
    low = (1 << (LIMB_BITS * (L - 1))) - 1
    top = p >> (LIMB_BITS * (L - 1))
    R = 1 << (LIMB_BITS * L)
    return [0, 1, p - 1, R * R % p, low, ((top - 1) << (LIMB_BITS * (L - 1)))
            + low]


class TorchField:
    """Field ops for one prime on int64 or uint32 tensors (..., L, B).

    The ``*64`` methods take and return int64 limb tensors (used by the
    plain interpreter, which keeps its register file in int64); the
    public methods take any integer tensor and return uint32."""

    def __init__(self, spec: FieldSpec, device="cpu"):
        c = spec_constants(spec)
        self.spec = spec
        self.device = torch.device(device)
        self.L = c["L"]
        self.p = c["p"]
        self.n0inv = int(c["n0inv"])
        # -p^-1 mod 2^32, for the 32-bit words of kernel K5
        self.n0inv32 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        self.p_list = [int(x) for x in c["p_limbs"]]
        self.r2_list = [int(x) for x in c["R2_limbs"]]
        # the p/2 pivot of signed comparisons, the complement mask
        # 2^bits - 1 and p - 2^32 (the widening of negative int32s)
        self.half_list = [int(x) for x in c["half_limbs"]]
        self.mask_list = [int(x) for x in c["mask_limbs"]]
        self.q_list = [(self.p - (1 << 32)) >> (LIMB_BITS * i) & MASK
                       for i in range(self.L)]

        def limbs(a):
            return torch.as_tensor(a.astype("int64"),
                                   device=self.device)[:, None]

        self.p_limbs = limbs(c["p_limbs"])          # (L, 1)
        self.R2_limbs = limbs(c["R2_limbs"])
        self.one_limbs = torch.zeros_like(self.p_limbs)
        self.one_limbs[0, 0] = 1
        self.half_limbs = limbs(c["half_limbs"])
        self.mask_limbs = limbs(c["mask_limbs"])
        # 2^i down the limbs: sum_i sign(d_i)·2^i has the sign of the
        # highest nonzero d_i (see `borrows`)
        self.sign_w = torch.as_tensor([1 << i for i in range(self.L)],
                                      dtype=torch.int64,
                                      device=self.device)[:, None]
        self.one_mont_list = [int(x) for x in c["one_mont_limbs"]]
        # S_2, S_3: the subtracts of the lazy dots dot2_c and dot3_c
        self.dot_subs = {n: dot_subtractions(self.p, n, LIMB_BITS * self.L)
                         for n in (2, 3)}
        self._consts = {}

    # -- int64 core ----------------------------------------------------
    def borrows(self, d):
        """The borrow chain of limb differences d (..., L, B), |d_i| <
        2^16, at once: (the borrow into each limb (..., L, B), the borrow
        out (..., B)), int64 0/1.  The borrow into limb i is set when the
        limbs below i differ by a negative amount, whose sign is that of
        the highest nonzero d_j, j < i: the sign of sum_j sign(d_j)·2^j."""
        s = torch.sign(d) * self.sign_w
        pre = torch.cumsum(s, dim=-2)
        return (pre - s < 0).to(torch.int64), \
            (pre[..., -1, :] < 0).to(torch.int64)

    def cond_sub64(self, limbs, top):
        """limbs (..., L, B) of 16 bits + top (..., B): subtract p once
        when the value is >= p (limb_emit.cond_sub), the borrow chain of
        limbs - p taken at once; the low L limbs."""
        return self.cond_sub_keep64(limbs, top)[0]

    def cond_sub_keep64(self, limbs, top):
        """cond_sub64 with the top kept: (limbs, top) less p when that is
        >= p (dot32.cuh cond_sub_keep32)."""
        d = limbs - self.p_limbs
        b_in, b_out = self.borrows(d)
        take = top >= b_out
        return (torch.where(take[..., None, :], (d - b_in) & MASK, limbs),
                torch.where(take, top - b_out, top))

    def _carry(self, cols, n):
        """Carry chain over the first n columns: (limbs, carry out)."""
        carry = torch.zeros_like(cols[..., 0, :])
        limbs = []
        for k in range(n):
            t = cols[..., k, :] + carry
            limbs.append(t & MASK)
            carry = t >> LIMB_BITS
        return torch.stack(limbs, -2), carry

    def add64(self, a, b):
        limbs, carry = self._carry(a + b, self.L)
        return self.cond_sub64(limbs, carry)

    def sub64(self, a, b):
        # a + p - b with a signed carry chain (arithmetic shifts)
        limbs, carry = self._carry(a + self.p_limbs - b, self.L)
        return self.cond_sub64(limbs, carry)

    def mont_reduce64(self, cols):
        """(..., n <= 2L+1, B) columns of V -> (V + M·p)/R, one
        conditional subtract, canonical when V < R·p."""
        return self.cond_sub64(*self._redc64(cols))

    def mont_reduce_dot64(self, cols, n_terms):
        """A lazy dot's reduction (dot32.cuh mont_reduce_dot32): the
        columns of V = sum x_i·c_i + k over n_terms terms -> (V + M·p)/R
        with the top limb kept, less p up to dot_subs[n_terms] times:
        canonical for canonical operands at every field."""
        limbs, top = self._redc64(cols)
        for _ in range(self.dot_subs[n_terms] - 1):
            limbs, top = self.cond_sub_keep64(limbs, top)
        return self.cond_sub64(limbs, top)

    def _redc64(self, cols):
        """(V + M·p)/R of the columns of V before any subtract: (its low L
        limbs (..., L, B), its top limb (..., B))."""
        L = self.L
        n = cols.shape[-2]
        if n < 2 * L + 1:
            pad = torch.zeros(cols.shape[:-2] + (2 * L + 1 - n,)
                              + cols.shape[-1:], dtype=torch.int64,
                              device=cols.device)
            cols = torch.cat([cols, pad], -2)
        else:
            cols = cols.clone()
        for i in range(L):
            m = (cols[..., i, :] * self.n0inv) & MASK
            cols[..., i:i + L, :] += m[..., None, :] * self.p_limbs
            cols[..., i + 1, :] += cols[..., i, :] >> LIMB_BITS
        limbs, _ = self._carry(cols[..., L:, :], L + 1)
        return limbs[..., :L, :], limbs[..., L, :]

    def product_cols64(self, a, b):
        """Schoolbook product columns (..., 2L+1, B) of a·b."""
        L = self.L
        shape = torch.broadcast_shapes(a.shape, b.shape)
        cols = torch.zeros(shape[:-2] + (2 * L + 1, shape[-1]),
                           dtype=torch.int64, device=a.device)
        for i in range(L):
            cols[..., i:i + L, :] += a[..., i:i + 1, :] * b
        return cols

    def mont_mul64(self, a, b):
        return self.mont_reduce64(self.product_cols64(a, b))

    # -- uint32 edge ---------------------------------------------------
    def add(self, a, b):
        return as_u32(self.add64(as_i64(a), as_i64(b)))

    def sub(self, a, b):
        return as_u32(self.sub64(as_i64(a), as_i64(b)))

    def mont_mul(self, a, b):
        """a·b·R^-1 mod p (the CIOS kernel's function)."""
        return as_u32(self.mont_mul64(as_i64(a), as_i64(b)))

    def mont_reduce_cols(self, cols):
        """Wide column sums (..., <= 2L+1, B), V < R·p -> V·R^-1 mod p."""
        return as_u32(self.mont_reduce64(as_i64(cols)))

    def to_mont(self, a):
        return as_u32(self.mont_mul64(as_i64(a), self.R2_limbs))

    def from_mont(self, a):
        return as_u32(self.mont_mul64(as_i64(a), self.one_limbs))

    @staticmethod
    def is_zero(a):
        """(..., L, B) -> bool (..., B)."""
        return (as_i64(a) == 0).all(dim=-2)

    # -- the per-op library (the JAX package's JaxField, jfield.py) ----
    # uint32 (..., L, B) in and out, operands broadcast against each
    # other.  mont_mul, add and sub go through ops/field_kernels.py:
    # kernels K5 and K6 on a CUDA tensor, the plain versions above on the
    # CPU, as JaxField sends them to Pallas on the TPU.  The comparisons,
    # booleans, bit ops, shifts, idiv and select are thin adapters over
    # ops/wide.py's plain functions (the ones K1 and K4 are held against)
    # on int64 limbs, each over whole limb tensors: a few launches a call
    # on the card, none a limb.
    def _const_u32(self, limbs, like):
        """A constant (L, 1) on like's device, copied there once: a copy
        from pageable host memory waits for the device's stream."""
        key = (tuple(int(v) for v in limbs), like.device)
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = torch.as_tensor(
                key[0], dtype=torch.int32,
                device=like.device)[:, None].view(torch.uint32)
        return c

    def _emit(self, op, *xs):
        """wide.emit's op on uint32 operands."""
        return as_u32(_wide().emit(self, op, *map(as_i64, xs)))

    def neg(self, a):
        return _kernels().sub(self, self._const_u32([0] * self.L, a), a)

    def mul_norm(self, a, b):
        """Product of two canonical values, canonical (2 Montgomery
        products: a·b·R^-1, then · R^2)."""
        fk = _kernels()
        return fk.mont_mul(self, fk.mont_mul(self, a, b),
                           self._const_u32(self.r2_list, a))

    def pow_mont(self, a, e: int):
        """a^e in Montgomery form, a Python loop over the exponent's bits
        (left to right, a square a bit and a product a set bit)."""
        fk = _kernels()
        if e == 0:
            return self._const_u32(self.one_mont_list, a).expand(a.shape)
        acc = a
        for bit in bin(e)[3:]:
            acc = fk.mont_mul(self, acc, acc)
            if bit == "1":
                acc = fk.mont_mul(self, acc, a)
        return acc

    def pow_dyn(self, a, e):
        """a^e[s] in Montgomery form for each slot s of a (S, L, B), e
        int64 (S,) in [0, 2^31): the scan's per-slot power
        (backend/jax_backend.py `_branch` pow_dyn), 32 rounds from one of
        a square and a product kept where bit 31 - i of e is set."""
        fk = _kernels()
        acc = self._const_u32(self.one_mont_list, a).expand(a.shape)
        for i in range(32):
            acc = fk.mont_mul(self, acc, acc)
            bit = ((e >> (31 - i)) & 1).bool()[:, None, None]
            acc = torch.where(bit, fk.mont_mul(self, acc, a).view(torch.int32),
                              acc.view(torch.int32)).view(torch.uint32)
        return acc

    def inv_mont(self, a):
        """Fermat inversion a^(p-2); 0 maps to 0."""
        return self.pow_mont(a, self.p - 2)

    def div_mont(self, a, b):
        return _kernels().mont_mul(self, a, self.inv_mont(b))

    def eq(self, a, b):
        return self._emit("eq", a, b)

    def neq(self, a, b):
        return self._emit("neq", a, b)

    def lt(self, a, b):
        return self._emit("lt", a, b)

    def le(self, a, b):
        return self._emit("le", a, b)

    def gt(self, a, b):
        return self._emit("gt", a, b)

    def ge(self, a, b):
        return self._emit("ge", a, b)

    def bool_and(self, a, b):
        return self._emit("land", a, b)

    def bool_or(self, a, b):
        return self._emit("lor", a, b)

    def bool_not(self, a):
        return self._emit("lnot", a)

    def bit_and(self, a, b):
        return self._emit("band", a, b)

    def bit_or(self, a, b):
        return self._emit("bor", a, b)

    def bit_xor(self, a, b):
        return self._emit("bxor", a, b)

    def complement(self, a):
        """~a over p.bit_length() bits, mod p."""
        return self._emit("bnot", a)

    def shift_r_const(self, a, k: int):
        """a >> k for a static k >= 0."""
        return as_u32(_wide().shift_w(self, as_i64(a), k, False))

    def shift_l_const(self, a, k: int):
        """(a << k) masked to the field's bits, mod p; static k >= 0."""
        return as_u32(_wide().shift_w(self, as_i64(a), k, True))

    def shift_r_dyn(self, a, k):
        """a >> k[s] for each slot s of a (S, L, B), k int64 (S,) >= 0."""
        return as_u32(_wide().shift_dyn(self, as_i64(a), k, False))

    def shift_l_dyn(self, a, k):
        """(a << k[s]) masked to the field's bits, mod p, for each slot s
        of a (S, L, B), k int64 (S,) >= 0."""
        return as_u32(_wide().shift_dyn(self, as_i64(a), k, True))

    def idiv(self, a, b):
        """a // b of canonical representatives, idiv(a, 0) = 0 (jfield.idiv,
        the long division of wide.idiv64)."""
        return as_u32(_wide().idiv64(self, as_i64(a), as_i64(b)))

    def imod(self, a, b):
        """a mod b of canonical representatives, mod(a, 0) = a: a -
        (a // b)·b, whose product and difference stay below p."""
        return _kernels().sub(self, a, self.mul_norm(self.idiv(a, b), b))

    def select(self, c, a, b):
        """circom ?: — a where the field value c is nonzero, else b."""
        return self._emit("select", c, a, b)


def _kernels():
    """ops/field_kernels.py (K5, K6), imported at first use: it imports
    this module."""
    from . import field_kernels

    return field_kernels


def _wide():
    """ops/wide.py, imported at first use: it imports this module."""
    from . import wide

    return wide
