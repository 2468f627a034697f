"""Batched prime-field arithmetic in PyTorch over base-2^16 limb planes.

An element batch is ``uint32[..., L, B]``: little-endian 16-bit limbs,
limb-major, batch-minor, the layout of the JAX package's field library.
`TorchField` is the plain version of the field kernels: the CPU path of
the port and the reference its CUDA kernels (ops/cuda/field.cuh) are
held against, bit for bit.

Every function computes in int64 and converts only at the edges: torch's
CPU uint32 has no add, shift or compare.  A limb product is < 2^32 and a
column of L of them < 2^36, so nothing here overflows.  The Montgomery
reduction yields (V + M·p)/R with the unique M < R that clears the low
limbs, followed by one conditional subtract of p; those values depend on
V alone, so the int64 column sums here give the same bits as the
16-bit-split columns of the kernels.
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

    # -- int64 core ----------------------------------------------------
    def cond_sub64(self, limbs, top):
        """limbs (..., L, B) + top (..., B): subtract p once when the
        value is >= p (limb_emit.cond_sub, step for step)."""
        borrow = torch.zeros_like(top)
        subbed = []
        for i in range(self.L):
            v = limbs[..., i, :] - self.p_limbs[i] - borrow
            subbed.append(v & MASK)
            borrow = -(v >> LIMB_BITS)
        take = (top - borrow) >= 0
        return torch.where(take[..., None, :], torch.stack(subbed, -2), limbs)

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
        return self.cond_sub64(limbs[..., :L, :], limbs[..., L, :])

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
