"""Plain PyTorch versions of the wide opcodes of K1c, K1d and K4.

The counterpart of ops/narrow.py for the wide lane of the interpreter
kernel (ops/cuda/interp.cu, device arithmetic in ops/cuda/wide.cuh) and
for the segment kernel (ops/segment_gen.py): the goldilocks folded
product, the 16 ops of the JAX package's `LimbEmitter.emit`
(ops/limb_emit.py), the limb shifts, the widening of a narrow value and
the long division of backend/interp.py's `wbranch`, with the values of
the JAX code bit for bit.  They are also the per-op library's
comparisons, bit ops, shifts and division (ops/field.py `TorchField`), so
each op is written over whole limb tensors: a borrow chain is one prefix
sum (`TorchField.borrows`), a shift two slices, not a loop over limbs.

Operands are int64 limb tensors (..., L, B) of canonical field elements
(16-bit limbs); a constant (L, 1) broadcasts against them.  The JAX code
computes these in uint32 and int32; every intermediate here is small
enough that int64 gives the same values, with `>>` arithmetic on
negative carries as in int32.
"""

import torch

from ..field.primes import LIMB_BITS
from .field import GOLDILOCKS_P, TorchField
from .narrow import widen_narrow

MASK = (1 << LIMB_BITS) - 1

# the 16 ops of LimbEmitter.emit that the interpreter runs on the wide lane
EMIT_OPS = ("add", "sub", "select", "eq", "neq", "lt", "le", "gt", "ge",
            "land", "lor", "lnot", "band", "bor", "bxor", "bnot")


def _zero(x):
    return torch.zeros_like(x[..., 0, :])


def nonzero(x):
    """(..., L, B) -> bool (..., B): the value is not 0."""
    return (x != 0).any(dim=-2)


def _bit(mask, like):
    """A 0/1 field element from a bool (..., B)."""
    out = torch.zeros(mask.shape[:-1] + (like.shape[-2], mask.shape[-1]),
                      dtype=torch.int64, device=mask.device)
    out[..., 0, :] = mask.to(torch.int64)
    return out


def _ult(field, x, y):
    """x < y as unsigned integers: the borrow out of x - y."""
    return field.borrows(x - y)[1] > 0


def _lt_signed(field, x, y):
    # x > p/2 is negative (limb_emit's is_neg)
    na, nb = _ult(field, field.half_limbs, x), _ult(field, field.half_limbs, y)
    d = na ^ nb
    return (d & na) | (~d & _ult(field, x, y))


def emit(field: TorchField, op, x, y=None, z=None):
    """One of EMIT_OPS on canonical operands, as LimbEmitter.emit: a
    comparison or boolean op gives 0 or 1 (signed by the p/2 rule), bor,
    bxor and bnot end in one conditional subtract of p."""
    if op == "add":
        return field.add64(x, y)
    if op == "sub":
        return field.sub64(x, y)
    if op == "select":
        return torch.where(nonzero(x)[..., None, :], y, z)
    if op == "band":
        return x & y
    if op in ("bor", "bxor"):
        v = x | y if op == "bor" else x ^ y
        return field.cond_sub64(v, _zero(v))
    if op == "bnot":
        v = x ^ field.mask_limbs
        return field.cond_sub64(v, _zero(v))
    if op in ("eq", "neq"):
        m = (x == y).all(dim=-2)
        return _bit(m if op == "eq" else ~m, x)
    if op == "lt":
        return _bit(_lt_signed(field, x, y), x)
    if op == "le":
        return _bit(~_lt_signed(field, y, x), x)
    if op == "gt":
        return _bit(_lt_signed(field, y, x), x)
    if op == "ge":
        return _bit(~_lt_signed(field, x, y), x)
    if op == "land":
        return _bit(nonzero(x) & nonzero(y), x)
    if op == "lor":
        return _bit(nonzero(x) | nonzero(y), x)
    if op == "lnot":
        return _bit(~nonzero(x), x)
    raise ValueError(f"not an emit op: {op}")


def _schain(vals):
    """Signed carry chain over 16-bit limbs: (limbs, carry out)."""
    carry = 0
    out = []
    for v in vals:
        v = v + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return out, carry


def gl_mul64(field: TorchField, a, b, carries=False):
    """Goldilocks a·b mod p by folding (limb_emit.gl_mul): with the 16-bit
    product columns c0..c7, 2^64 = 2^32 - 1 and 2^96 = -1 give
    [c0-c4-c6, c1-c5-c7, c2+c4, c3+c5]; two signed carry chains, the
    t2 in {-1, 0, 1} select-add, the t3 fixup and one conditional
    subtract follow.  carries=True also returns t2 and t3."""
    if field.p != GOLDILOCKS_P:
        raise ValueError("gl_mul64 is the goldilocks product")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    zero = torch.zeros(shape[:-2] + shape[-1:], dtype=torch.int64,
                       device=a.device)
    cols = [zero] * 8
    for i in range(4):
        for j in range(4):
            prod = a[..., i, :] * b[..., j, :]
            cols[i + j] = cols[i + j] + (prod & MASK)
            cols[i + j + 1] = cols[i + j + 1] + (prod >> LIMB_BITS)
    c = cols
    a1, t = _schain([c[0] - c[4] - c[6], c[1] - c[5] - c[7], c[2] + c[4],
                     c[3] + c[5]])
    # fold t·2^64 = t·2^32 - t
    b1, t2 = _schain([a1[0] - t, a1[1], a1[2] + t, a1[3]])
    # t2 in {-1, 0, 1}: add t2·(2^32 - 1), as [FFFF, FFFF, 0, 0] or
    # -(2^32 - 1) = p - 2^32 + 1 = [2, 0, FFFE, FFFF]
    pos, neg = (0xFFFF, 0xFFFF, 0, 0), (2, 0, 0xFFFE, 0xFFFF)
    adj = [torch.where(t2 > 0, pos[i], torch.where(t2 < 0, neg[i], 0))
           for i in range(4)]
    f1, t3 = _schain([b1[i] + adj[i] for i in range(4)])
    fix = torch.where(t3 > 0, 0xFFFF, 0)
    g1, _ = _schain([f1[0] + fix, f1[1] + fix, f1[2], f1[3]])
    out = field.cond_sub64(torch.stack(g1, -2), zero)
    return (out, t2, t3) if carries else out


def shift_w(field: TorchField, x, count, left):
    """x << count (masked to the field's bits, then one conditional
    subtract) or x >> count, by q = count // 16 limbs and r = count % 16
    bits; count >= 0 (backend/interp.py `shift_w`).  A limb j takes limb
    j -+ q shifted by r and the r bits that cross from its neighbour."""
    L = field.L
    q, r = divmod(int(count), LIMB_BITS)
    out = torch.zeros_like(x)
    if q < L and left:
        out[..., q:, :] = (x[..., :L - q, :] << r) & MASK
        if r and q + 1 < L:
            out[..., q + 1:, :] |= x[..., :L - q - 1, :] >> (LIMB_BITS - r)
    elif q < L:
        out[..., :L - q, :] = x[..., q:, :] >> r
        if r and q + 1 < L:
            out[..., :L - q - 1, :] |= \
                (x[..., q + 1:, :] << (LIMB_BITS - r)) & MASK
    if not left:
        return out
    out &= field.mask_limbs
    return field.cond_sub64(out, _zero(out))


def shift_dyn(field: TorchField, x, k, left):
    """x << k[s] (masked to the field's bits, then one conditional
    subtract) or x >> k[s] for each slot s of x (S, L, B), k int64 (S,)
    >= 0: the scan's per-slot shifts (backend/jax_backend.py `_branch`
    shl_dyn / shr_dyn).  Limb j takes limb j -+ q and its neighbour
    j -+ (q + 1), zero beyond the limbs, q = k // 16, r = k % 16."""
    L = field.L
    q = (k // LIMB_BITS)[:, None, None]
    r = (k % LIMB_BITS)[:, None, None]
    j = torch.arange(L, device=x.device)[None, :, None]
    step = -1 if left else 1
    idx = j + step * q

    def take(i):
        g = torch.gather(x, -2, i.clamp(0, L - 1).expand(x.shape))
        return torch.where((i >= 0) & (i < L), g, 0)

    g, g2 = take(idx), take(idx + step)
    if not left:
        return (g >> r) | ((g2 << (LIMB_BITS - r)) & MASK)
    out = (((g << r) & MASK) | (g2 >> (LIMB_BITS - r))) & field.mask_limbs
    return field.cond_sub64(out, _zero(out))


def widen64(field: TorchField, v):
    """Signed 32-bit values (..., B) -> canonical limbs int64 (..., L, B):
    v, or p + v for v < 0 (backend/interp.py `widen_rows`)."""
    out = widen_narrow(v, field.p, field.L)
    return out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def idiv64(field: TorchField, a, b):
    """a // b for canonical a and b, 0 where b = 0 (backend/interp.py
    `idiv_rows`): p.bit_length() steps of shift-in, compare and
    predicated subtract, each on whole limb tensors; the bit shifted out
    of the top limb forces the subtract, and the difference mod 2^(16L)
    is then exact."""
    L = field.L
    bits = field.p.bit_length()
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    R = torch.zeros(shape, dtype=torch.int64, device=a.device)
    Q = torch.zeros_like(R)
    for t in range(bits):
        li, sh = divmod(bits - 1 - t, LIMB_BITS)
        topbit = R[..., L - 1:, :] >> (LIMB_BITS - 1)
        shifted_in = torch.cat([(a[..., li:li + 1, :] >> sh) & 1,
                                R[..., :-1, :] >> (LIMB_BITS - 1)], dim=-2)
        R = ((R << 1) & MASK) | shifted_in
        d = R - b
        b_in, b_out = field.borrows(d)
        ge = (topbit != 0) | (b_out[..., None, :] == 0)
        R = torch.where(ge, (d - b_in) & MASK, R)
        Q[..., li:li + 1, :] |= ge.to(torch.int64) << sh
    return torch.where(nonzero(b)[..., None, :], Q, 0)


def band_w(x, c):
    """nband_w: limbs 0 and 1 of a wide value ANDed with those of a bank
    row, packed into a signed 32-bit value (int64)."""
    v = (x[..., 0, :] & c[..., 0, :]) \
        | ((x[..., 1, :] & c[..., 1, :]) << LIMB_BITS)
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
