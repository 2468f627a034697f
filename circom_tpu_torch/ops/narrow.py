"""Plain PyTorch versions of the narrow int32 lane of the interpreter.

The 13 narrow opcodes of kernel K1b and the narrow-operand ones of K1d
(nsub, nsel, nidiv, lnot_n and the eight signed *_nn comparisons;
ops/cuda/interp.cu, helpers in ops/cuda/narrow.cuh), the bit unpack of
the narrow witness gather K3 (ops/cuda/gather.cu) and the widening of
narrow values into canonical limb rows.  They copy the semantics of the JAX package's interpreter kernel
(backend/interp.py, `nbranch`, `_unpack_bits`, `_widen_narrow`), including
XLA's rules where C++ leaves the result undefined:

- nadd, nmul, nshl and nmshl wrap mod 2^32;
- nshru, nxbit, nmshru and nrotr shift logically, nshr arithmetically;
- a shift count is read as uint32: a count >= 32 (a negative one included)
  gives 0 for `<<` and for a logical `>>`, and the sign fill for an
  arithmetic `>>`;
- nrotr by r is (a >>u r) | (a << (32 - r)) with both counts under that
  rule, so a rotate by 0 or 32 is the identity and one by 33 gives 0;
- nidiv is jnp's int32 floor division, not C's truncating one, guarded
  to 0 for a zero divisor; INT32_MIN // -1 wraps to INT32_MIN.

Values are int64 tensors holding signed 32-bit values (sign-extended);
shift counts are Python ints or int64 tensors that broadcast against them.
"""

import torch

from ..field.primes import LIMB_BITS

M32 = 0xFFFFFFFF
MASK = (1 << LIMB_BITS) - 1


def i32(x):
    """Low 32 bits of an int64 tensor as a signed value, still int64."""
    return ((x & M32) ^ 0x80000000) - 0x80000000


def to_i32(x):
    """Low 32 bits of an int64 tensor as an int32 tensor (the value is in
    range before the cast, so no out-of-range conversion is relied on)."""
    return i32(x).to(torch.int32)


def _count(s, like):
    return torch.as_tensor(s, dtype=torch.int64, device=like.device) & M32


def shl(x, s):
    """x << s mod 2^32 (0 for a count >= 32)."""
    s = _count(s, x)
    return torch.where(s >= 32, 0, i32(x << s.clamp(max=31)))


def shru(x, s):
    """Logical x >> s (0 for a count >= 32)."""
    s = _count(s, x)
    return torch.where(s >= 32, 0, i32((x & M32) >> s.clamp(max=31)))


def shra(x, s):
    """Arithmetic x >> s (the sign fill for a count >= 32)."""
    return i32(x) >> _count(s, x).clamp(max=31)


def rotr(x, s):
    s = _count(s, x)
    return i32(shru(x, s) | shl(x, (32 - s) & M32))


def nidiv(a, b):
    """a // b rounded to minus infinity, as jnp's int32 `//` (with XLA's
    INT32_MIN // -1 = INT32_MIN), and 0 where b = 0."""
    q = torch.div(a, torch.where(b == 0, 1, b), rounding_mode="floor")
    return torch.where(b == 0, 0, i32(q))


def nsel(a, b, c):
    """b where a != 0, else c."""
    return torch.where(a != 0, b, c)


def _01(mask):
    return mask.to(torch.int64)


# the signed int32 comparisons and booleans of the *_nn opcodes
CMP_NN = {
    "eq": lambda a, b: _01(a == b),
    "neq": lambda a, b: _01(a != b),
    "lt": lambda a, b: _01(a < b),
    "le": lambda a, b: _01(a <= b),
    "gt": lambda a, b: _01(a > b),
    "ge": lambda a, b: _01(a >= b),
    "land": lambda a, b: _01((a != 0) & (b != 0)),
    "lor": lambda a, b: _01((a != 0) | (b != 0)),
}

# name -> f(a, b, aux) over int64 tensors of signed 32-bit values: K1b's
# 13 opcodes, then K1d's narrow ones that read narrow operands only (nsel
# takes three: `nsel` above)
NARROW_OPS = {
    "ncopy": lambda a, b, s: a,
    "nadd": lambda a, b, s: i32(a + b),
    "nmul": lambda a, b, s: i32(a * b),
    "nband": lambda a, b, s: a & b,
    "nbor": lambda a, b, s: a | b,
    "nbxor": lambda a, b, s: a ^ b,
    "nshl": lambda a, b, s: shl(a, s),
    "nshr": lambda a, b, s: shra(a, s),
    "nshru": lambda a, b, s: shru(a, s),
    "nxbit": lambda a, b, s: shru(a, s) & 1,
    "nmshl": lambda a, b, s: shl(a & b, s),
    "nmshru": lambda a, b, s: shru(a & b, s),
    "nrotr": lambda a, b, s: rotr(a, s),
    "nsub": lambda a, b, s: i32(a - b),
    "nidiv": lambda a, b, s: nidiv(a, b),
    "lnot_n": lambda a, b, s: _01(a == 0),
    **{f"{o}_nn": (lambda f: lambda a, b, s: f(a, b))(f)
       for o, f in CMP_NN.items()},
}


def unpack_bits(rows, shifts):
    """rows (W, ...) of 32-bit values, int32 or int64; shifts (W,): a
    negative shift keeps the row, otherwise row := (row >>u shift) & 1 (0
    for a shift >= 32).  Bit s of a sign-extended value is the same under
    an arithmetic shift, so this computes in the rows' own dtype."""
    sh = torch.as_tensor(shifts, device=rows.device).to(rows.dtype) \
        .reshape((-1,) + (1,) * (rows.dim() - 1))
    bit = rows >> sh.clamp(0, 31)
    bit &= 1
    bit.masked_fill_(sh >= 32, 0)
    return torch.where(sh < 0, rows, bit)


def widen_narrow(v, p, L):
    """Signed 32-bit values (..., B) (any integer dtype) -> canonical limb
    rows uint32 (..., L, B): v >= 0 -> [v & m, v >> 16, 0, ...]; v < 0 ->
    (p - 2^32) + uint32(v), one carry chain over p - 2^32's limbs."""
    v = i32(v.to(torch.int64))
    q = p - (1 << 32)
    q_limbs = [(q >> (LIMB_BITS * i)) & MASK for i in range(L)]
    u = v & M32
    lo, hi = u & MASK, u >> LIMB_BITS
    neg = v < 0
    out = torch.empty(v.shape[:-1] + (L, v.shape[-1]), dtype=torch.uint32,
                      device=v.device)
    rows_pos = [lo, hi] + [None] * (L - 2)
    t = lo + q_limbs[0]
    for i in range(L):
        if i == 1:
            t = hi + q_limbs[1] + carry
        elif i > 1:
            t = q_limbs[i] + carry
        carry = t >> LIMB_BITS
        pos = rows_pos[i] if rows_pos[i] is not None else 0
        out[..., i, :] = torch.where(neg, t & MASK, pos).to(torch.int32) \
            .view(torch.uint32)
    return out
