// The wide ops beyond the Montgomery product over base-2^16 limbs held in
// uint32, one field element per thread: the goldilocks folded product, the
// signed comparisons, booleans, masked bit ops, shifts, the widening of a
// narrow value and the long division.
//
// No kernel includes this header: K1, K4 and KS compute these ops in
// 32-bit words (wide32.cuh).  It stays as the host oracle of
// tests/test_torch_k1_cd_words.py, which builds it by g++ beside
// wide32.cuh and holds every word op against its 16-bit version here bit
// for bit (gl_mul, cmp_wide, nonzero, shift_w, widen, idiv).
//
// Ports, step for step, the JAX package's ops/limb_emit.py (gl_mul and the
// emit ops: signed comparisons by the p/2 rule, booleans, masked bit ops
// ending in one conditional subtract) and the limb shifts, the widening of
// a narrow value and the long division of backend/interp.py (`wbranch`),
// so the results are bit-identical to the JAX kernel's.  The plain PyTorch
// versions are ops/wide.py.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace ctpu {

constexpr int MAX_L = 16;

// Field constants of the K1d opcodes, a kernel parameter beside FieldConsts.
struct WideConsts {
  uint32_t half[MAX_L];  // p / 2, the pivot of the sign rule
  uint32_t mask[MAX_L];  // 2^bits - 1, the complement and shift mask
  uint32_t q[MAX_L];     // p - 2^32, the widening of a negative int32
  int bits;              // p.bit_length(), the long division's steps
};

// Signed 16-bit carry chain step: v & 0xFFFF and the carry v >> 16, an
// arithmetic shift (nvcc shifts signed values arithmetically).
__device__ __forceinline__ int32_t schain_step(int32_t v, int32_t& carry) {
  v += carry;
  carry = v >> LIMB_BITS;
  return v & (int32_t)MASK;
}

// Goldilocks a*b mod p by folding (limb_emit.gl_mul): 2^64 = 2^32 - 1 and
// 2^96 = -1 fold the eight product columns into four signed limbs; two
// carry chains, a select-add of t2 * (2^32 - 1) for t2 in {-1, 0, 1}, the
// t3 fixup and one conditional subtract follow.
__device__ __forceinline__ void gl_mul(const uint32_t (&a)[4],
                                       const uint32_t (&b)[4],
                                       uint32_t (&out)[4],
                                       const FieldConsts& fc) {
  uint32_t cols[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t prod = a[i] * b[j];  // exact: both < 2^16
      cols[i + j] += prod & MASK;
      cols[i + j + 1] += prod >> LIMB_BITS;
    }
  }
  int32_t c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = (int32_t)cols[k];
  int32_t t = 0, t2 = 0, t3 = 0, t4 = 0;
  int32_t a1[4] = {c[0] - c[4] - c[6], c[1] - c[5] - c[7], c[2] + c[4],
                   c[3] + c[5]};
#pragma unroll
  for (int i = 0; i < 4; ++i) a1[i] = schain_step(a1[i], t);
  // fold t * 2^64 = t * 2^32 - t
  int32_t b1[4] = {a1[0] - t, a1[1], a1[2] + t, a1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) b1[i] = schain_step(b1[i], t2);
  // + (2^32 - 1) = [FFFF, FFFF, 0, 0]; - (2^32 - 1) = [2, 0, FFFE, FFFF]
  const int32_t pos[4] = {0xFFFF, 0xFFFF, 0, 0};
  const int32_t neg[4] = {2, 0, 0xFFFE, 0xFFFF};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b1[i] = schain_step(b1[i] + (t2 > 0 ? pos[i] : t2 < 0 ? neg[i] : 0), t3);
  const int32_t fix = t3 > 0 ? 0xFFFF : 0;
  b1[0] += fix;
  b1[1] += fix;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (uint32_t)schain_step(b1[i], t4);
  cond_sub<4>(out, 0, fc);
}

// x < y as unsigned integers: the borrow out of x - y.
template <int L>
__device__ __forceinline__ bool ult(const uint32_t (&x)[L],
                                    const uint32_t (&y)[L]) {
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int32_t v = (int32_t)x[i] - (int32_t)y[i] - borrow;
    borrow = -(v >> LIMB_BITS);
  }
  return borrow > 0;
}

// x > p/2: negative under the field's sign rule.
template <int L>
__device__ __forceinline__ bool is_neg(const uint32_t (&x)[L],
                                       const WideConsts& wc) {
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int32_t v = (int32_t)wc.half[i] - (int32_t)x[i] - borrow;
    borrow = -(v >> LIMB_BITS);
  }
  return borrow > 0;
}

template <int L>
__device__ __forceinline__ bool lt_signed(const uint32_t (&x)[L],
                                          const uint32_t (&y)[L],
                                          const WideConsts& wc) {
  const bool na = is_neg<L>(x, wc), nb = is_neg<L>(y, wc);
  return na != nb ? na : ult<L>(x, y);
}

template <int L>
__device__ __forceinline__ bool nonzero(const uint32_t (&x)[L]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) acc |= x[i];
  return acc != 0;
}

// The comparisons and booleans of limb_emit.emit, in the order of the
// opcodes eq neq lt le gt ge land lor.
enum Cmp { CMP_EQ, CMP_NEQ, CMP_LT, CMP_LE, CMP_GT, CMP_GE, CMP_LAND, CMP_LOR };

template <int L, int C>
__device__ __forceinline__ bool cmp_wide(const uint32_t (&x)[L],
                                         const uint32_t (&y)[L],
                                         const WideConsts& wc) {
  if constexpr (C == CMP_EQ || C == CMP_NEQ) {
    bool eq = true;
#pragma unroll
    for (int i = 0; i < L; ++i) eq = eq && x[i] == y[i];
    return C == CMP_EQ ? eq : !eq;
  } else if constexpr (C == CMP_LT) {
    return lt_signed<L>(x, y, wc);
  } else if constexpr (C == CMP_LE) {
    return !lt_signed<L>(y, x, wc);
  } else if constexpr (C == CMP_GT) {
    return lt_signed<L>(y, x, wc);
  } else if constexpr (C == CMP_GE) {
    return !lt_signed<L>(x, y, wc);
  } else if constexpr (C == CMP_LAND) {
    return nonzero<L>(x) && nonzero<L>(y);
  } else {
    return nonzero<L>(x) || nonzero<L>(y);
  }
}

// x << count (masked to the field's bits, then one conditional subtract)
// or x >> count, count >= 0, by q = count / 16 limbs and r = count % 16
// bits.  xr points at limb 0 of the operand, limb i at xr[i * stride]; the
// limbs are read in place because their index depends on the count.
template <int L, bool LEFT>
__device__ __forceinline__ void shift_w(const uint32_t* xr, long long stride,
                                        int count, uint32_t (&out)[L],
                                        const FieldConsts& fc,
                                        const WideConsts& wc) {
  const int q = count / LIMB_BITS;
  const uint32_t r = (uint32_t)(count % LIMB_BITS);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    // limbs lo = j -+ q and hi = lo -+ 1, 0 outside the value
    const int lo = LEFT ? j - q : j + q;
    const int hi = LEFT ? lo - 1 : lo + 1;
    const uint32_t vlo = (lo >= 0 && lo < L) ? xr[lo * stride] : 0u;
    const uint32_t vhi = (hi >= 0 && hi < L) ? xr[hi * stride] : 0u;
    if (LEFT)
      out[j] = (((vlo << r) & MASK) | (vhi >> (LIMB_BITS - r))) & wc.mask[j];
    else
      out[j] = (vlo >> r) | ((vhi << (LIMB_BITS - r)) & MASK);
  }
  if (LEFT) cond_sub<L>(out, 0, fc);
}

// A narrow signed int32 as canonical limbs: v, or p + v = (p - 2^32) +
// uint32(v) for v < 0, one carry chain over p - 2^32's limbs.
template <int L>
__device__ __forceinline__ void widen(int32_t v, uint32_t (&out)[L],
                                      const WideConsts& wc) {
  const uint32_t u = (uint32_t)v, lo = u & MASK, hi = u >> LIMB_BITS;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t t = wc.q[i] + (i == 0 ? lo : i == 1 ? hi : 0u) + carry;
    carry = t >> LIMB_BITS;
    out[i] = v < 0 ? (t & MASK) : (i == 0 ? lo : i == 1 ? hi : 0u);
  }
}

// a / b for canonical a and b, 0 for b = 0 (backend/interp.py idiv_rows):
// wc.bits steps of shift-in, compare and predicated subtract, the bit
// shifted out of the top limb forcing the subtract (the difference mod
// 2^(16L) is then exact).  The quotient shifts in one bit a step, which
// leaves the JAX code's bit i2 at position i2.  ar points at limb 0 of
// a (limb i at ar[i * stride]): one bit of it is read per step.
template <int L>
__device__ __forceinline__ void idiv(const uint32_t* ar, long long stride,
                                     const uint32_t (&b)[L],
                                     uint32_t (&quo)[L],
                                     const WideConsts& wc) {
  uint32_t R[L];
#pragma unroll
  for (int j = 0; j < L; ++j) R[j] = quo[j] = 0;
#pragma unroll 1
  for (int i2 = wc.bits - 1; i2 >= 0; --i2) {
    const uint32_t bit =
        (ar[(i2 / LIMB_BITS) * stride] >> (i2 % LIMB_BITS)) & 1u;
    const uint32_t topbit = R[L - 1] >> (LIMB_BITS - 1);
#pragma unroll
    for (int j = L - 1; j > 0; --j)
      R[j] = ((R[j] << 1) & MASK) | (R[j - 1] >> (LIMB_BITS - 1));
    R[0] = ((R[0] << 1) & MASK) | bit;
    int32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t v = (int32_t)R[j] - (int32_t)b[j] - borrow;
      borrow = -(v >> LIMB_BITS);
    }
    const bool ge = topbit != 0 || borrow == 0;
    borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t v = (int32_t)R[j] - (int32_t)b[j] - borrow;
      borrow = -(v >> LIMB_BITS);
      R[j] = ge ? (uint32_t)(v & (int32_t)MASK) : R[j];
    }
#pragma unroll
    for (int j = L - 1; j > 0; --j)
      quo[j] = ((quo[j] << 1) & MASK) | (quo[j - 1] >> (LIMB_BITS - 1));
    quo[0] = ((quo[0] << 1) & MASK) | (ge ? 1u : 0u);
  }
  if (!nonzero<L>(b)) {
#pragma unroll
    for (int j = 0; j < L; ++j) quo[j] = 0;
  }
}

}  // namespace ctpu
