// The wide ops beyond the product in 32-bit words: the goldilocks product
// as one 64-bit word (K1c), and K1d's signed comparisons by the p/2 rule,
// booleans, masked bit ops, shifts, the widening of a narrow value and the
// long division, over N = L/2 words of a field element.  K1, KS and the
// segment kernels K4 compute with them.
//
// Each equals, bit for bit, its 16-bit counterpart in wide.cuh (kept as
// the tests' host oracle) on every operand of L 16-bit limbs: both compute
// the same integer function of the same 16L-bit value.
// - Comparisons, nonzero tests and bit ops do not depend on the base; the
//   conditional subtract (cond_sub32) takes p when its value is >= p, a
//   decision on that value alone.
// - A shift by `count` moves the same bits whether it is split as count /
//   16 limbs and count % 16 bits or count / 32 words and count % 32 bits.
// - The long division keeps a 16L-bit remainder, shifts one bit of the
//   dividend in a step and subtracts when the bit shifted out of the top or
//   the comparison says so, the same integers in either base.
// - gl_mul64 reduces the 128-bit product with 2^64 = 2^32 - 1 and 2^96 = -1
//   (mod p) and subtracts p once: the canonical a*b mod p for every pair of
//   64-bit operands.  wide.cuh's gl_mul folds the same product over 16-bit
//   columns and also ends canonical (its carries t2 in {-1, 0, 1} and t3
//   in {0, 1} lose no bit, and its result is below 2^64 < 2p before the
//   subtract), so the two agree on every operand, p - 1 included.
//
// Plain C++ on 32- and 64-bit integers, no inline PTX: g++ compiles this
// header for the host (tests/test_torch_k1_cd_words.py, with the CUDA
// qualifiers defined away) and holds it against wide.cuh and ops/wide.py.
#pragma once

#include <cstdint>

#include "field32.cuh"

namespace ctpu {

// The comparisons and booleans in the order of the opcodes eq neq lt le gt
// ge land lor (and of their *_ww forms).
enum WordCmp {
  WCMP_EQ, WCMP_NEQ, WCMP_LT, WCMP_LE, WCMP_GT, WCMP_GE, WCMP_LAND, WCMP_LOR
};

template <int N>
__device__ __forceinline__ bool nonzero32(const uint32_t (&x)[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= x[i];
  return acc != 0;
}

// x < y as unsigned integers, from the low word up: each word decides
// where it differs, the words below decide where it is equal.
template <int N>
__device__ __forceinline__ bool ult32(const uint32_t (&x)[N],
                                      const uint32_t (&y)[N]) {
  bool lt = false;
#pragma unroll
  for (int i = 0; i < N; ++i) lt = x[i] < y[i] || (x[i] == y[i] && lt);
  return lt;
}

// x < y under the field's sign rule: a value above p/2 is negative.
template <int N>
__device__ __forceinline__ bool lt_signed32(const uint32_t (&x)[N],
                                            const uint32_t (&y)[N],
                                            const uint32_t (&half)[N]) {
  const bool na = ult32<N>(half, x), nb = ult32<N>(half, y);
  return na != nb ? na : ult32<N>(x, y);
}

// One of the comparisons and booleans (C a WordCmp), 0 or 1.
template <int N, int C>
__device__ __forceinline__ bool cmp32(const uint32_t (&x)[N],
                                      const uint32_t (&y)[N],
                                      const uint32_t (&half)[N]) {
  if constexpr (C == WCMP_EQ || C == WCMP_NEQ) {
    uint32_t diff = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) diff |= x[i] ^ y[i];
    return C == WCMP_EQ ? diff == 0 : diff != 0;
  } else if constexpr (C == WCMP_LT) {
    return lt_signed32<N>(x, y, half);
  } else if constexpr (C == WCMP_LE) {
    return !lt_signed32<N>(y, x, half);
  } else if constexpr (C == WCMP_GT) {
    return lt_signed32<N>(y, x, half);
  } else if constexpr (C == WCMP_GE) {
    return !lt_signed32<N>(x, y, half);
  } else if constexpr (C == WCMP_LAND) {
    return nonzero32<N>(x) && nonzero32<N>(y);
  } else {
    return nonzero32<N>(x) || nonzero32<N>(y);
  }
}

// v - p when v >= p, else v, for v < 2^(32N) (the top word 0).
template <int N>
__device__ __forceinline__ void reduce_once32(uint32_t (&v)[N],
                                              const uint32_t (&p)[N]) {
  uint32_t t[N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
  t[N] = 0;
  cond_sub32<N>(t, p, v);
}

// The bit ops band, bor, bxor (OP 0, 1, 2) of two values; bor and bxor
// end in one conditional subtract, as limb_emit's do.
template <int N, int OP>
__device__ __forceinline__ void bitop32(const uint32_t (&x)[N],
                                        const uint32_t (&y)[N],
                                        const uint32_t (&p)[N],
                                        uint32_t (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = OP == 0 ? x[i] & y[i] : OP == 1 ? x[i] | y[i] : x[i] ^ y[i];
  if (OP != 0) reduce_once32<N>(out, p);
}

// bnot: x XOR 2^bits - 1, then one conditional subtract.
template <int N>
__device__ __forceinline__ void bnot32(const uint32_t (&x)[N],
                                       const uint32_t (&mask)[N],
                                       const uint32_t (&p)[N],
                                       uint32_t (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x[i] ^ mask[i];
  reduce_once32<N>(out, p);
}

// x << count (masked to the field's bits, then one conditional subtract)
// or x >> count, count >= 0, by q = count / 32 words and r = count % 32
// bits.  word(i) reads word i of x in place: the words an output word
// takes depend on the count, which is the same in every lane (the table's
// immediate), so each output word reads the two it needs.  KEEP: the
// result words to compute, a bit each, the others left unset (the segment
// kernels K4 pass the words that are read later, so that a bit
// decomposition's code holds a word a bit, not N; a left shift computes
// them all for its conditional subtract).
template <int N, bool LEFT, uint32_t KEEP = 0xFFFFFFFFu, class Word>
__device__ __forceinline__ void shift32(Word word, int count,
                                        const uint32_t (&p)[N],
                                        const uint32_t (&mask)[N],
                                        uint32_t (&out)[N]) {
  static_assert(!LEFT || KEEP == 0xFFFFFFFFu, "a left shift keeps all words");
  const int q = count / 32;
  const uint32_t r = (uint32_t)(count % 32);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!((KEEP >> j) & 1u)) continue;
    // words lo = j -+ q and hi = lo -+ 1, 0 outside the value
    const int lo = LEFT ? j - q : j + q;
    const int hi = LEFT ? lo - 1 : lo + 1;
    const uint32_t vlo = (lo >= 0 && lo < N) ? word(lo) : 0u;
    const uint32_t vhi = (r != 0 && hi >= 0 && hi < N) ? word(hi) : 0u;
    if (LEFT)
      out[j] = ((vlo << r) | (r ? vhi >> (32 - r) : 0u)) & mask[j];
    else
      out[j] = (vlo >> r) | (r ? vhi << (32 - r) : 0u);
  }
  if (LEFT) reduce_once32<N>(out, p);
}

// A narrow signed int32 as a canonical field element: v, or p + v =
// (p - 2^32) + uint32(v) for v < 0, one carry chain over q = p - 2^32.
template <int N>
__device__ __forceinline__ void widen32(int32_t v, const uint32_t (&q)[N],
                                        uint32_t (&out)[N]) {
  const uint32_t u = (uint32_t)v;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)q[i] + (i == 0 ? u : 0u) + carry;
    carry = (uint32_t)(s >> 32);
    out[i] = v < 0 ? (uint32_t)s : (i == 0 ? u : 0u);
  }
}

// a / b for canonical a and b, 0 for b = 0 (backend/interp.py idiv_rows):
// `bits` steps of shift-in, compare and predicated subtract over a 32N-bit
// remainder, the bit shifted out of the top word forcing the subtract (the
// difference mod 2^(32N) is then exact); the quotient shifts in one bit a
// step.  word(i) reads word i of a in place: one bit of it a step.
template <int N, class Word>
__device__ __forceinline__ void idiv32(Word word, const uint32_t (&b)[N],
                                       int bits, uint32_t (&quo)[N]) {
  uint32_t R[N];
#pragma unroll
  for (int j = 0; j < N; ++j) R[j] = quo[j] = 0;
#pragma unroll 1
  for (int i2 = bits - 1; i2 >= 0; --i2) {
    const uint32_t bit = (word(i2 / 32) >> (i2 % 32)) & 1u;
    const uint32_t topbit = R[N - 1] >> 31;
#pragma unroll
    for (int j = N - 1; j > 0; --j) R[j] = (R[j] << 1) | (R[j - 1] >> 31);
    R[0] = (R[0] << 1) | bit;
    uint32_t d[N];
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)R[j] - b[j] - borrow;
      d[j] = (uint32_t)s;
      borrow = (uint32_t)(s >> 63);
    }
    const bool ge = topbit != 0 || borrow == 0;
#pragma unroll
    for (int j = 0; j < N; ++j) R[j] = ge ? d[j] : R[j];
#pragma unroll
    for (int j = N - 1; j > 0; --j)
      quo[j] = (quo[j] << 1) | (quo[j - 1] >> 31);
    quo[0] = (quo[0] << 1) | (ge ? 1u : 0u);
  }
  if (!nonzero32<N>(b)) {
#pragma unroll
    for (int j = 0; j < N; ++j) quo[j] = 0;
  }
}

// The high 64 bits of a 64x64-bit product.
__device__ __forceinline__ uint64_t mulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

constexpr uint64_t GOLDILOCKS_P = 0xFFFFFFFF00000001ull;

// Goldilocks a*b mod p in one 64-bit word: the 128-bit product hi:lo with
// hi = hh 2^32 + hl is lo + hl (2^32 - 1) - hh mod p; each wrap of the
// 64-bit word is folded back (-2^64 = -(2^32 - 1) on a borrow, +2^32 - 1
// on a carry), and one conditional subtract makes it canonical (the sum
// is below 2^64 < 2p).
__device__ __forceinline__ uint64_t gl_mul64(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b, hi = mulhi64(a, b);
  const uint64_t hh = hi >> 32, hl = hi & 0xFFFFFFFFull;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= 0xFFFFFFFFull;
  const uint64_t t1 = hl * 0xFFFFFFFFull;
  uint64_t r = t0 + t1;
  if (r < t1) r += 0xFFFFFFFFull;
  return r >= GOLDILOCKS_P ? r - GOLDILOCKS_P : r;
}

}  // namespace ctpu
