// The Montgomery product in 32-bit words, for kernel K5 (field_ops.cu).
//
// The package's planes hold one 16-bit limb a uint32 word.  The card has a
// 32x32->64-bit multiply-add (IMAD.WIDE.U32), so K5 packs pairs of limbs
// into L/2 words on load, runs CIOS in base 2^32 and unpacks on store: 2
// (L/2)^2 wide products an element where the 16-bit steps of field.cuh take
// 2 L^2 narrow ones, each with a mask, a shift and two adds.
//
// The bits equal TorchField.mont_mul's (the 16-bit CIOS of the JAX
// kernels, limb_emit.emit_mul) for every input of 16-bit limbs: R = 2^(16
// L) = 2^(32 L/2) is the same, CIOS in either base yields (V + M p) / R
// with the unique M < R that clears the low half of V + M p, and both end
// with one conditional subtract of p, which depends on that value alone.
//
// Plain C++ on 64-bit integers, no inline PTX: g++ compiles this header for
// the host (tests/test_torch_field32.py, with the CUDA qualifiers defined
// away), so its arithmetic is checked before it reaches the card.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace ctpu {

// x[i] = limbs[2i] | limbs[2i+1] << 16, the limbs `stride` words apart.
template <int L>
__device__ __forceinline__ void pack32(const uint32_t* limbs, long long stride,
                                       uint32_t (&x)[L / 2]) {
  static_assert(L % 2 == 0, "32-bit words need an even number of limbs");
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    x[i] = limbs[2 * i * stride] | (limbs[(2 * i + 1) * stride] << 16);
  }
}

// The inverse of pack32: two 16-bit limbs a word, `stride` words apart.
template <int L>
__device__ __forceinline__ void unpack32(const uint32_t (&x)[L / 2],
                                         uint32_t* limbs, long long stride) {
  static_assert(L % 2 == 0, "32-bit words need an even number of limbs");
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    limbs[2 * i * stride] = x[i] & MASK;
    limbs[(2 * i + 1) * stride] = x[i] >> LIMB_BITS;
  }
}

// p as N = L/2 words, from the 16-bit limbs of FieldConsts.
template <int L>
__device__ __forceinline__ void p_words(const FieldConsts& fc,
                                        uint32_t (&p)[L / 2]) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) p[i] = fc.p[2 * i] | (fc.p[2 * i + 1] << 16);
}

// (top, t) - p when that is >= 0, else t: one conditional subtract.
template <int N>
__device__ __forceinline__ void cond_sub32(const uint32_t (&t)[N + 1],
                                           const uint32_t (&p)[N],
                                           uint32_t (&out)[N]) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);  // 1 when the difference went negative
  }
  const bool take = t[N] >= borrow;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = take ? d[i] : t[i];
}

// Interleaved Montgomery CIOS in base 2^32: out = x*y*R^-1 mod p over N
// words; n0inv32 = -p^-1 mod 2^32.  With x, y < R the running sum stays
// below R + p after each shift, so N + 1 words (and one more before it)
// hold it, and every 64-bit step a*b + t + c is below 2^64.
template <int N>
__device__ __forceinline__ void mont_mul32(const uint32_t (&x)[N],
                                           const uint32_t (&y)[N],
                                           const uint32_t (&p)[N],
                                           uint32_t n0inv32,
                                           uint32_t (&out)[N]) {
  uint32_t t[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // t += x[i] * y
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)x[i] * y[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s1 = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s1;
    const uint32_t t_over = (uint32_t)(s1 >> 32);  // word N + 1
    // t += m * p clears word 0; shift down one word
    const uint32_t m = t[0] * n0inv32;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      const uint64_t s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s2 = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s2;
    t[N] = t_over + (uint32_t)(s2 >> 32);
  }
  cond_sub32<N>(t, p, out);
}

}  // namespace ctpu
