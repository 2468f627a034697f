// The field constants every kernel reads (FieldConsts, MASK, LIMB_BITS),
// and the 16-bit limb arithmetic that the tests' host oracles compute with.
//
// No kernel calls the 16-bit routines below: K1, K4, K5, K6, KC and KS
// compute in 32-bit words (field32.cuh, dot32.cuh, wide32.cuh).  They stay
// because g++ builds them for the host beside the word versions, which the
// tests hold against them bit for bit (tests/test_torch_k1_words.py:
// mac_cols, mont_reduce_cols, mod_add; tests/test_torch_k1_cd_words.py:
// mod_sub, cond_sub, mod_add<4>, and wide.cuh's gl_mul, which ends in
// cond_sub).  The interleaved CIOS product, which no oracle takes any
// more, is gone: field32.cuh's mont_mul32 is held against TorchField.
//
// They port the limb arithmetic of the JAX package's ops/limb_emit.py step
// for step: cond_sub, the non-interleaved Montgomery reduction of a column
// set (mont_reduce_rows, used by the fused dot ops and the trailing REDC),
// and the modular add and subtract.  Each limb is a uint32 holding 16
// bits, so every 16x16-bit product is exact in 32 bits and column sums
// stay far below 2^32; the results are therefore bit-identical to the JAX
// kernels by construction, including the single conditional subtract of
// their lazy dot reduction, which is canonical only where n p is well
// below R (dot32.cuh: one subtract is not enough for dot2/dot3 at
// secq256r1 and goldilocks, nor for dot3 at bls12381; mont_reduce_cols is
// K1's oracle only where once is enough).
//
// L is a template parameter (4: goldilocks, 16: bn128 and the other 256-bit
// primes, 24: room for wider primes), so every loop unrolls and the limb
// arrays live in registers.
#pragma once

#include <cstdint>

namespace ctpu {

constexpr uint32_t MASK = 0xFFFFu;
constexpr int LIMB_BITS = 16;

// Field constants, passed by value as a kernel parameter (constant bank).
struct FieldConsts {
  uint32_t p[24];
  uint32_t r2[24];
  uint32_t n0inv;    // -p^-1 mod 2^16
  uint32_t n0inv32;  // -p^-1 mod 2^32, for field32.cuh
};

// Canonicalize a value given as L limbs plus a top word: subtract p once
// when (top, limbs) >= p.  `top` is signed: the subtract's carry may be -1.
template <int L>
__device__ __forceinline__ void cond_sub(uint32_t (&limbs)[L], int32_t top,
                                         const FieldConsts& fc) {
  uint32_t subbed[L];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    int32_t v = (int32_t)limbs[i] - (int32_t)fc.p[i] - borrow;
    subbed[i] = (uint32_t)(v & (int32_t)MASK);
    borrow = -(v >> LIMB_BITS);  // arithmetic shift: 0 or 1
  }
  const bool take = (top - borrow) >= 0;
#pragma unroll
  for (int i = 0; i < L; ++i) limbs[i] = take ? subbed[i] : limbs[i];
}

// Montgomery reduction of 2L+1 column words (each < ~2^24), the lazy
// reduction of the fused dots and the trailing REDC
// (limb_emit.mont_reduce_rows).  `cols` is consumed.
template <int L>
__device__ __forceinline__ void mont_reduce_cols(uint32_t (&cols)[2 * L + 1],
                                                 uint32_t (&out)[L],
                                                 const FieldConsts& fc) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t t = cols[i] + carry;
    const uint32_t m = (t * fc.n0inv) & MASK;
    const uint32_t prod0 = m * fc.p[0];
    carry = (t + (prod0 & MASK)) >> LIMB_BITS;
    cols[i + 1] += prod0 >> LIMB_BITS;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      const uint32_t pr = m * fc.p[j];
      cols[i + j] += pr & MASK;
      cols[i + j + 1] += pr >> LIMB_BITS;
    }
  }
  uint32_t top = 0;
#pragma unroll
  for (int k = L; k < 2 * L + 1; ++k) {
    const uint32_t t = cols[k] + carry;
    if (k < 2 * L) out[k - L] = t & MASK; else top = t & MASK;
    carry = t >> LIMB_BITS;
  }
  cond_sub<L>(out, (int32_t)top, fc);
}

// Accumulate the schoolbook columns of x*c into cols (split 16-bit halves,
// as limb_emit's dot does).
template <int L>
__device__ __forceinline__ void mac_cols(uint32_t (&cols)[2 * L + 1],
                                         const uint32_t (&x)[L],
                                         const uint32_t (&c)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t prod = x[i] * c[j];
      cols[i + j] += prod & MASK;
      cols[i + j + 1] += prod >> LIMB_BITS;
    }
  }
}

// (a + b) mod p for canonical a, b (limb_emit "add").
template <int L>
__device__ __forceinline__ void mod_add(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        uint32_t (&out)[L],
                                        const FieldConsts& fc) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t t = a[i] + b[i] + carry;
    out[i] = t & MASK;
    carry = t >> LIMB_BITS;
  }
  cond_sub<L>(out, (int32_t)carry, fc);
}

// (a - b) mod p: a + p - b with a signed carry chain (limb_emit "sub").
template <int L>
__device__ __forceinline__ void mod_sub(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        uint32_t (&out)[L],
                                        const FieldConsts& fc) {
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int32_t v = (int32_t)(a[i] + fc.p[i]) - (int32_t)b[i] + carry;
    out[i] = (uint32_t)(v & (int32_t)MASK);
    carry = v >> LIMB_BITS;
  }
  cond_sub<L>(out, carry, fc);
}

}  // namespace ctpu
