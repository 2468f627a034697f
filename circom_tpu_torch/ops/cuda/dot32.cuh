// The interpreter kernel K1's wide arithmetic in 32-bit words: the lazy
// dot of dot2_c / dot3_c, the Montgomery reduction it ends with (also the
// trailing REDC of the flagged emission rows), the modular add of add and
// add_c and the modular subtract of sub, sub_c and csub_c.  The product of
// mul, mul_r2, mul_c and mul_one is field32.cuh's CIOS; K1's other wide
// opcodes are in wide32.cuh.
//
// K1's planes hold one 16-bit limb a uint32 word; K1 packs pairs of limbs
// into N = L/2 words (pack32) and computes on 32x32->64-bit products.  A
// dot of n terms takes n N^2 products and one reduction N^2 more, where the
// 16-bit steps of field.cuh (mac_cols, mont_reduce_cols) take (n + 1) L^2
// narrow products, each with a mask, a shift and two adds.
//
// How many subtracts a dot needs, at every field.  A dot of n <= 3 terms
// computes V = sum x_i c_i + k and reduces it once: (V + M p) / R with the
// unique M < R that clears the low half of V + M p (R = 2^(32N)).  For
// canonical x_i, c_i, k (every register and bank row of a plan holds one)
// V <= n (p - 1)^2 + p - 1, so the reduced value is at most
// (V + (R - 1) p) / R, and S_n = floor((n (p - 1)^2 + p - 1 + (R - 1) p) /
// (R p)) subtracts of p, each taken when the value is >= p, leave it
// canonical (dot_subtractions computes S_n from p).  S_n < n p / R + 1 <=
// n, so a dot never needs more subtracts than it has terms.  S_n is 1
// wherever n p < R roughly: bn128, grumpkin, pallas, vesta and bls12377
// (p / R <= 0.25); at bls12381's scalar field (p / R = 0.45) S_2 = 1 and
// S_3 = 2; at secq256r1 and goldilocks (p / R just under 1) S_2 = 2 and
// S_3 = 3.  One subtract there drops the top word of a value up to ~4p and
// gives a wrong residue (Poseidon2 at secq256r1: 188 of its 190 dot rows
// can reach 2p).  mont_reduce32 subtracts once, as the trailing REDC and
// KC's row test need (their V < R p, so their value is below 2p at every
// field); mont_reduce_dot32 keeps the top word and subtracts up to S_n
// times.
//
// The bits equal TorchField's product_cols64 + mont_reduce_dot64 (the
// plain executor's dot) for every input of 16-bit limbs, canonical or not:
// - V is the same integer in either base: the 16-bit columns are exact in
//   int64, and here each term's product is carried into a 2N + 1 word
//   accumulator.
// - Both reductions yield (V + M p) / R, whatever the base that computes
//   M digit by digit.  With x_i, c_i, k < R and at most three terms, V <
//   4 R^2, so that value is below 4R + p < 5R: neither version's top word
//   truncates it.
// - Both then subtract p, keeping the top word, as often as the count
//   says, each time when the value (top word included) is >= p, decisions
//   on that value alone, and keep its low L limbs.
// Where S_n = 1 the dot is field.cuh's mac_cols + mont_reduce_cols too.
// The modular add is the same argument with V = a + b < 2R and no
// reduction (below 2p for canonical a, b), the modular subtract with V = a
// + p - b, whose top word may be -1: neither version subtracts p then, and
// both keep V mod R (in [0, 2p) for canonical a, b).
//
// Plain C++ on 64-bit integers, no inline PTX: g++ compiles this header for
// the host (tests/test_torch_k1_words.py, with the CUDA qualifiers defined
// away), so its arithmetic is checked against the exact integers and
// TorchField before it reaches the card.
#pragma once

#include <cstdint>

#include "field32.cuh"

namespace ctpu {

// acc += x * c, acc 2N + 1 words: the term's schoolbook product (2N words,
// each row's last carry a fresh word), then added with one carry chain.
template <int N>
__device__ __forceinline__ void mac32(uint32_t (&acc)[2 * N + 1],
                                      const uint32_t (&x)[N],
                                      const uint32_t (&c)[N]) {
  uint32_t prod[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) prod[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: never overflows
      const uint64_t s = (uint64_t)x[i] * c[j] + prod[i + j] + carry;
      prod[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    prod[i + N] = (uint32_t)carry;
  }
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) {
    const uint64_t s = (uint64_t)acc[k] + prod[k] + carry;
    acc[k] = (uint32_t)s;
    carry = s >> 32;
  }
  acc[2 * N] += (uint32_t)carry;
}

// acc += k, k N words (the dot's additive constant row).
template <int N>
__device__ __forceinline__ void add_low32(uint32_t (&acc)[2 * N + 1],
                                          const uint32_t (&k)[N]) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i <= 2 * N; ++i) {
    const uint64_t s = (uint64_t)acc[i] + (i < N ? k[i] : 0u) + carry;
    acc[i] = (uint32_t)s;
    carry = s >> 32;
  }
}

// Montgomery reduction of 2N + 1 words in base 2^32, before any subtract:
// hi (N + 1 words, the top one last) = (t + M p) / R.  n0inv32 = -p^-1 mod
// 2^32.  Each row clears word i and adds its last carry at word i + N; the
// carry out of that word is held in `pend` and added by the next row at the
// word above, so no carry chain runs to the top.  `t` is consumed.
template <int N>
__device__ __forceinline__ void redc32(uint32_t (&t)[2 * N + 1],
                                       const uint32_t (&p)[N],
                                       uint32_t n0inv32,
                                       uint32_t (&hi)[N + 1]) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t m = t[i] * n0inv32;
    uint64_t c = ((uint64_t)m * p[0] + t[i]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      const uint64_t s = (uint64_t)m * p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s = (uint64_t)t[i + N] + c + pend;
    t[i + N] = (uint32_t)s;
    pend = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) hi[k] = t[N + k];
  hi[N] = t[2 * N] + pend;
}

// out = the low N words of (t + M p) / R, less p once when that is >= p
// (field.cuh's mont_reduce_cols): canonical when t < R p.
template <int N>
__device__ __forceinline__ void mont_reduce32(uint32_t (&t)[2 * N + 1],
                                              const uint32_t (&p)[N],
                                              uint32_t n0inv32,
                                              uint32_t (&out)[N]) {
  uint32_t hi[N + 1];
  redc32<N>(t, p, n0inv32, hi);
  cond_sub32<N>(hi, p, out);
}

// (top, t) - p when that is >= 0, in place, the top word kept.
template <int N>
__device__ __forceinline__ void cond_sub_keep32(uint32_t (&t)[N + 1],
                                                const uint32_t (&p)[N]) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = t[N] >= borrow;
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = take ? d[i] : t[i];
  t[N] = take ? t[N] - borrow : t[N];
}

// A lazy dot's reduction: (t + M p) / R, then `subs` conditional
// subtracts of p (1 <= subs <= MAXS, the dot's S_n), the last of which
// drops the top word.  Canonical when t <= n (p - 1)^2 + p - 1 for the
// dot's n terms and subs = S_n.
template <int N, int MAXS>
__device__ __forceinline__ void mont_reduce_dot32(uint32_t (&t)[2 * N + 1],
                                                  const uint32_t (&p)[N],
                                                  uint32_t n0inv32, int subs,
                                                  uint32_t (&out)[N]) {
  uint32_t hi[N + 1];
  redc32<N>(t, p, n0inv32, hi);
#pragma unroll
  for (int s = 1; s < MAXS; ++s)
    if (s < subs) cond_sub_keep32<N>(hi, p);
  cond_sub32<N>(hi, p, out);
}

// S_n of the header, on the host: floor(Q / (R p)) for p of N words and
// n = n_terms, where Q = n (p - 1)^2 + p - 1 + (R - 1) p = n (p - 1)^2 +
// R p - 1 takes 2N + 2 words; floor(Q / (R p)) = floor(floor(Q / R) / p),
// counted by subtracting p from Q's high N + 2 words.
template <int N>
inline int dot_subtractions(const uint32_t (&p)[N], int n_terms) {
  constexpr int W = 2 * N + 2;
  uint32_t pm1[N], q[W] = {};
  uint32_t borrow = 1;
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)p[i] - borrow;
    pm1[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // q += a * m << (32 off), m < 2^32
  auto mac = [&q](const uint32_t (&a)[N], uint32_t m, int off) {
    uint64_t carry = 0;
    for (int i = off; i < W; ++i) {
      const uint64_t s =
          (i - off < N ? (uint64_t)a[i - off] * m : 0u) + q[i] + carry;
      q[i] = (uint32_t)s;
      carry = s >> 32;
    }
  };
  for (int t = 0; t < n_terms; ++t)
    for (int i = 0; i < N; ++i) mac(pm1, pm1[i], i);  // n (p - 1)^2
  mac(p, 1u, N);                                      // + R p
  borrow = 1;                                         // - 1
  for (int i = 0; i < W; ++i) {
    const uint64_t s = (uint64_t)q[i] - borrow;
    q[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  int subs = 0;
  for (;;) {
    uint32_t d[N + 2];
    uint32_t b = 0;
    for (int i = 0; i < N + 2; ++i) {
      const uint64_t s = (uint64_t)q[N + i] - (i < N ? p[i] : 0u) - b;
      d[i] = (uint32_t)s;
      b = (uint32_t)(s >> 63);
    }
    if (b) return subs;
    for (int i = 0; i < N + 2; ++i) q[N + i] = d[i];
    ++subs;
  }
}

// (a + b) mod p for a, b < R, one conditional subtract (field.cuh's
// mod_add).
template <int N>
__device__ __forceinline__ void mod_add32(const uint32_t (&a)[N],
                                          const uint32_t (&b)[N],
                                          const uint32_t (&p)[N],
                                          uint32_t (&out)[N]) {
  uint32_t t[N + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)a[i] + b[i] + carry;
    t[i] = (uint32_t)s;
    carry = s >> 32;
  }
  t[N] = (uint32_t)carry;
  cond_sub32<N>(t, p, out);
}

// (a - b) mod p as field.cuh's mod_sub: V = a + p - b with a signed top
// word in {-1, 0, 1}, less p once when V >= p (else V mod 2^(32N)).
template <int N>
__device__ __forceinline__ void mod_sub32(const uint32_t (&a)[N],
                                          const uint32_t (&b)[N],
                                          const uint32_t (&p)[N],
                                          uint32_t (&out)[N]) {
  uint32_t t[N], d[N];
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int64_t s = (int64_t)a[i] + p[i] - b[i] + carry;
    t[i] = (uint32_t)s;
    carry = s >> 32;  // arithmetic: -1, 0 or 1
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = carry - (int64_t)borrow >= 0;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = take ? d[i] : t[i];
}

}  // namespace ctpu
