// Kernel KC: the R1CS check of a batch, Az * Bz == Cz for every lane and
// row, as the first violated row of each lane.
//
// It replaces the JAX package's jitted check (circom_tpu/backend/
// checker.py:66-116: the gather of z by the matrices' columns, the
// coefficient products in Pallas K5, segment_sum and the wide fold, the
// product Az * Bz and the subtract), which XLA fuses into one program.
// Here nothing but z, the three matrices and the answer touch device
// memory, and z is read in place: a window of lanes of a wider batch comes
// with the batch's stride.
//
// Work: one thread a lane; blockIdx.x a chunk of rows (the fastest index,
// so that the blocks resident at once share a lane block and its slab of z
// stays in L2), blockIdx.y a block of lanes, strided past 65,535.  A thread
// walks its chunk's rows in order, stops at its first violated row and
// lowers first[lane] to it with atomicMin; the wrapper fills `first` with
// n_rows first, so a lane that satisfies every row keeps n_rows.  A row's
// entries are the same for every thread of a warp: uniform loads through
// the read-only path.
//
// The matrices (backend/checker.py builds them).  Row r of a matrix is the
// words [ptr[r], ptr[r + 1]) of its entry stream: its wide entries, then
// its small ones, then its units.  An entry is the word
// col << 3 | cls << 1 | neg, then its coefficient words.  With c the
// coefficient mod p, |c| = min(c, p - c), neg = (p - c < c), and the term
// is -|c| z[col] where neg is set.  A unit (|c| = 1) has no coefficient
// word, a small coefficient (|c| < 2^32) one, a wide one N = L/2 words
// holding |c| 2^(32(N-1)) mod p.
//
// A row sum is accumulated exactly, as a signed integer V: the words acc[]
// and a count hi of the carries (+1) and borrows (-1) out of acc's top
// word, V = acc + hi 2^(32 W).  A unit term adds or subtracts z (N words;
// z < R = 2^(32N), any 16-bit limbs, taken mod p as the plain route takes
// it), a small one z |c| (N products), a wide one the schoolbook product
// z |c|' (N^2 products, no reduction).  A row sum without wide terms sits
// at word 0 of W = N + 1 words; one with wide terms in W = 2N words, its
// small and unit terms from word N - 1.
//
// Each row sum is then reduced once: |V|, its sign kept apart, by J words
// of Montgomery reduction, each X -> (X + m p) / 2^32 with m = -X p^-1 mod
// 2^32 (N products).  So X_J = (|V| + M p) / 2^(32J) with M < 2^(32J):
// X_J < |V| / 2^(32J) + p, and one conditional subtract leaves it
// canonical when |V| < 2^(32J) p (the headroom below, which
// backend/checker.py checks a row at a time when it builds the
// matrices).  J is fixed by the row's shape and the path: a row sum
// without wide terms takes J = KC_J = 2 words, or 2 KC_J for C beside two
// reduced factors (below); one with wide terms K = N - 1 + J (at least
// N + 1).  Both land the sum at the scale 2^(-32 J): the
// wide coefficients' 2^(32(N-1)), and the small and unit terms' offset of
// N - 1 words, cancel the K - J = N - 1 extra words.
//
// Headroom.  z < R, so |V| < (R - 1) S with S = sum |c| without wide terms,
// S = sum |c|' + 2^(32(N-1)) sum |c| with them.  backend/checker.py checks
// (R - 1) S < 2^(32J) p at J = KC_J, the least, for every row sum when it
// builds the matrices and refuses a system that breaks it; the kernel
// tests nothing at run time.  That allows, without wide terms, sum |c| <
// 2^64 p / (R - 1), above 2^60 for every prime here (p > R/16), and with
// them up to ~2^32 wide terms besides: no row of a system whose CSR has
// int32 offsets comes near, so no row is ever split.  |hi| is at most the
// row's term count, below 2^31, so V, and |V| in W + 1 words, are exact.
//
// The row test.  With A' = |Az| 2^-64, B' = |Bz| 2^-64 and C' = |Cz| 2^-128
// canonical, and their signs a, b and c: P = A' B' < p^2 (schoolbook, N^2
// products) and E = P + (a ^ b == c ? p - C' : C') < p^2 + p < R p, which
// is congruent to +-(Az Bz - Cz) 2^-128.  One Montgomery reduction of E
// (mont_reduce32, N^2 products) is canonical and zero exactly when the row
// holds: (E + M p) / R < p + p = 2p, one subtract, at every field (p < R;
// p + 1 <= R, so p^2 + p <= R p, secq256r1 and goldilocks included).
// Where A (else B) is one unit term, its z is taken as it is: A' = z < R
// at scale 1, C' = |Cz| 2^-64 (KC_J words), P < (R - 1)(p - 1) and
// E < R p still.  A row whose A or B is empty holds when C' is zero (Az Bz
// = 0); one whose C is empty, when A' or B' is zero (p is prime: a product
// is zero only where a factor is), with no product.
//
// Bound: 32-bit integer instructions, two a 32x32->64-bit product: N
// products a small term, N^2 a wide one, J N or K N a row sum's reduction
// (none for a factor taken as it is), 2 N^2 a row's product and its
// reduction, none a unit (checker.kc_products counts them).  Each term
// reads L words of z a lane (coalesced: neighbouring threads read
// neighbouring lanes).
//
// Plain C++ apart from the launch and atomicMin, so that g++ builds it for
// the host (tests/test_torch_check_kernel.py,
// tests/test_torch_check_classes.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field.cuh"
#include "field32.cuh"

namespace ctpu {

constexpr int KC_THREADS = 128;
constexpr uint32_t KC_UNIT = 0, KC_SMALL = 1, KC_WIDE = 2;
// words of reduction of a row sum without wide terms; C's take twice as
// many beside two reduced factors (checker.KC_J)
constexpr int KC_J = 2;

// One matrix: row r's entries are the words [ptr[r], ptr[r + 1]) of ent.
struct Csr {
  const int* ptr;
  const uint32_t* ent;
};

struct KcArgs {
  const uint32_t* z;  // limb i of wire w of lane l at z[(w L + i) bs + l]
  long long b;        // lanes checked
  long long bs;       // the batch stride (>= b): z is a window of bs lanes
  Csr m[3];           // A, B, C
  long long n_rows;
  long long rows_per_chunk;
  int* first;         // (b,), n_rows on entry
};

template <int N>
struct KcConsts {
  uint32_t p[N];      // p in 32-bit words
  uint32_t n0inv32;   // -p^-1 mod 2^32
};

// acc[OFF ..] += t or -= t, the carry (borrow) out of acc's top word added
// to (taken from) hi.
template <int W, int OFF, int T>
__device__ __forceinline__ void acc_term(uint32_t (&acc)[W], int& hi,
                                         const uint32_t (&t)[T], bool neg) {
  static_assert(OFF + T <= W, "a term must fit the accumulator");
  if (neg) {
    uint32_t br = 0;
#pragma unroll
    for (int i = OFF; i < W; ++i) {
      const uint64_t d =
          (uint64_t)acc[i] - (i < OFF + T ? t[i - OFF] : 0u) - br;
      acc[i] = (uint32_t)d;
      br = (uint32_t)(d >> 63);  // 1 when the difference went negative
    }
    hi -= (int)br;
  } else {
    uint64_t c = 0;
#pragma unroll
    for (int i = OFF; i < W; ++i) {
      const uint64_t s = (uint64_t)acc[i] + (i < OFF + T ? t[i - OFF] : 0u)
                         + c;
      acc[i] = (uint32_t)s;
      c = s >> 32;
    }
    hi += (int)c;
  }
}

// out = x k, N + 1 words.
template <int N>
__device__ __forceinline__ void mul_small(const uint32_t (&x)[N], uint32_t k,
                                          uint32_t (&out)[N + 1]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)x[i] * k + c;
    out[i] = (uint32_t)s;
    c = s >> 32;
  }
  out[N] = (uint32_t)c;
}

// out = x y, 2N words: the schoolbook product, each row's last carry a
// fresh word.
template <int N>
__device__ __forceinline__ void mul_wide(const uint32_t (&x)[N],
                                         const uint32_t (&y)[N],
                                         uint32_t (&out)[2 * N]) {
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) out[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: never overflows
      const uint64_t s = (uint64_t)x[i] * y[j] + out[i + j] + c;
      out[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    out[i + N] = (uint32_t)c;
  }
}

// One word of Montgomery reduction: t -> (t + m p) / 2^32 with m = -t p^-1
// mod 2^32 (N products).  t + m p < 2^(32T) + 2^(32(N+1)) <= 2^(32T + 1),
// so the quotient's top word, t[T - 1], is the last carry (0 or 1).
template <int N, int T>
__device__ __forceinline__ void redc_word(uint32_t (&t)[T],
                                          const uint32_t (&p)[N],
                                          uint32_t n0inv32) {
  static_assert(T >= N + 1, "the reduced value needs N + 1 words");
  const uint32_t m = t[0] * n0inv32;
  uint64_t c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const uint64_t s = (uint64_t)m * p[j] + t[j] + c;
    t[j - 1] = (uint32_t)s;
    c = s >> 32;
  }
#pragma unroll
  for (int j = N; j < T; ++j) {
    const uint64_t s = (uint64_t)t[j] + c;
    t[j - 1] = (uint32_t)s;
    c = s >> 32;
  }
  t[T - 1] = (uint32_t)c;
}

// For V = acc + hi 2^(32W) with |V| < 2^(32J) p: out = |V| 2^(-32J) mod p,
// canonical; returns whether V < 0.
template <int N, int W, int J>
__device__ __forceinline__ bool reduce_sum(const uint32_t (&acc)[W], int hi,
                                           const uint32_t (&p)[N],
                                           uint32_t n0inv32,
                                           uint32_t (&out)[N]) {
  const bool neg = hi < 0;
  const uint32_t flip = neg ? 0xFFFFFFFFu : 0u;  // |V| = ~V + 1 if V < 0
  uint32_t t[W + 1];
  uint32_t c = neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i <= W; ++i) {
    const uint64_t s =
        (uint64_t)((i < W ? acc[i] : (uint32_t)hi) ^ flip) + c;
    t[i] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int s = 0; s < J; ++s) redc_word<N, W + 1>(t, p, n0inv32);
  uint32_t x[N + 1];  // below 2p: the words above N are 0
#pragma unroll
  for (int i = 0; i <= N; ++i) x[i] = t[i];
  cond_sub32<N>(x, p, out);
  return neg;
}

// The terms of entries [k, k1) into acc, from word OFF; wide entries only
// where WIDE (they come first in a row).
template <int L, int W, int OFF, bool WIDE>
__device__ __forceinline__ void walk(const uint32_t* __restrict__ ent, int k,
                                     int k1, const uint32_t* __restrict__ zl,
                                     long long bs, uint32_t (&acc)[W],
                                     int& hi) {
  constexpr int N = L / 2;
  while (k < k1) {
    const uint32_t e = __ldg(ent + k);
    const bool neg = e & 1u;
    const uint32_t cls = (e >> 1) & 3u;
    uint32_t x[N];
    pack32<L>(zl + (long long)(e >> 3) * L * bs, bs, x);
    if constexpr (WIDE) {
      if (cls == KC_WIDE) {
        uint32_t c[N], t[2 * N];
#pragma unroll
        for (int i = 0; i < N; ++i) c[i] = __ldg(ent + k + 1 + i);
        mul_wide<N>(x, c, t);
        acc_term<W, 0, 2 * N>(acc, hi, t, neg);
        k += 1 + N;
        continue;
      }
    }
    if (cls == KC_SMALL) {
      uint32_t t[N + 1];
      mul_small<N>(x, __ldg(ent + k + 1), t);
      acc_term<W, OFF, N + 1>(acc, hi, t, neg);
      k += 2;
    } else {
      acc_term<W, OFF, N>(acc, hi, x, neg);
      k += 1;
    }
  }
}

// The sum of the non-empty entry range [k, k1), reduced: out = |V|
// 2^(-32 J) mod p, canonical; returns whether V < 0.
template <int L, int J>
__device__ __forceinline__ bool row_sum(const uint32_t* __restrict__ ent,
                                        int k, int k1,
                                        const uint32_t* __restrict__ zl,
                                        long long bs,
                                        const uint32_t (&p)[L / 2],
                                        uint32_t n0inv32,
                                        uint32_t (&out)[L / 2]) {
  constexpr int N = L / 2;
  if (((__ldg(ent + k) >> 1) & 3u) == KC_WIDE) {
    uint32_t acc[2 * N] = {};
    int hi = 0;
    walk<L, 2 * N, N - 1, true>(ent, k, k1, zl, bs, acc, hi);
    return reduce_sum<N, 2 * N, N - 1 + J>(acc, hi, p, n0inv32, out);
  }
  uint32_t acc[N + 1] = {};
  int hi = 0;
  walk<L, N + 1, 0, false>(ent, k, k1, zl, bs, acc, hi);
  return reduce_sum<N, N + 1, J>(acc, hi, p, n0inv32, out);
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t (&x)[N]) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) any |= x[i];
  return any == 0;
}

// A factor of the product: z of the entry at k0 itself where `raw` (a row
// sum of one unit term: one entry word; z < R at scale 1), else the row
// sum of [k0, k1) reduced by KC_J words (canonical, at 2^-64).  Returns
// its sign.
template <int L>
__device__ __forceinline__ bool factor(const uint32_t* __restrict__ ent,
                                       int k0, int k1, bool raw,
                                       const uint32_t* __restrict__ zl,
                                       long long bs,
                                       const uint32_t (&p)[L / 2],
                                       uint32_t n0inv32,
                                       uint32_t (&out)[L / 2]) {
  if (raw) {
    const uint32_t e = __ldg(ent + k0);
    pack32<L>(zl + (long long)(e >> 3) * L * bs, bs, out);
    return e & 1u;
  }
  return row_sum<L, KC_J>(ent, k0, k1, zl, bs, p, n0inv32, out);
}

// Whether row r of the matrices m (its entries from m[i].ptr[r]) holds for
// the lane at zl.
template <int L>
__device__ __forceinline__ bool row_holds(const Csr (&m)[3], long long r,
                                          const uint32_t* __restrict__ zl,
                                          long long bs,
                                          const uint32_t (&p)[L / 2],
                                          uint32_t n0inv32) {
  constexpr int N = L / 2;
  const int a0 = __ldg(m[0].ptr + r), a1 = __ldg(m[0].ptr + r + 1);
  const int b0 = __ldg(m[1].ptr + r), b1 = __ldg(m[1].ptr + r + 1);
  const int c0 = __ldg(m[2].ptr + r), c1 = __ldg(m[2].ptr + r + 1);
  uint32_t az[N], bz[N], cz[N];
  if (a0 == a1 || b0 == b1) {  // Az Bz = 0: the row holds where C' is 0
    if (c0 == c1) return true;
    row_sum<L, KC_J>(m[2].ent, c0, c1, zl, bs, p, n0inv32, cz);
    return is_zero<N>(cz);
  }
  if (c0 == c1) {  // Cz = 0: the row holds where A' or B' is 0, p prime
    row_sum<L, KC_J>(m[0].ent, a0, a1, zl, bs, p, n0inv32, az);
    row_sum<L, KC_J>(m[1].ent, b0, b1, zl, bs, p, n0inv32, bz);
    return is_zero<N>(az) || is_zero<N>(bz);
  }
  // a factor of one unit term is taken as it is (A's first): its side
  // stays at scale 1, and C then takes KC_J words, not 2 KC_J.  C first:
  // nothing else is live while its terms accumulate
  const bool a_raw = a1 == a0 + 1, b_raw = !a_raw && b1 == b0 + 1;
  const bool nc =
      a_raw || b_raw
          ? row_sum<L, KC_J>(m[2].ent, c0, c1, zl, bs, p, n0inv32, cz)
          : row_sum<L, 2 * KC_J>(m[2].ent, c0, c1, zl, bs, p, n0inv32, cz);
  const bool na = factor<L>(m[0].ent, a0, a1, a_raw, zl, bs, p, n0inv32, az);
  const bool nb = factor<L>(m[1].ent, b0, b1, b_raw, zl, bs, p, n0inv32, bz);
  uint32_t ab[2 * N], e[2 * N + 1];
  mul_wide<N>(az, bz, ab);
  // E = P + (p - C') where the two sides' signs agree, else P + C'
  const bool agree = (na != nb) == nc;
  uint32_t br = 0;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i <= 2 * N; ++i) {
    uint32_t d = 0;
    if (i < N) {
      const uint64_t t = (uint64_t)p[i] - cz[i] - br;
      br = (uint32_t)(t >> 63);
      d = agree ? (uint32_t)t : cz[i];
    }
    const uint64_t s = (uint64_t)(i < 2 * N ? ab[i] : 0u) + d + c;
    e[i] = (uint32_t)s;
    c = s >> 32;
  }
  uint32_t x[N];
  mont_reduce32<N>(e, p, n0inv32, x);
  return is_zero<N>(x);
}

template <int L>
__global__ void __launch_bounds__(KC_THREADS)
    r1cs_check_kernel(KcArgs a, KcConsts<L / 2> fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = fc.p[i];
  const long long r0 = (long long)blockIdx.x * a.rows_per_chunk;
  const long long r1 = r0 + a.rows_per_chunk < a.n_rows
                           ? r0 + a.rows_per_chunk
                           : a.n_rows;
  for (long long lb = blockIdx.y; lb * KC_THREADS < a.b; lb += gridDim.y) {
    const long long lane = lb * KC_THREADS + threadIdx.x;
    if (lane >= a.b) continue;
    const uint32_t* zl = a.z + lane;
    for (long long r = r0; r < r1; ++r) {
      if (!row_holds<L>(a.m, r, zl, a.bs, p, fc.n0inv32)) {
        atomicMin(a.first + lane, (int)r);
        break;
      }
    }
  }
}

template <int L>
void launch(const KcArgs& a, const uint32_t* p_limbs, uint32_t n0inv32,
            cudaStream_t s) {
  KcConsts<L / 2> fc = {};
  for (int i = 0; i < L / 2; ++i)
    fc.p[i] = p_limbs[2 * i] | (p_limbs[2 * i + 1] << 16);
  fc.n0inv32 = n0inv32;
  const long long chunks = (a.n_rows + a.rows_per_chunk - 1) / a.rows_per_chunk;
  long long lane_blocks = (a.b + KC_THREADS - 1) / KC_THREADS;
  if (lane_blocks > 65535) lane_blocks = 65535;  // the kernel strides beyond
  const dim3 grid((unsigned)chunks, (unsigned)lane_blocks);
  r1cs_check_kernel<L><<<grid, KC_THREADS, 0, s>>>(a, fc);
}

}  // namespace ctpu

// z: uint32 (n_wires, L, bs), canonical 16-bit limbs, of which lanes
// [0, b) are checked (z may point into a wider batch: bs is its lane
// stride).  For each of A, B, C: ptr int32 (n_rows + 1), ent uint32, the
// entry stream above.  first: int32 (b,), every entry n_rows on entry; on
// exit the least violated row of each lane, or n_rows.  p_limbs: L 16-bit
// limbs; n0inv32 = -p^-1 mod 2^32.  L is 4, 16 or 24 (else
// cudaErrorInvalidValue); n_rows, b, rows_per_chunk > 0, bs >= b.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int ctpu_r1cs_check(int L, const uint32_t* z, long long b,
                               long long bs, const int* a_ptr,
                               const uint32_t* a_ent, const int* b_ptr,
                               const uint32_t* b_ent, const int* c_ptr,
                               const uint32_t* c_ent, long long n_rows,
                               long long rows_per_chunk,
                               const uint32_t* p_limbs, uint32_t n0inv32,
                               int* first, void* stream) {
  if (n_rows <= 0 || b <= 0 || rows_per_chunk <= 0 || bs < b)
    return (int)cudaErrorInvalidValue;
  const ctpu::KcArgs a = {z,
                          b,
                          bs,
                          {{a_ptr, a_ent}, {b_ptr, b_ent}, {c_ptr, c_ent}},
                          n_rows,
                          rows_per_chunk,
                          first};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4: ctpu::launch<4>(a, p_limbs, n0inv32, s); break;
    case 16: ctpu::launch<16>(a, p_limbs, n0inv32, s); break;
    case 24: ctpu::launch<24>(a, p_limbs, n0inv32, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

