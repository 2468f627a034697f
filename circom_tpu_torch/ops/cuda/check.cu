// Kernel KC: the R1CS check of one batch slice, Az * Bz == Cz for every
// lane and row, as the first violated row of each lane.
//
// It replaces the JAX package's jitted check (circom_tpu/backend/
// checker.py:66-116: the gather of z by the matrices' columns, the
// coefficient products in Pallas K5, segment_sum and the wide fold, the
// product Az * Bz and the subtract), which XLA fuses into one program; the
// port ran the same steps eagerly, with (nnz, L, B) temporaries between
// them.  Here nothing but z, the three CSR matrices and the answer touch
// device memory.
//
// Work: one thread a lane; blockIdx.x a chunk of rows (the fastest index,
// so that the blocks resident at once share a lane block and its slab of z
// stays in L2), blockIdx.y a block of lanes.  A thread walks its chunk's
// rows in order; for each row it sums the products z[col] * coef of A, B
// and C mod p, one 32-bit-word CIOS (field32.cuh) and one modular add
// (dot32.cuh) a nonzero, multiplies the sums of A and B, and compares with
// C's.  It stops at its first violated row and lowers first[lane] to it
// with atomicMin; the wrapper fills `first` with n_rows first, so a lane
// that satisfies every row keeps n_rows.  The rows' CSR entries are the
// same for every thread of a warp: uniform loads through the read-only
// path.  Splitting the rows lets a slice a few warps wide (SHA256's 260
// lanes) still fill the card.
//
// Coefficients are stored as coef * R^2 mod p in N = L/2 words, so that
// mont_mul(z, coef R^2) = z coef R: the product of the Montgomery forms of
// z and coef, as the plain route's mont_mul(to_mont(z), coef R), with the
// conversion of z folded in.  Every product and sum is canonical (< p): a
// CIOS of x < R and y < p is below 2p before its conditional subtract, and
// a modular add of two values below p subtracts p once.  So Az R, Bz R and
// Cz R are the plain route's row values bit for bit, Az Bz R =
// mont_mul(Az R, Bz R) too, and its difference with Cz R is zero exactly
// when the two are equal: the zero test of the residual is this equality.
//
// Bound: 32-bit integer instructions.  Each nonzero and each row costs a
// CIOS of 2 N^2 wide products, and each nonzero reads L words of z a lane
// (coalesced: neighbouring threads read neighbouring lanes).
//
// Plain C++ apart from the launch and atomicMin, so that g++ builds it for
// the host (tests/test_torch_check_kernel.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field.cuh"
#include "field32.cuh"

namespace ctpu {

constexpr int KC_THREADS = 128;

// One CSR matrix: row r's nonzeros are k in [ptr[r], ptr[r + 1]), each a
// column col[k] and a coefficient coef[k N .. k N + N) in 32-bit words.
struct Csr {
  const int* ptr;
  const int* col;
  const uint32_t* coef;
};

struct KcArgs {
  const uint32_t* z;  // (n_wires, L, b) 16-bit limbs, lanes contiguous
  long long b;
  Csr m[3];           // A, B, C
  long long n_rows;
  long long rows_per_chunk;
  int* first;         // (b,), n_rows on entry
};

// acc = sum over row r of m of z[col] * coef * R^-1 mod p, for the lane
// whose limbs start at zl (limb i of wire w at zl[(w L + i) b]).
template <int L>
__device__ __forceinline__ void row_sum(const Csr& m, long long r,
                                        const uint32_t* __restrict__ zl,
                                        long long b,
                                        const uint32_t (&p)[L / 2],
                                        uint32_t n0inv32,
                                        uint32_t (&acc)[L / 2]) {
  constexpr int N = L / 2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
  const int k1 = __ldg(m.ptr + r + 1);
  for (int k = __ldg(m.ptr + r); k < k1; ++k) {
    const long long w = __ldg(m.col + k);
    uint32_t x[N], y[N], prod[N];
    pack32<L>(zl + w * L * b, b, x);
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = __ldg(m.coef + (long long)k * N + i);
    mont_mul32<N>(x, y, p, n0inv32, prod);
    mod_add32<N>(acc, prod, p, acc);
  }
}

template <int L>
__global__ void __launch_bounds__(KC_THREADS)
    r1cs_check_kernel(KcArgs a, FieldConsts fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
  p_words<L>(fc, p);
  const long long r0 = (long long)blockIdx.x * a.rows_per_chunk;
  const long long r1 = r0 + a.rows_per_chunk < a.n_rows
                           ? r0 + a.rows_per_chunk
                           : a.n_rows;
  for (long long lb = blockIdx.y; lb * KC_THREADS < a.b; lb += gridDim.y) {
    const long long lane = lb * KC_THREADS + threadIdx.x;
    if (lane >= a.b) continue;
    const uint32_t* zl = a.z + lane;
    for (long long r = r0; r < r1; ++r) {
      uint32_t az[N], bz[N], cz[N], ab[N];
      row_sum<L>(a.m[0], r, zl, a.b, p, fc.n0inv32, az);
      row_sum<L>(a.m[1], r, zl, a.b, p, fc.n0inv32, bz);
      mont_mul32<N>(az, bz, p, fc.n0inv32, ab);
      row_sum<L>(a.m[2], r, zl, a.b, p, fc.n0inv32, cz);
      bool same = true;
#pragma unroll
      for (int i = 0; i < N; ++i) same = same && ab[i] == cz[i];
      if (!same) {
        atomicMin(a.first + lane, (int)r);
        break;
      }
    }
  }
}

template <int L>
void launch(const KcArgs& a, const FieldConsts& fc, cudaStream_t s) {
  const long long chunks = (a.n_rows + a.rows_per_chunk - 1) / a.rows_per_chunk;
  long long lane_blocks = (a.b + KC_THREADS - 1) / KC_THREADS;
  if (lane_blocks > 65535) lane_blocks = 65535;  // the kernel strides beyond
  const dim3 grid((unsigned)chunks, (unsigned)lane_blocks);
  r1cs_check_kernel<L><<<grid, KC_THREADS, 0, s>>>(a, fc);
}

}  // namespace ctpu

// z: uint32 (n_wires, L, b), contiguous, canonical 16-bit limbs.  For each
// of A, B, C: ptr int32 (n_rows + 1), col int32 (nnz), coef uint32 (nnz,
// L/2), coef * R^2 mod p in 32-bit words.  first: int32 (b,), every entry
// n_rows on entry; on exit the least violated row of each lane, or n_rows.
// p_limbs: L 16-bit limbs; n0inv32 = -p^-1 mod 2^32.  L is 4, 16 or 24
// (else cudaErrorInvalidValue); n_rows, b, rows_per_chunk > 0.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int ctpu_r1cs_check(int L, const uint32_t* z, long long b,
                               const int* a_ptr, const int* a_col,
                               const uint32_t* a_coef, const int* b_ptr,
                               const int* b_col, const uint32_t* b_coef,
                               const int* c_ptr, const int* c_col,
                               const uint32_t* c_coef, long long n_rows,
                               long long rows_per_chunk,
                               const uint32_t* p_limbs, uint32_t n0inv32,
                               int* first, void* stream) {
  if (n_rows <= 0 || b <= 0 || rows_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L && i < 24; ++i) fc.p[i] = p_limbs[i];
  fc.n0inv32 = n0inv32;
  const ctpu::KcArgs a = {z,
                          b,
                          {{a_ptr, a_col, a_coef},
                           {b_ptr, b_col, b_coef},
                           {c_ptr, c_col, c_coef}},
                          n_rows,
                          rows_per_chunk,
                          first};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4: ctpu::launch<4>(a, fc, s); break;
    case 16: ctpu::launch<16>(a, fc, s); break;
    case 24: ctpu::launch<24>(a, fc, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
