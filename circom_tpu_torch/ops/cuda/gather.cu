// K2: the wide witness gather, out[w] = bank[idx[w]] over (rows, L, B),
// and K3: the narrow witness gather with bit unpack over (rows, B) int32.
//
// Replaces the Pallas kernel of the JAX package's backend/interp.py
// (_unblock_gather_w), which gathered the witness rows out of the emission
// bank and undid the TPU's (8, bb) batch blocking in the same pass.  The
// port's bank is already batch-minor (rows, L, B), so what is left is a
// row gather: each output row is one contiguous run of L*B words copied
// from the bank row idx[w].
//
// Bound on the card: device-memory bandwidth (each witness word is read once
// and written once, no arithmetic).  Threads copy 16 bytes each when a row
// is a multiple of four words and both bases are 16-byte aligned, else 4,
// neighbouring threads on neighbouring words.  That already runs at the
// card's copy rate: on an H100 80GB HBM3 at 700 W it moves Poseidon2's 323
// rows of 4 MB in 0.891 ms, where a contiguous copy of the same bytes takes
// 0.898 ms and a version with Hopper's bulk copies (TMA, a 4-stage ring of
// 32 KB tiles a block) took 0.922 ms.
//
// K3 replaces the Pallas kernel of InterpreterProgram._unblock_gather_n in
// the same JAX module (backend/interp.py): out[w] is row src[w] of
// the narrow sources, raw where shift[w] < 0, else bit shift[w] of it
// ((row >>u shift) & 1, the unpack of a bit-packed word row).  A source
// row below the narrow bank's row count is read from the bank, a larger
// one from the narrow inputs x_n, both in place.  The TPU kernel batched 32
// output rows a grid cell and deduplicated their source rows to amortize
// its per-cell cost; here a 2-D grid does the same job without tables:
// blockIdx.y walks the witness rows, threads run along the batch, so every
// read and write is coalesced (16 bytes a thread where the rows allow) and
// a run of output rows unpacking one word row re-reads it from L2.  Bound
// on the card: device-memory bandwidth, the output written once (27,369
// rows for SHA256) and each distinct source row read once.
#include <cuda_runtime.h>

#include <cstdint>

#include "narrow.cuh"

namespace ctpu {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ bank,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, long long row_elems,
                                   long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long w = e / row_elems;
    const long long r = e - w * row_elems;
    out[e] = bank[(long long)__ldg(idx + w) * row_elems + r];
  }
}

template <typename T>
void launch(const T* bank, const int32_t* idx, T* out, long long row_elems,
            long long W, cudaStream_t s) {
  const int threads = 256;
  const long long total = W * row_elems;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<T>
      <<<(unsigned)blocks, threads, 0, s>>>(bank, idx, out, row_elems, total);
}

template <int V>
__global__ void gather_n_kernel(const int32_t* __restrict__ bank_n,
                                long long n_bank_rows,
                                const int32_t* __restrict__ x_n,
                                const int32_t* __restrict__ src,
                                const int32_t* __restrict__ shift,
                                int32_t* __restrict__ out, long long W,
                                long long B) {
  const long long n_vec = B / V;
  for (long long w = blockIdx.y; w < W; w += gridDim.y) {
    const long long r = __ldg(src + w);
    const int32_t sh = __ldg(shift + w);
    const int32_t* row = r < n_bank_rows ? bank_n + r * B
                                         : x_n + (r - n_bank_rows) * B;
    int32_t* dst = out + w * B;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n_vec; i += (long long)gridDim.x * blockDim.x) {
      if constexpr (V == 4) {
        int4 v = reinterpret_cast<const int4*>(row)[i];
        v.x = unpack_bit(v.x, sh);
        v.y = unpack_bit(v.y, sh);
        v.z = unpack_bit(v.z, sh);
        v.w = unpack_bit(v.w, sh);
        reinterpret_cast<int4*>(dst)[i] = v;
      } else {
        dst[i] = unpack_bit(row[i], sh);
      }
    }
  }
}

}  // namespace ctpu

// K2.  bank: (R, row_words) uint32, idx: (W,) int32, out: (W, row_words),
// all on the device, every idx[w] in [0, R).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ctpu_gather_rows(const uint32_t* bank, const int32_t* idx,
                                uint32_t* out, long long row_words,
                                long long W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == 0 || row_words == 0) return 0;
  if (row_words % 4 == 0 && ((uintptr_t)bank | (uintptr_t)out) % 16 == 0) {
    ctpu::launch<uint4>(reinterpret_cast<const uint4*>(bank), idx,
                        reinterpret_cast<uint4*>(out), row_words / 4, W, s);
  } else {
    ctpu::launch<uint32_t>(bank, idx, out, row_words, W, s);
  }
  return (int)cudaGetLastError();
}

// K3.  bank_n: (n_bank_rows, B) int32, x_n: (n_xn, B) int32, src and shift:
// (W,) int32, out: (W, B) int32, all on the device; every src[w] lies in
// [0, n_bank_rows + n_xn).  Returns the launch's cudaError_t (0 on
// success).
extern "C" int ctpu_gather_n(const int32_t* bank_n, long long n_bank_rows,
                             const int32_t* x_n, const int32_t* src,
                             const int32_t* shift, int32_t* out, long long W,
                             long long B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == 0 || B == 0) return 0;
  const int threads = 256;
  const bool vec = B % 4 == 0 &&
                   ((uintptr_t)bank_n | (uintptr_t)x_n | (uintptr_t)out) %
                           16 == 0;
  const long long n_vec = vec ? B / 4 : B;
  long long bx = (n_vec + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  const dim3 grid((unsigned)bx, (unsigned)(W < 65535 ? W : 65535));
  if (vec) {
    ctpu::gather_n_kernel<4><<<grid, threads, 0, s>>>(
        bank_n, n_bank_rows, x_n, src, shift, out, W, B);
  } else {
    ctpu::gather_n_kernel<1><<<grid, threads, 0, s>>>(
        bank_n, n_bank_rows, x_n, src, shift, out, W, B);
  }
  return (int)cudaGetLastError();
}
