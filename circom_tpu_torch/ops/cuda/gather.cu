// K2: the wide witness gather, out[w] = bank[idx[w]] over (rows, L, B).
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
// is a multiple of four words, neighbouring threads on neighbouring words.
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace ctpu

// bank: (R, row_words) uint32, idx: (W,) int32 device, out: (W, row_words).
// Returns the launch's cudaError_t (0 on success).
extern "C" int ctpu_gather_rows(const uint32_t* bank, const int32_t* idx,
                                uint32_t* out, long long row_words,
                                long long W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == 0 || row_words == 0) return 0;
  if (row_words % 4 == 0) {
    ctpu::launch<uint4>(reinterpret_cast<const uint4*>(bank), idx,
                        reinterpret_cast<uint4*>(out), row_words / 4, W, s);
  } else {
    ctpu::launch<uint32_t>(bank, idx, out, row_words, W, s);
  }
  return (int)cudaGetLastError();
}
