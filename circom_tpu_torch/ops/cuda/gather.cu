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
// one, n_bank_rows + k, is narrow input k read where the caller's input
// rows lie: limb0 | limb1 << 16 of input row nin_order[k] (limb0 alone
// where the rows have one limb), as K1 loads it.  The TPU kernel batched 32
// output rows a grid cell and deduplicated their source rows to amortize
// its per-cell cost; here a 2-D grid does the same job without tables:
// blockIdx.y walks the witness rows, threads run along the batch, so every
// read and write is coalesced (16 bytes a thread where the rows allow) and
// a run of output rows unpacking one word row re-reads it from L2.  Bound
// on the card: device-memory bandwidth, the output written once (27,369
// rows for SHA256) and each distinct source row read once.
//
// KW: the interpreter's full-limb witness, uint32 (W, L, B) in 16-bit
// canonical limbs, in one launch straight from its sources.  Not a Pallas
// site: it replaces what the JAX package's InterpreterProgram runs as one
// jitted XLA program after its kernel (backend/interp.py:2200-2219: a
// `take` of the narrow emissions, `_unpack_bits`, `_widen_narrow`, the
// banks concatenated, one `take` into witness order).  A table of one int4
// a witness row (backend/interp.kw_table, checked on the host when it is
// built: each row written once, each source inside its tensor) names the
// row's source, one of four kinds:
//   KW_BANK    a row of the wide bank, copied (K2's copy);
//   KW_INPUT   a row of the full-limb inputs, copied: a wide input, or a
//              narrow input's own limbs;
//   KW_CONST   a constant (L limbs), the same in every lane;
//   KW_NARROW  a narrow bank row, bit `shift` unpacked as K3 does, then
//              widened: v >= 0 -> [v & 0xffff, v >> 16, 0, ...]; v < 0 ->
//              (p - 2^32) + uint32(v), one carry chain over p - 2^32's
//              limbs (ops/narrow.widen_narrow), in registers.
// blockIdx.y walks the witness rows, threads run along the lanes and write
// every limb of theirs, so each source value is read once and each limb
// written once, coalesced: 16 bytes a thread (4 lanes) where B is a
// multiple of 4 and the bases are 16-byte aligned, else 4.  Offsets are
// 64-bit (F's witness at 8,192 lanes is 14.3 GB).  Bound on the card:
// device-memory bandwidth, the witness written once and each distinct
// source row read once (utils/roofline.kw_bytes).  On an H100 80GB HBM3 at
// 700 W it writes SHA256's full-limb witness at 8,192 lanes (14.41 GB
// moved) in 4.51 ms, 95 % of that bound and as fast as index_select of as
// many rows into the same output (4.62 ms); MerkleInclusion(32)'s at
// 16,384 lanes in 7.19 ms (90 %).
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

// Narrow input value of limbs lo and hi (hi 0 where the rows have one limb).
__device__ __forceinline__ int32_t narrow_in(uint32_t lo, uint32_t hi) {
  return (int32_t)(lo | (hi << 16));
}

// K3's block, and 8 blocks an SM: at most 32 registers a thread, so that a
// launch runs at full occupancy (a block is one row of 1,024 lanes at
// 16 bytes a thread).  Without the bound, reading the two input limbs
// took it to 40 and 48 registers, and K3 at M's shape ran 5 % slower than
// the K3 that read the split narrow inputs; with it (ptxas spills 72
// bytes in one of the two variants) 6 % faster (kernel_ab, in turns, on
// an H100).
constexpr int K3_THREADS = 256;

template <int V>
__global__ void __launch_bounds__(K3_THREADS, 8)
gather_n_kernel(const int32_t* __restrict__ bank_n, long long n_bank_rows,
                const uint32_t* __restrict__ inputs, int lin,
                const int32_t* __restrict__ nin_order,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ shift, int32_t* __restrict__ out,
                long long W, long long B) {
  const long long n_vec = B / V;
  for (long long w = blockIdx.y; w < W; w += gridDim.y) {
    const long long r = __ldg(src + w);
    const int32_t sh = __ldg(shift + w);
    int32_t* dst = out + w * B;
    if (r < n_bank_rows) {
      const int32_t* row = bank_n + r * B;
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
      continue;
    }
    // narrow input r - n_bank_rows: limbs 0 and 1 of its input row
    const uint32_t* lo =
        inputs + (long long)__ldg(nin_order + (r - n_bank_rows)) * lin * B;
    const uint32_t* hi = lo + B;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n_vec; i += (long long)gridDim.x * blockDim.x) {
      if constexpr (V == 4) {
        const uint4 l = reinterpret_cast<const uint4*>(lo)[i];
        const uint4 h = lin > 1 ? reinterpret_cast<const uint4*>(hi)[i]
                                : make_uint4(0, 0, 0, 0);
        int4 v;
        v.x = unpack_bit(narrow_in(l.x, h.x), sh);
        v.y = unpack_bit(narrow_in(l.y, h.y), sh);
        v.z = unpack_bit(narrow_in(l.z, h.z), sh);
        v.w = unpack_bit(narrow_in(l.w, h.w), sh);
        reinterpret_cast<int4*>(dst)[i] = v;
      } else {
        dst[i] = unpack_bit(narrow_in(lo[i], lin > 1 ? hi[i] : 0u), sh);
      }
    }
  }
}

// KW's row kinds: column 0 of its table (backend/interp.py KW_*)
enum { KW_BANK = 0, KW_INPUT = 1, KW_CONST = 2, KW_NARROW = 3 };
constexpr int KW_MAX_L = 32;
constexpr int KW_CHUNK = 8;   // limbs a thread loads before it stores

struct KwArgs {
  const int4* tab;          // (W,): kind, source row, shift, 0
  const uint32_t* bank;     // (n_bank_rows, L, B) wide bank
  const int32_t* bank_n;    // (n_bank_n_rows, B) narrow bank
  const uint32_t* inputs;   // (n_inputs, L, B) full-limb inputs
  const uint32_t* consts;   // (n_consts, L)
  uint32_t* out;            // (W, L, B)
  long long W, B;
  int L;
  uint32_t q[KW_MAX_L];     // p - 2^32 in 16-bit limbs
};

template <int V>
struct KwVec;
template <>
struct KwVec<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T splat(uint32_t c) { return c; }
};
template <>
struct KwVec<4> {
  using T = uint4;
  static __device__ __forceinline__ T splat(uint32_t c) {
    return make_uint4(c, c, c, c);
  }
};

// limb l of the widening of narrow value v (ops/narrow.widen_narrow),
// limbs taken in order 0, 1, ..., with carry the chain's carry in and out
__device__ __forceinline__ uint32_t widen_limb(int32_t v, int l,
                                               uint32_t q_l,
                                               uint32_t& carry) {
  const uint32_t u = (uint32_t)v;
  const uint32_t t =
      (l == 0 ? (u & 0xffffu) : l == 1 ? (u >> 16) : 0u) + q_l + carry;
  carry = t >> 16;
  if (v < 0) return t & 0xffffu;
  return l == 0 ? (u & 0xffffu) : l == 1 ? (u >> 16) : 0u;
}

template <int V>
__global__ void assemble_kernel(const __grid_constant__ KwArgs a) {
  using T = typename KwVec<V>::T;
  const long long n_vec = a.B / V;
  const long long row = (long long)a.L * a.B;
  for (long long w = blockIdx.y; w < a.W; w += gridDim.y) {
    const int4 t = __ldg(a.tab + w);
    T* dst = reinterpret_cast<T*>(a.out + w * row);
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n_vec; i += (long long)gridDim.x * blockDim.x) {
      if (t.x == KW_BANK || t.x == KW_INPUT) {
        const T* src = reinterpret_cast<const T*>(
            (t.x == KW_BANK ? a.bank : a.inputs) + (long long)t.y * row);
        for (int l0 = 0; l0 < a.L; l0 += KW_CHUNK) {
          T v[KW_CHUNK];
#pragma unroll
          for (int j = 0; j < KW_CHUNK; ++j)
            if (l0 + j < a.L) v[j] = __ldg(src + (l0 + j) * n_vec + i);
#pragma unroll
          for (int j = 0; j < KW_CHUNK; ++j)
            if (l0 + j < a.L) dst[(l0 + j) * n_vec + i] = v[j];
        }
      } else if (t.x == KW_CONST) {
        const uint32_t* c = a.consts + (long long)t.y * a.L;
        for (int l = 0; l < a.L; ++l)
          dst[l * n_vec + i] = KwVec<V>::splat(__ldg(c + l));
      } else {
        const int32_t* src = a.bank_n + (long long)t.y * a.B;
        int32_t v[V];
        if constexpr (V == 4) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(src) + i);
          v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
        } else {
          v[0] = __ldg(src + i);
        }
        uint32_t carry[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          v[k] = unpack_bit(v[k], t.z);
          carry[k] = 0;
        }
        for (int l = 0; l < a.L; ++l) {
          uint32_t o[V];
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = widen_limb(v[k], l, a.q[l],
                                                        carry[k]);
          if constexpr (V == 4) {
            dst[l * n_vec + i] = make_uint4(o[0], o[1], o[2], o[3]);
          } else {
            dst[l * n_vec + i] = o[0];
          }
        }
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

// K3.  bank_n: (n_bank_rows, B) int32; inputs: (n_inputs, lin, B) uint32
// 16-bit limbs, the caller's input rows, lin >= 1; nin_order: (n_nin,)
// int32, the input row of each narrow input, each below n_inputs; src and
// shift: (W,) int32; out: (W, B) int32; all on the device; every src[w]
// lies in [0, n_bank_rows + n_nin).  Returns the launch's cudaError_t (0 on
// success).
extern "C" int ctpu_gather_n(const int32_t* bank_n, long long n_bank_rows,
                             const uint32_t* inputs, int lin,
                             const int32_t* nin_order, const int32_t* src,
                             const int32_t* shift, int32_t* out, long long W,
                             long long B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lin < 1) return (int)cudaErrorInvalidValue;
  if (W == 0 || B == 0) return 0;
  const int threads = ctpu::K3_THREADS;
  const bool vec = B % 4 == 0 &&
                   ((uintptr_t)bank_n | (uintptr_t)inputs | (uintptr_t)out) %
                           16 == 0;
  const long long n_vec = vec ? B / 4 : B;
  long long bx = (n_vec + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  const dim3 grid((unsigned)bx, (unsigned)(W < 65535 ? W : 65535));
  if (vec) {
    ctpu::gather_n_kernel<4><<<grid, threads, 0, s>>>(
        bank_n, n_bank_rows, inputs, lin, nin_order, src, shift, out, W, B);
  } else {
    ctpu::gather_n_kernel<1><<<grid, threads, 0, s>>>(
        bank_n, n_bank_rows, inputs, lin, nin_order, src, shift, out, W, B);
  }
  return (int)cudaGetLastError();
}

// KW.  tab: (W, 4) int32, each row (kind, source row, shift, 0) with every
// source inside its tensor; bank: (n_bank_rows, L, B) uint32; bank_n:
// (n_bank_n_rows, B) int32; inputs: (n_inputs, L, B) uint32; consts:
// (n_consts, L) uint32; out: (W, L, B) uint32, every row written; all on
// the device.  q: L host words, the 16-bit limbs of p - 2^32.  L is 1 to
// KW_MAX_L (else cudaErrorInvalidValue).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ctpu_assemble(int L, long long B, const int32_t* tab,
                             long long W, const uint32_t* bank,
                             const int32_t* bank_n, const uint32_t* inputs,
                             const uint32_t* consts, const uint32_t* q,
                             uint32_t* out, void* stream) {
  if (L < 1 || L > ctpu::KW_MAX_L || W < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (W == 0 || B == 0) return 0;
  ctpu::KwArgs a = {reinterpret_cast<const int4*>(tab), bank, bank_n,
                    inputs, consts, out, W, B, L, {}};
  for (int l = 0; l < L; ++l) a.q[l] = q[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = B % 4 == 0 &&
                   ((uintptr_t)bank | (uintptr_t)bank_n | (uintptr_t)inputs |
                    (uintptr_t)out) % 16 == 0;
  const long long n_vec = vec ? B / 4 : B;
  long long threads = (n_vec + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  long long bx = (n_vec + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  const dim3 grid((unsigned)bx, (unsigned)(W < 65535 ? W : 65535));
  if (vec) {
    ctpu::assemble_kernel<4><<<grid, (unsigned)threads, 0, s>>>(a);
  } else {
    ctpu::assemble_kernel<1><<<grid, (unsigned)threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
