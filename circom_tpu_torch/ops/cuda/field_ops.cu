// Elementwise field kernels over (N, L, B) uint32 limb planes.
//
// K5 replaces the Pallas kernel of ops/pallas_field.py make_mont_mul (the
// CIOS product a*b*R^-1 mod p) and K6 replaces make_add / make_sub (with
// _cond_sub_store).  No main path launches them: the R1CS check is KC
// (check.cu) and a per-op run one KS launch (scan.cu).  The check's plain
// route and the per-op executors' step loop, which run on the card only
// as oracles, and the per-op library take them.
//
// Operands may broadcast (a stride of 0 in n or b), which lets a caller
// multiply (nnz, L, B) gathered wires by (nnz, L, 1) coefficients without
// materialising them.  Neighbouring threads take neighbouring b, so each
// limb row is read and written as one coalesced line per warp.
//
// K5 (mont_mul_kernel): blockIdx.y walks n and x the lanes, so no element
// index is divided.  A thread packs its operands into L/2 32-bit words on
// load, multiplies in base 2^32 (field32.cuh) and unpacks on store; an
// operand that broadcasts over the lanes is read and packed once per n.
// At L = 16 that is 128 wide products an element against 2L words read and
// L written, so device-memory bandwidth bounds it: on an H100 80GB HBM3 at
// 700 W it moves 2.9 TB/s at the checker's shape, 86 % of the HBM rate, in
// 0.86 ms where the 16-bit steps it replaced (~2,500 lane operations an
// element) took 1.65 ms, bound by those operations.
//
// K6 (elementwise_kernel): one thread per (n, b) element, packed into L/2
// 32-bit words on load as K5 is, the modular add and subtract of dot32.cuh
// (mod_add32, mod_sub32: a carry chain of L/2 words and one conditional
// subtract, the results of field.cuh's 16-bit steps on every operand of
// 16-bit limbs), unpacked on store; it moves 3L words for O(L) work and is
// bound by device-memory bandwidth.
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field32.cuh"

namespace ctpu {

enum ElemOp { OP_MONT_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

struct Strides {
  long long n, l, b;
};

template <int L>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, Strides sa,
                                const uint32_t* __restrict__ b, Strides sb,
                                uint32_t* __restrict__ out, long long N,
                                long long B, FieldConsts fc) {
  constexpr int W = L / 2;
  uint32_t p[W];
  p_words<L>(fc, p);
  const long long lane0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const bool b_bcast = sb.b == 0;
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    const uint32_t* pa = a + n * sa.n;
    const uint32_t* pb = b + n * sb.n;
    uint32_t* po = out + n * L * B;
    uint32_t yb[W];
    if (b_bcast) pack32<L>(pb, sb.l, yb);
    for (long long lane = lane0; lane < B; lane += step) {
      uint32_t x[W], y[W], r[W];
      pack32<L>(pa + lane * sa.b, sa.l, x);
      if (b_bcast) {
#pragma unroll
        for (int i = 0; i < W; ++i) y[i] = yb[i];
      } else {
        pack32<L>(pb + lane * sb.b, sb.l, y);
      }
      mont_mul32<W>(x, y, p, fc.n0inv32, r);
      unpack32<L>(r, po + lane, B);
    }
  }
}

template <int L, int OP>
__global__ void elementwise_kernel(const uint32_t* __restrict__ a, Strides sa,
                                   const uint32_t* __restrict__ b, Strides sb,
                                   uint32_t* __restrict__ out, long long N,
                                   long long B, FieldConsts fc) {
  constexpr int W = L / 2;
  uint32_t p[W];
  p_words<L>(fc, p);
  const long long total = N * B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long n = e / B;
    const long long lane = e - n * B;
    uint32_t x[W], y[W], r[W];
    pack32<L>(a + n * sa.n + lane * sa.b, sa.l, x);
    pack32<L>(b + n * sb.n + lane * sb.b, sb.l, y);
    if (OP == OP_ADD) {
      mod_add32<W>(x, y, p, r);
    } else {
      mod_sub32<W>(x, y, p, r);
    }
    unpack32<L>(r, out + n * L * B + lane, B);
  }
}

template <int L>
void launch(int op, const uint32_t* a, Strides sa, const uint32_t* b,
            Strides sb, uint32_t* out, long long N, long long B,
            const FieldConsts& fc, cudaStream_t stream) {
  const int threads = 128;
  if (op == OP_MONT_MUL) {
    // the product is symmetric: let b be the operand that broadcasts over
    // the lanes, if one does, so that it is read once per n
    if (sa.b == 0 && sb.b != 0) {
      const uint32_t* t = a;
      a = b;
      b = t;
      const Strides s = sa;
      sa = sb;
      sb = s;
    }
    long long bx = (B + threads - 1) / threads;
    if (bx > 65535) bx = 65535;  // the lane loop strides beyond this
    const dim3 grid((unsigned)bx, (unsigned)(N < 65535 ? N : 65535));
    mont_mul_kernel<L><<<grid, threads, 0, stream>>>(a, sa, b, sb, out, N, B,
                                                     fc);
    return;
  }
  long long blocks = (N * B + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  if (op == OP_ADD) {
    elementwise_kernel<L, OP_ADD>
        <<<(unsigned)blocks, threads, 0, stream>>>(a, sa, b, sb, out, N, B, fc);
  } else {
    elementwise_kernel<L, OP_SUB>
        <<<(unsigned)blocks, threads, 0, stream>>>(a, sa, b, sb, out, N, B, fc);
  }
}

}  // namespace ctpu

// op: 0 mont_mul, 1 add, 2 sub.  a_strides / b_strides: (n, l, b) in
// elements.  p_limbs: L host words; n0inv: -p^-1 mod 2^16; n0inv32: -p^-1
// mod 2^32.  N, B > 0.  Returns the launch's cudaError_t (0 on success).
extern "C" int ctpu_field_elementwise(int op, int L, const uint32_t* a,
                                      const long long* a_strides,
                                      const uint32_t* b,
                                      const long long* b_strides,
                                      uint32_t* out, long long N, long long B,
                                      const uint32_t* p_limbs, uint32_t n0inv,
                                      uint32_t n0inv32, void* stream) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L && i < 24; ++i) fc.p[i] = p_limbs[i];
  fc.n0inv = n0inv;
  fc.n0inv32 = n0inv32;
  const ctpu::Strides sa = {a_strides[0], a_strides[1], a_strides[2]};
  const ctpu::Strides sb = {b_strides[0], b_strides[1], b_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4: ctpu::launch<4>(op, a, sa, b, sb, out, N, B, fc, s); break;
    case 16: ctpu::launch<16>(op, a, sa, b, sb, out, N, B, fc, s); break;
    case 24: ctpu::launch<24>(op, a, sa, b, sb, out, N, B, fc, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
