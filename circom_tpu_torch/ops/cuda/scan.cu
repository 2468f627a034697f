// Kernel KS: a per-op witness tape's whole run, every live node, as one
// launch.
//
// It replaces the JAX package's jitted `lax.scan` over the step tables
// (circom_tpu/backend/jax_backend.py:571-617, `WitnessProgram._run`, over
// the 27 branches of `_branch`, :392-465) and its jitted straight-line
// `_run_ssa` (:487), which XLA compiles into one program each and which no
// Pallas kernel computes.  Both per-op executors of the port launch it:
// the scan (backend/scan.py) and the straight-line path (backend/perop.py),
// each over tables that backend/ks.py builds once a width from the tape's
// live nodes; their plain versions (the step loop, a library call a node)
// run on the CPU and as KS's oracles.
//
// A lane depends on no other lane, so a block owns 32 lanes: their
// registers, witness rows and steps, ordered by nothing but the block's
// barrier.  The tables are one stream of entries of 8 int32s, (op, a, b,
// c, o, w, imm, 0), cut into steps by `off`: step s is the entries
// [off[s], off[s + 1]).  A step holds up to `warps` independent entries
// (the builder's list schedule: an entry reads only what earlier steps
// wrote), then a last step the witness rows that copy another row and the
// constants' rows.  An operand >= 0 is a register, < 0 the constant -1 -
// operand, read from the constant table as any register is; o < 0 writes
// no register, w < 0 no witness row.  The host checks once, when it
// builds the tables, that every register is written by an earlier step
// before it is read and holds the value read, that a step writes no
// register twice nor one that it reads, and that every witness row is
// written exactly once; so the register file needs no initialisation and
// the kernel tests nothing at run time.
//
// Warps.  Warp k of a block takes the step's entries k, k + warps, ... on
// its 32 lanes, so a warp never diverges on the opcode, and the block's
// barrier follows each step (none at one warp, whose entries run in
// order).  The width is chosen by lanes and by the tape's parallelism
// (backend/ks.py `ks_width`); tables exist for each width used.
//
// The register file.  Registers 0 .. n_smem - 1 live in the block's
// dynamic shared memory as [register][word][lane]: a warp's word is 32
// consecutive banks, no conflict.  The builder allocates the lowest free
// register first, so the busiest registers are the shared ones; a tape
// whose live set exceeds the budget keeps registers n_smem .. in a file
// in device memory, (n_regs - n_smem, N, b) words, lane-minor, each word a
// 128-byte line for a warp.  Words are N = L/2 32-bit words (two 16-bit
// limbs).  The constants are one table of N words each, uniform across a
// warp: read through the read-only cache.  The witness keeps the
// reference's layout, (n_witness, L, b) 16-bit limbs in uint32, 64-bit
// offsets.  Each opcode computes in words with the device functions K1
// and K5 are held to: field32.cuh's CIOS (mont_mul32, cond_sub32),
// dot32.cuh's mod_add32 and mod_sub32, wide32.cuh's comparisons, bit ops,
// shifts and long division, bit for bit the values of TorchField and
// `perop.node_value` (the shifts and the power per entry, as `shift_dyn`
// and `pow_dyn`).
//
// Canonical results at every field, p just under R = 2^(32N) included
// (secq256r1, goldilocks): inputs, constants and registers hold canonical
// values, and every reduction subtracts p once from a value below 2p.
// mont (mul, to_mont, from_mont), mul_norm, div_mont and pow_dyn are
// chains of field32.cuh's CIOS on canonical operands: x y < p^2 < R p, so
// (x y + M p) / R < 2p.  add: a + b < 2p; sub, neg, mod: a + p - b in
// (0, 2p); the quotient of idiv is at most its dividend; bor, bxor, bnot
// and shl: below 2^bits <= 2p (wide32.cuh).  KS has no lazy dot.
//
// Bound: the compulsory bytes, the inputs read once and the witness
// written once (utils/roofline.ks_bytes), plus a spilled register's
// traffic; the shared file's traffic stays on the SM.  The operations
// (utils/roofline.ks_ops) are below them on the tapes measured: shifts
// and ands are N words each, products 2 N^2 32x32->64-bit products.
//
// Plain C++ apart from the launch, the barrier and the shared buffer, so
// that g++ builds it for the host (tests/test_torch_scan_kernel.py: a host
// thread a CUDA thread, a host barrier, one buffer a block, blocks in
// turn).
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field.cuh"
#include "field32.cuh"
#include "wide32.cuh"

namespace ctpu {

constexpr int KS_LANES = 32;      // lanes a block: a thread of each warp
constexpr int KS_MAX_WARPS = 16;

// KS's opcodes: backend/ks.py KS_OPS in this order
enum KsOp {
  KS_ADD, KS_SUB, KS_MUL, KS_MULP, KS_DIV, KS_NEG, KS_LT, KS_LE, KS_GT,
  KS_GE, KS_EQ, KS_NEQ, KS_LAND, KS_LOR, KS_LNOT, KS_BAND, KS_BOR, KS_BXOR,
  KS_BNOT, KS_SHL, KS_SHR, KS_POW, KS_IDIV, KS_MOD, KS_SELECT, KS_TO_MONT,
  KS_FROM_MONT,
  // an input's load, a constant's witness row, a witness row's copy
  KS_CONST, KS_INPUT, KS_DUP
};

struct KsArgs {
  const int* off;          // (n_steps + 1,)
  const int4* ent;         // two int4 an entry
  int n_steps;
  const uint32_t* consts;  // (n_consts, N) words
  const uint32_t* x;       // (n_inputs, L, b) 16-bit limbs
  uint32_t* spill;         // (n_regs - n_smem, N, b) words
  uint32_t* out;           // (n_witness, L, b) 16-bit limbs
  long long b;             // lanes
  int n_smem;              // registers in shared memory
};

template <int N>
struct KsConsts {
  uint32_t p[N], r2[N], one[N], half[N], mask[N], pm2[N];
  uint32_t n0inv32;  // -p^-1 mod 2^32
  int bits;          // p.bit_length(): the long division's steps
  int pm2_bits;      // (p - 2).bit_length(): the inversion's exponent
};

// Where the N words of an operand or a register are for one lane: word i
// at p[i * s].  sm is the block's shared file offset by the lane's column.
struct KsWords {
  const uint32_t* p;
  long long s;
};

template <int N>
__device__ __forceinline__ KsWords words_at(const KsArgs& a,
                                            const uint32_t* sm,
                                            long long lane, int r) {
  if (r < 0) return {a.consts + (long long)(-1 - r) * N, 1};
  if (r < a.n_smem) return {sm + r * N * KS_LANES, KS_LANES};
  return {a.spill + (long long)(r - a.n_smem) * N * a.b + lane, a.b};
}

template <int N>
__device__ __forceinline__ void load(KsWords w, uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = w.p[i * w.s];
}

template <int N>
__device__ __forceinline__ void store(const KsArgs& a, uint32_t* sm,
                                      long long lane, int r,
                                      const uint32_t (&v)[N]) {
  if (r < a.n_smem) {
    uint32_t* d = sm + r * N * KS_LANES;
#pragma unroll
    for (int i = 0; i < N; ++i) d[i * KS_LANES] = v[i];
  } else {
    uint32_t* d = a.spill + (long long)(r - a.n_smem) * N * a.b + lane;
#pragma unroll
    for (int i = 0; i < N; ++i) d[i * a.b] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void mont(const uint32_t (&x)[N],
                                     const uint32_t (&y)[N],
                                     const KsConsts<N>& kc,
                                     uint32_t (&out)[N]) {
  uint32_t t[N];
  mont_mul32<N>(x, y, kc.p, kc.n0inv32, t);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = t[i];
}

// TorchField.mul_norm: a b R^-1, then * R^2
template <int N>
__device__ __forceinline__ void mul_norm(const uint32_t (&x)[N],
                                         const uint32_t (&y)[N],
                                         const KsConsts<N>& kc,
                                         uint32_t (&out)[N]) {
  uint32_t t[N];
  mont<N>(x, y, kc, t);
  mont<N>(t, kc.r2, kc, out);
}

// TorchField.div_mont: a * pow_mont(b, p - 2), pow_mont starting from b
// and taking the exponent's bits below its top one
template <int N>
__device__ __forceinline__ void div_mont(const uint32_t (&x)[N],
                                         const uint32_t (&y)[N],
                                         const KsConsts<N>& kc,
                                         uint32_t (&out)[N]) {
  uint32_t acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = y[i];
#pragma unroll 1
  for (int i = kc.pm2_bits - 2; i >= 0; --i) {
    mont<N>(acc, acc, kc, acc);
    if ((kc.pm2[i >> 5] >> (i & 31)) & 1u) mont<N>(acc, y, kc, acc);
  }
  mont<N>(x, acc, kc, out);
}

// TorchField.pow_dyn: 32 rounds from one_mont, a square each and a
// product where bit 31 - i of e is set
template <int N>
__device__ __forceinline__ void pow_dyn(const uint32_t (&x)[N], uint32_t e,
                                        const KsConsts<N>& kc,
                                        uint32_t (&out)[N]) {
  uint32_t acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = kc.one[i];
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    mont<N>(acc, acc, kc, acc);
    if ((e >> (31 - i)) & 1u) mont<N>(acc, x, kc, acc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = acc[i];
}

template <int N, int C>
__device__ __forceinline__ void cmp_bit(const uint32_t (&x)[N],
                                        const uint32_t (&y)[N],
                                        const KsConsts<N>& kc,
                                        uint32_t (&out)[N]) {
  out[0] = cmp32<N, C>(x, y, kc.half) ? 1u : 0u;
#pragma unroll
  for (int i = 1; i < N; ++i) out[i] = 0;
}

// One entry on one lane.
template <int L>
__device__ __forceinline__ void ks_entry(const KsArgs& a,
                                         const KsConsts<L / 2>& kc,
                                         uint32_t* sm, int e,
                                         long long lane) {
  constexpr int N = L / 2;
  const int4 h0 = __ldg(a.ent + 2 * e);
  const int4 h1 = __ldg(a.ent + 2 * e + 1);
  const int op = h0.x, ra = h0.y, rb = h0.z, rc = h0.w;
  const int ro = h1.x, rw = h1.y, imm = h1.z;
  const long long b = a.b;
  uint32_t x[N], y[N], r[N];
  switch (op) {
    case KS_CONST:
      load<N>(words_at<N>(a, sm, lane, -1 - imm), r);
      break;
    case KS_INPUT:
      pack32<L>(a.x + (long long)ra * L * b + lane, b, r);
      break;
    case KS_DUP: {
      const uint32_t* s = a.out + (long long)ra * L * b + lane;
      uint32_t* d = a.out + (long long)rw * L * b + lane;
#pragma unroll
      for (int i = 0; i < L; ++i) d[i * b] = s[i * b];
      return;
    }
    case KS_SHL:
    case KS_SHR:
    case KS_IDIV:
    case KS_MOD: {
      // the shifts and the long division read a's words in place, an
      // index that depends on the entry's count
      const KsWords wa = words_at<N>(a, sm, lane, ra);
      auto word = [wa](int i) { return wa.p[i * wa.s]; };
      if (op == KS_SHL) {
        shift32<N, true>(word, imm, kc.p, kc.mask, r);
      } else if (op == KS_SHR) {
        shift32<N, false>(word, imm, kc.p, kc.mask, r);
      } else {
        load<N>(words_at<N>(a, sm, lane, rb), y);
        idiv32<N>(word, y, kc.bits, r);
        if (op == KS_MOD) {  // a - mul_norm(a // b, b)
          mul_norm<N>(r, y, kc, r);
          load<N>(wa, x);
          mod_sub32<N>(x, r, kc.p, r);
        }
      }
      break;
    }
    default:
      load<N>(words_at<N>(a, sm, lane, ra), x);
      switch (op) {
        case KS_NEG: {
          uint32_t z[N];
#pragma unroll
          for (int i = 0; i < N; ++i) z[i] = 0;
          mod_sub32<N>(z, x, kc.p, r);
          break;
        }
        case KS_LNOT:
          r[0] = nonzero32<N>(x) ? 0u : 1u;
#pragma unroll
          for (int i = 1; i < N; ++i) r[i] = 0;
          break;
        case KS_BNOT: bnot32<N>(x, kc.mask, kc.p, r); break;
        case KS_POW: pow_dyn<N>(x, (uint32_t)imm, kc, r); break;
        case KS_TO_MONT: mont<N>(x, kc.r2, kc, r); break;
        case KS_FROM_MONT: {
          uint32_t one[N];
#pragma unroll
          for (int i = 0; i < N; ++i) one[i] = i == 0 ? 1u : 0u;
          mont<N>(x, one, kc, r);
          break;
        }
        case KS_SELECT:
          load<N>(words_at<N>(a, sm, lane, nonzero32<N>(x) ? rb : rc), r);
          break;
        default:
          load<N>(words_at<N>(a, sm, lane, rb), y);
          switch (op) {
            case KS_ADD: mod_add32<N>(x, y, kc.p, r); break;
            case KS_SUB: mod_sub32<N>(x, y, kc.p, r); break;
            case KS_MUL: mont<N>(x, y, kc, r); break;
            case KS_MULP: mul_norm<N>(x, y, kc, r); break;
            case KS_DIV: div_mont<N>(x, y, kc, r); break;
            case KS_LT: cmp_bit<N, WCMP_LT>(x, y, kc, r); break;
            case KS_LE: cmp_bit<N, WCMP_LE>(x, y, kc, r); break;
            case KS_GT: cmp_bit<N, WCMP_GT>(x, y, kc, r); break;
            case KS_GE: cmp_bit<N, WCMP_GE>(x, y, kc, r); break;
            case KS_EQ: cmp_bit<N, WCMP_EQ>(x, y, kc, r); break;
            case KS_NEQ: cmp_bit<N, WCMP_NEQ>(x, y, kc, r); break;
            case KS_LAND: cmp_bit<N, WCMP_LAND>(x, y, kc, r); break;
            case KS_LOR: cmp_bit<N, WCMP_LOR>(x, y, kc, r); break;
            case KS_BAND: bitop32<N, 0>(x, y, kc.p, r); break;
            case KS_BOR: bitop32<N, 1>(x, y, kc.p, r); break;
            default: bitop32<N, 2>(x, y, kc.p, r); break;  // KS_BXOR
          }
      }
  }
  if (ro >= 0) store<N>(a, sm, lane, ro, r);
  if (rw >= 0) unpack32<L>(r, a.out + (long long)rw * L * b + lane, b);
}

template <int L>
__global__ void __launch_bounds__(KS_LANES * KS_MAX_WARPS)
    scan_kernel(const __grid_constant__ KsArgs a,
                const __grid_constant__ KsConsts<L / 2> kc) {
  extern __shared__ uint32_t ks_smem[];
  const int warps = blockDim.x / KS_LANES;
  const int warp = threadIdx.x / KS_LANES;
  const int col = threadIdx.x % KS_LANES;
  const long long lane = (long long)blockIdx.x * KS_LANES + col;
  const bool live = lane < a.b;
  uint32_t* sm = ks_smem + col;
  int e0 = __ldg(a.off);
  for (int s = 0; s < a.n_steps; ++s) {
    const int e1 = __ldg(a.off + s + 1);
    if (live)
      for (int e = e0 + warp; e < e1; e += warps)
        ks_entry<L>(a, kc, sm, e, lane);
    e0 = e1;
    // the step's writes before the next step's reads, across the warps
    if (warps > 1) __syncthreads();
  }
}

// The words of a value of L 16-bit limbs.
template <int N>
void words_of(const uint32_t* limbs, uint32_t (&w)[N]) {
  for (int i = 0; i < N; ++i) w[i] = limbs[2 * i] | (limbs[2 * i + 1] << 16);
}

template <int L>
int launch(const KsArgs& a, const uint32_t* limbs, uint32_t n0inv32,
           int bits, int warps, cudaStream_t s) {
  constexpr int N = L / 2;
  KsConsts<N> kc = {};
  words_of<N>(limbs, kc.p);
  words_of<N>(limbs + L, kc.r2);
  words_of<N>(limbs + 2 * L, kc.one);
  words_of<N>(limbs + 3 * L, kc.half);
  words_of<N>(limbs + 4 * L, kc.mask);
  // p - 2 (p is an odd prime > 2) and its bit length
  uint32_t borrow = 2;
  kc.pm2_bits = 0;
  for (int i = 0; i < N; ++i) {
    const uint64_t d = (uint64_t)kc.p[i] - borrow;
    kc.pm2[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  for (int i = 32 * N - 1; i >= 0 && kc.pm2_bits == 0; --i)
    if ((kc.pm2[i >> 5] >> (i & 31)) & 1u) kc.pm2_bits = i + 1;
  kc.n0inv32 = n0inv32;
  kc.bits = bits;
  const int smem = a.n_smem * N * KS_LANES * (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (a.b + KS_LANES - 1) / KS_LANES;
  scan_kernel<L><<<(unsigned)blocks, KS_LANES * warps, smem, s>>>(a, kc);
  return (int)cudaGetLastError();
}

}  // namespace ctpu

// off: int32 (n_steps + 1); ent: int32 (off[n_steps], 8), the entries
// above; consts: uint32 (n_consts, L/2) words; x: uint32 (n_inputs, L, b)
// 16-bit limbs; spill: uint32 (n_regs - n_smem, L/2, b), written before
// it is read (null when nothing spills); out: uint32 (n_witness, L, b),
// every row written; n_smem: the registers in shared memory, n_smem x L/2
// x 128 bytes a block.  limbs: 5 L host words, the 16-bit limbs of p,
// R^2 mod p, R mod p, p // 2 and 2^bits - 1; n0inv32 = -p^-1 mod 2^32;
// bits = p.bit_length().  L is 4, 16 or 24, warps 1 to 16, b > 0, n_smem
// >= 0 (else cudaErrorInvalidValue).  Returns the launch's cudaError_t (0
// on success).
extern "C" int ctpu_scan(int L, const int* off, const int* ent, int n_steps,
                         const uint32_t* consts, const uint32_t* x,
                         uint32_t* spill, uint32_t* out, long long b,
                         int n_smem, const uint32_t* limbs, uint32_t n0inv32,
                         int bits, int warps, void* stream) {
  if (b <= 0 || n_steps < 0 || n_smem < 0 || warps < 1 ||
      warps > ctpu::KS_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const ctpu::KsArgs a = {off, reinterpret_cast<const int4*>(ent), n_steps,
                          consts, x, spill, out, b, n_smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4: return ctpu::launch<4>(a, limbs, n0inv32, bits, warps, s);
    case 16: return ctpu::launch<16>(a, limbs, n0inv32, bits, warps, s);
    case 24: return ctpu::launch<24>(a, limbs, n0inv32, bits, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
