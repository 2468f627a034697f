// K1a: the witness interpreter kernel for the Poseidon-class opcode set.
//
// Replaces the Pallas kernel of the JAX package's backend/interp.py
// (InterpreterProgram._make_kernel, launched by _exec_block) for the
// opcodes copyw, mul, mul_r2, add_c, dot2_c and dot3_c, with its trailing
// REDC of the flagged emission rows.  It executes the plan tables of
// backend/interp_plan.py exactly as that kernel does: chunks in order, the
// same-opcode runs rstarts[c]..rstarts[c+1] of each chunk, each step's
// result written to its destination register and to emission row `em` of
// its chunk (row K is the dump row, the last register is trash), constant
// registers loaded from mat_loads, and at the end of each chunk the rows
// flagged in mont_tab reduced out of Montgomery form in place.
//
// Design: one thread per witness lane b, 128 threads a block.  The register
// file and the emission bank live in device memory as (rows, L, B) uint32,
// so a warp's reads and writes of one limb row are one coalesced line.
// Every thread of the grid walks the same instruction stream, so each
// table read is a uniform broadcast load, and the opcode switch is taken
// once per run, not per step.  The field arithmetic is ops/cuda/field.cuh,
// a step-for-step port of limb_emit, so the emission bank is bit-identical
// to the JAX kernel's.
//
// Bound on the card: the emission bank (n_chunks*(K+1) rows of L words per
// lane) must be written once, and each mul or dot does L^2 to 4L^2 32-bit
// multiplies per lane; for Poseidon2/bn128 the two bounds are within a
// factor of two of each other (PERF.md).  The register file (14 rows for
// Poseidon2) stays in L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace ctpu {

// Opcode numbering of the kernel: must match K1A_OPCODES in convert.py.
enum K1aOp {
  OP_COPYW = 0,
  OP_MUL = 1,
  OP_MUL_R2 = 2,
  OP_ADD_C = 3,
  OP_DOT2_C = 4,
  OP_DOT3_C = 5,
};

struct InterpArgs {
  const uint32_t* x_w;      // (n_win, L, B) wide inputs
  const int32_t* table;     // (n_steps, 7): op ia ib ic dst em aux
  const int32_t* r_op;      // per run: opcode
  const int32_t* r_s0;      // per run: first step (n_runs + 1 entries)
  const int32_t* rstarts;   // per chunk: first run (n_chunks + 1 entries)
  const uint32_t* cbank;    // (n_bank, L) constant bank
  const int32_t* mont_tab;  // (n_chunks * (K + 1)) trailing-REDC flags
  const int32_t* mat_regs;  // (n_mat) register of each materialized const
  const uint32_t* mat_limbs;  // (n_mat, L)
  uint32_t* rf;             // (n_regs, L, B) register file (scratch)
  uint32_t* bank;           // (n_chunks * (K + 1), L, B) emission bank
  int n_win, n_mat, n_chunks, K;
  long long B;
};

template <int L>
struct Lane {
  long long b, B;
  __device__ __forceinline__ void load(const uint32_t* base, long long row,
                                       uint32_t (&v)[L]) const {
    const uint32_t* p = base + row * L * B + b;
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = p[i * B];
  }
  __device__ __forceinline__ void store(uint32_t* base, long long row,
                                        const uint32_t (&v)[L]) const {
    uint32_t* p = base + row * L * B + b;
#pragma unroll
    for (int i = 0; i < L; ++i) p[i * B] = v[i];
  }
};

template <int L>
__device__ __forceinline__ void load_const(const uint32_t* cbank, int row,
                                           uint32_t (&v)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = __ldg(cbank + (long long)row * L + i);
}

// One run of steps s0..s1 of opcode OP.
template <int L, int OP>
__device__ __forceinline__ void run_steps(const InterpArgs& a,
                                          const Lane<L>& ln,
                                          uint32_t* chunk_bank, int s0,
                                          int s1, const FieldConsts& fc) {
  for (int t = s0; t < s1; ++t) {
    const int32_t* row = a.table + (long long)t * 7;
    const int ia = __ldg(row + 1), ib = __ldg(row + 2), ic = __ldg(row + 3);
    const int dst = __ldg(row + 4), em = __ldg(row + 5), aux = __ldg(row + 6);
    uint32_t r[L];
    if (OP == OP_COPYW) {
      ln.load(a.rf, ia, r);
    } else if (OP == OP_MUL) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      ln.load(a.rf, ib, y);
      mont_mul<L>(x, y, r, fc);
    } else if (OP == OP_MUL_R2) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
#pragma unroll
      for (int i = 0; i < L; ++i) y[i] = fc.r2[i];
      mont_mul<L>(x, y, r, fc);
    } else if (OP == OP_ADD_C) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      load_const<L>(a.cbank, ib, y);
      mod_add<L>(x, y, r, fc);
    } else {
      // dot2_c / dot3_c: bank rows aux..aux+n-1 hold the coefficients,
      // row aux+n an additive constant; accumulate every product into one
      // column set and reduce once (lazy reduction)
      constexpr int NT = (OP == OP_DOT3_C) ? 3 : 2;
      uint32_t cols[2 * L + 1];
#pragma unroll
      for (int k = 0; k < 2 * L + 1; ++k) cols[k] = 0;
      const int regs[3] = {ia, ib, ic};
#pragma unroll
      for (int term = 0; term < NT; ++term) {
        uint32_t x[L], c[L];
        ln.load(a.rf, regs[term], x);
        load_const<L>(a.cbank, aux + term, c);
        mac_cols<L>(cols, x, c);
      }
#pragma unroll
      for (int j = 0; j < L; ++j)
        cols[j] += __ldg(a.cbank + (long long)(aux + NT) * L + j);
      mont_reduce_cols<L>(cols, r, fc);
    }
    ln.store(a.rf, dst, r);
    ln.store(chunk_bank, em, r);
  }
}

template <int L>
__global__ void __launch_bounds__(128) interp_k1a_kernel(InterpArgs a,
                                                         FieldConsts fc) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const Lane<L> ln{b, a.B};
  // wide inputs and materialized constants into the register file
  for (int k = 0; k < a.n_win; ++k) {
    uint32_t v[L];
    ln.load(a.x_w, k, v);
    ln.store(a.rf, k, v);
  }
  for (int m = 0; m < a.n_mat; ++m) {
    uint32_t v[L];
    load_const<L>(a.mat_limbs, m, v);
    ln.store(a.rf, __ldg(a.mat_regs + m), v);
  }
  for (int c = 0; c < a.n_chunks; ++c) {
    uint32_t* chunk_bank = a.bank + (long long)c * (a.K + 1) * L * a.B;
    const int r1 = __ldg(a.rstarts + c + 1);
    for (int rr = __ldg(a.rstarts + c); rr < r1; ++rr) {
      const int s0 = __ldg(a.r_s0 + rr), s1 = __ldg(a.r_s0 + rr + 1);
      switch (__ldg(a.r_op + rr)) {
        case OP_COPYW:
          run_steps<L, OP_COPYW>(a, ln, chunk_bank, s0, s1, fc);
          break;
        case OP_MUL:
          run_steps<L, OP_MUL>(a, ln, chunk_bank, s0, s1, fc);
          break;
        case OP_MUL_R2:
          run_steps<L, OP_MUL_R2>(a, ln, chunk_bank, s0, s1, fc);
          break;
        case OP_ADD_C:
          run_steps<L, OP_ADD_C>(a, ln, chunk_bank, s0, s1, fc);
          break;
        case OP_DOT2_C:
          run_steps<L, OP_DOT2_C>(a, ln, chunk_bank, s0, s1, fc);
          break;
        case OP_DOT3_C:
          run_steps<L, OP_DOT3_C>(a, ln, chunk_bank, s0, s1, fc);
          break;
        default:
          break;  // the wrapper refuses plans with other opcodes
      }
    }
    // trailing REDC: flagged Montgomery emission rows -> canonical
    for (int r = 0; r <= a.K; ++r) {
      if (__ldg(a.mont_tab + c * (a.K + 1) + r) == 0) continue;
      uint32_t cols[2 * L + 1], v[L], out[L];
      ln.load(chunk_bank, r, v);
#pragma unroll
      for (int k = 0; k < 2 * L + 1; ++k) cols[k] = k < L ? v[k] : 0;
      mont_reduce_cols<L>(cols, out, fc);
      ln.store(chunk_bank, r, out);
    }
  }
}

}  // namespace ctpu

// Launch K1a on `stream`.  Device pointers: x_w, table, r_op, r_s0, rstarts,
// cbank, mont_tab, mat_regs, mat_limbs, rf, bank.  Host pointers: p_limbs,
// r2_limbs (L words each).  Returns the launch's cudaError_t (0 on success).
extern "C" int ctpu_interp_k1a(int L, long long B, const uint32_t* x_w,
                               int n_win, const int32_t* table,
                               const int32_t* r_op, const int32_t* r_s0,
                               const int32_t* rstarts, int n_chunks,
                               const uint32_t* cbank, const int32_t* mont_tab,
                               const int32_t* mat_regs,
                               const uint32_t* mat_limbs, int n_mat,
                               uint32_t* rf, uint32_t* bank, int K,
                               const uint32_t* p_limbs,
                               const uint32_t* r2_limbs, uint32_t n0inv,
                               void* stream) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L && i < 24; ++i) {
    fc.p[i] = p_limbs[i];
    fc.r2[i] = r2_limbs[i];
  }
  fc.n0inv = n0inv;
  ctpu::InterpArgs a = {x_w,    table,    r_op,     r_s0,      rstarts, cbank,
                        mont_tab, mat_regs, mat_limbs, rf,       bank,
                        n_win,  n_mat,    n_chunks, K,         B};
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4:
      ctpu::interp_k1a_kernel<4><<<blocks, threads, 0, s>>>(a, fc);
      break;
    case 16:
      ctpu::interp_k1a_kernel<16><<<blocks, threads, 0, s>>>(a, fc);
      break;
    case 24:
      ctpu::interp_k1a_kernel<24><<<blocks, threads, 0, s>>>(a, fc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
