// K1: the witness interpreter kernel, wide lane (K1a) and narrow lane (K1b).
//
// Replaces the Pallas kernel of the JAX package's backend/interp.py
// (InterpreterProgram._make_kernel, launched by _exec_block) for the wide
// opcodes copyw, mul, mul_r2, add_c, dot2_c and dot3_c, with its trailing
// REDC of the flagged emission rows (K1a, the Poseidon class), and for the
// narrow int32 opcodes ncopy nadd nmul nband nbor nbxor nshl nshr nshru
// nxbit nmshl nmshru nrotr (K1b, the SHA256 class).  It executes the plan
// tables of backend/interp_plan.py exactly as that kernel does: chunks in
// order, the same-opcode runs rstarts[c]..rstarts[c+1] of each chunk, each
// step's result written to its destination register and to emission row
// `em` of its chunk's bank (the wide bank for a wide op, the narrow bank for
// a narrow one; row K or KN is the dump row, the last register of each file
// is trash), constant registers loaded from mat_loads and nmat_loads, and at
// the end of each chunk the wide rows flagged in mont_tab reduced out of
// Montgomery form in place.  One launch runs a plan that mixes both lanes.
//
// Design: one thread per witness lane b, 128 threads a block.  The register
// files and the emission banks live in device memory, batch-minor: wide as
// (rows, L, B) uint32, narrow as (rows, B) int32, so a warp's reads and
// writes of one row are one coalesced line.  Every thread of the grid walks
// the same instruction stream, so each table read is a uniform broadcast
// load, and the opcode switch is taken once per run, not per step.  The
// field arithmetic is ops/cuda/field.cuh, a step-for-step port of
// limb_emit, and the narrow arithmetic ops/cuda/narrow.cuh, XLA's int32
// semantics in uint32, so both banks are bit-identical to the JAX kernel's.
//
// Bound on the card: the emission banks must be written once and the inputs
// read once; each wide mul or dot does L^2 to 4L^2 32-bit multiplies per
// lane, a narrow op one integer op.  For Poseidon2/bn128 the byte and
// operation bounds are within a factor of two of each other, for SHA256
// the byte bound rules (PERF.md).  The wide register file (14 rows for
// Poseidon2) stays in L2; the narrow one of SHA256 (1,770 rows, 7 KB a
// lane) does not, so K1b pays its register traffic in HBM.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "narrow.cuh"

namespace ctpu {

// Opcode numbering of the kernel: must match OPCODES in convert.py.
enum Op {
  OP_COPYW = 0,
  OP_MUL = 1,
  OP_MUL_R2 = 2,
  OP_ADD_C = 3,
  OP_DOT2_C = 4,
  OP_DOT3_C = 5,
  OP_NCOPY = 6,
  OP_NADD = 7,
  OP_NMUL = 8,
  OP_NBAND = 9,
  OP_NBOR = 10,
  OP_NBXOR = 11,
  OP_NSHL = 12,
  OP_NSHR = 13,
  OP_NSHRU = 14,
  OP_NXBIT = 15,
  OP_NMSHL = 16,
  OP_NMSHRU = 17,
  OP_NROTR = 18,
};

struct InterpArgs {
  const uint32_t* x_w;      // (n_win, L, B) wide inputs
  const int32_t* x_n;       // (n_nin, B) narrow inputs
  const int32_t* table;     // (n_steps, 7): op ia ib ic dst em aux
  const int32_t* r_op;      // per run: opcode
  const int32_t* r_s0;      // per run: first step (n_runs + 1 entries)
  const int32_t* rstarts;   // per chunk: first run (n_chunks + 1 entries)
  const uint32_t* cbank;    // (n_bank, L) constant bank
  const int32_t* mont_tab;  // (n_chunks * (K + 1)) trailing-REDC flags
  const int32_t* mat_regs;  // (n_mat) register of each materialized const
  const uint32_t* mat_limbs;  // (n_mat, L)
  const int32_t* nmat_regs;   // (n_nmat) narrow register of each constant
  const int32_t* nmat_vals;   // (n_nmat)
  uint32_t* rf;             // (n_regs, L, B) wide register file (scratch)
  uint32_t* bank;           // (n_chunks * (K + 1), L, B) wide emission bank
  int32_t* rf_n;            // (n_nregs, B) narrow register file (scratch)
  int32_t* bank_n;          // (n_chunks * (KN + 1), B) narrow emission bank
  int n_win, n_nin, n_mat, n_nmat, n_chunks, K, KN;
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

// One run of steps s0..s1 of wide opcode OP.
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

// One narrow op on the operands' values x and y; s is the table's
// immediate (column 6), the shift count.
template <int OP>
__device__ __forceinline__ int32_t narrow_op(int32_t x, int32_t y,
                                             int32_t s) {
  const uint32_t ux = (uint32_t)x, uy = (uint32_t)y, us = (uint32_t)s;
  uint32_t r;
  if constexpr (OP == OP_NCOPY) r = ux;
  else if constexpr (OP == OP_NADD) r = ux + uy;
  else if constexpr (OP == OP_NMUL) r = ux * uy;
  else if constexpr (OP == OP_NBAND) r = ux & uy;
  else if constexpr (OP == OP_NBOR) r = ux | uy;
  else if constexpr (OP == OP_NBXOR) r = ux ^ uy;
  else if constexpr (OP == OP_NSHL) r = nshl32(ux, us);
  else if constexpr (OP == OP_NSHR) r = (uint32_t)nshra32(x, us);
  else if constexpr (OP == OP_NSHRU) r = nshru32(ux, us);
  else if constexpr (OP == OP_NXBIT) r = nshru32(ux, us) & 1u;
  else if constexpr (OP == OP_NMSHL) r = nshl32(ux & uy, us);
  else if constexpr (OP == OP_NMSHRU) r = nshru32(ux & uy, us);
  else r = nrotr32(ux, us);  // OP_NROTR
  return (int32_t)r;
}

// One run of steps s0..s1 of narrow opcode OP: read rf_n[ia] (and rf_n[ib]
// for the ops with a second operand), write rf_n[dst] and narrow bank row
// em of this chunk.
template <int OP>
__device__ __forceinline__ void run_narrow(const InterpArgs& a, long long b,
                                           int32_t* chunk_bank_n, int s0,
                                           int s1) {
  constexpr bool TWO = OP == OP_NADD || OP == OP_NMUL || OP == OP_NBAND ||
                       OP == OP_NBOR || OP == OP_NBXOR || OP == OP_NMSHL ||
                       OP == OP_NMSHRU;
  const long long B = a.B;
  for (int t = s0; t < s1; ++t) {
    const int32_t* row = a.table + (long long)t * 7;
    const int ia = __ldg(row + 1), dst = __ldg(row + 4);
    const int em = __ldg(row + 5), aux = __ldg(row + 6);
    const int32_t x = a.rf_n[ia * B + b];
    const int32_t y = TWO ? a.rf_n[__ldg(row + 2) * B + b] : 0;
    const int32_t r = narrow_op<OP>(x, y, aux);
    a.rf_n[dst * B + b] = r;
    chunk_bank_n[em * B + b] = r;
  }
}

template <int L>
__global__ void __launch_bounds__(128) interp_k1_kernel(InterpArgs a,
                                                        FieldConsts fc) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const Lane<L> ln{b, a.B};
  // inputs and materialized constants into the register files
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
  for (int k = 0; k < a.n_nin; ++k) a.rf_n[k * a.B + b] = a.x_n[k * a.B + b];
  for (int m = 0; m < a.n_nmat; ++m)
    a.rf_n[__ldg(a.nmat_regs + m) * a.B + b] = __ldg(a.nmat_vals + m);
  for (int c = 0; c < a.n_chunks; ++c) {
    uint32_t* chunk_bank = a.bank + (long long)c * (a.K + 1) * L * a.B;
    int32_t* chunk_bank_n = a.bank_n + (long long)c * (a.KN + 1) * a.B;
    const int r1 = __ldg(a.rstarts + c + 1);
    for (int rr = __ldg(a.rstarts + c); rr < r1; ++rr) {
      const int s0 = __ldg(a.r_s0 + rr), s1 = __ldg(a.r_s0 + rr + 1);
      switch (__ldg(a.r_op + rr)) {
#define WIDE(OPC)                                             \
  case OPC:                                                   \
    run_steps<L, OPC>(a, ln, chunk_bank, s0, s1, fc);         \
    break;
#define NARROW(OPC)                                           \
  case OPC:                                                   \
    run_narrow<OPC>(a, b, chunk_bank_n, s0, s1);              \
    break;
        WIDE(OP_COPYW)
        WIDE(OP_MUL)
        WIDE(OP_MUL_R2)
        WIDE(OP_ADD_C)
        WIDE(OP_DOT2_C)
        WIDE(OP_DOT3_C)
        NARROW(OP_NCOPY)
        NARROW(OP_NADD)
        NARROW(OP_NMUL)
        NARROW(OP_NBAND)
        NARROW(OP_NBOR)
        NARROW(OP_NBXOR)
        NARROW(OP_NSHL)
        NARROW(OP_NSHR)
        NARROW(OP_NSHRU)
        NARROW(OP_NXBIT)
        NARROW(OP_NMSHL)
        NARROW(OP_NMSHRU)
        NARROW(OP_NROTR)
#undef WIDE
#undef NARROW
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

// Launch K1 on `stream`.  Device pointers: x_w, x_n, table, r_op, r_s0,
// rstarts, cbank, mont_tab, mat_regs, mat_limbs, nmat_regs, nmat_vals, rf,
// bank, rf_n, bank_n (rf and rf_n may be null for a plan that runs no
// step of that lane and loads nothing into it).  Host pointers: p_limbs,
// r2_limbs (L words each).  Returns the launch's cudaError_t (0 on success).
extern "C" int ctpu_interp_k1(
    int L, long long B, const uint32_t* x_w, int n_win, const int32_t* x_n,
    int n_nin, const int32_t* table, const int32_t* r_op,
    const int32_t* r_s0, const int32_t* rstarts, int n_chunks,
    const uint32_t* cbank, const int32_t* mont_tab, const int32_t* mat_regs,
    const uint32_t* mat_limbs, int n_mat, const int32_t* nmat_regs,
    const int32_t* nmat_vals, int n_nmat, uint32_t* rf, uint32_t* bank,
    int K, int32_t* rf_n, int32_t* bank_n, int KN, const uint32_t* p_limbs,
    const uint32_t* r2_limbs, uint32_t n0inv, void* stream) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L && i < 24; ++i) {
    fc.p[i] = p_limbs[i];
    fc.r2[i] = r2_limbs[i];
  }
  fc.n0inv = n0inv;
  ctpu::InterpArgs a = {};
  a.x_w = x_w;
  a.x_n = x_n;
  a.table = table;
  a.r_op = r_op;
  a.r_s0 = r_s0;
  a.rstarts = rstarts;
  a.cbank = cbank;
  a.mont_tab = mont_tab;
  a.mat_regs = mat_regs;
  a.mat_limbs = mat_limbs;
  a.nmat_regs = nmat_regs;
  a.nmat_vals = nmat_vals;
  a.rf = rf;
  a.bank = bank;
  a.rf_n = rf_n;
  a.bank_n = bank_n;
  a.n_win = n_win;
  a.n_nin = n_nin;
  a.n_mat = n_mat;
  a.n_nmat = n_nmat;
  a.n_chunks = n_chunks;
  a.K = K;
  a.KN = KN;
  a.B = B;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 4:
      ctpu::interp_k1_kernel<4><<<blocks, threads, 0, s>>>(a, fc);
      break;
    case 16:
      ctpu::interp_k1_kernel<16><<<blocks, threads, 0, s>>>(a, fc);
      break;
    case 24:
      ctpu::interp_k1_kernel<24><<<blocks, threads, 0, s>>>(a, fc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
