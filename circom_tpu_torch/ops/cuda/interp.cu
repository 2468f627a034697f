// K1: the witness interpreter kernel, every opcode of the JAX kernel: the
// wide lane of K1a, the narrow lane of K1b, goldilocks' products (K1c) and
// the rest (K1d).
//
// Replaces the Pallas kernel of the JAX package's backend/interp.py
// (InterpreterProgram._make_kernel, launched by _exec_block): K1a's wide
// opcodes copyw, mul, mul_r2, add_c, dot2_c and dot3_c with its trailing
// REDC of the flagged emission rows (the Poseidon class); K1b's narrow
// int32 opcodes ncopy nadd nmul nband nbor nbxor nshl nshr nshru nxbit
// nmshl nmshru nrotr (the SHA256 class); K1c's goldilocks gmul, gmul_c and
// add; and K1d, the other 46 opcodes of `wbranch` and `nbranch`: the
// modular sub/csub/mul by a bank row, select, the signed comparisons and
// booleans, the masked bit ops, the limb shifts, the widening of a narrow
// value, the long division (wide), and nsub, nsel, nsel_w, nidiv, nband_w,
// lnot_n, lnot_w and the *_nn / *_ww comparisons (narrow results).  It
// executes the plan tables of backend/interp_plan.py exactly as that kernel
// does: chunks in order, the same-opcode runs rstarts[c]..rstarts[c+1] of
// each chunk, each step's result written to its destination register and
// to emission row `em` of its chunk's bank (the bank of the file the
// opcode's result lives in: narrow for nsel_w, lnot_w and the *_ww
// comparisons, which read the wide file, wide for widen, which reads the
// narrow one; row K or KN is the dump row, the last register of each file
// is trash), constant registers loaded from mat_loads and nmat_loads, and
// at the end of each chunk the wide rows flagged in mont_tab reduced out
// of Montgomery form in place.  One launch runs a plan that mixes them.
//
// Design: one thread per witness lane b, 128 threads a block.  The register
// files and the emission banks live in device memory, batch-minor: wide as
// (rows, L, B) uint32, narrow as (rows, B) int32, so a warp's reads and
// writes of one row are one coalesced line.  Every thread of the grid walks
// the same instruction stream, so each table read is a uniform broadcast
// load, and the opcode switch is taken once per run, not per step.  The
// field arithmetic is ops/cuda/field.cuh and ops/cuda/wide.cuh, step-for-
// step ports of limb_emit, and the narrow arithmetic ops/cuda/narrow.cuh,
// XLA's int32 semantics in uint32, so both banks are bit-identical to the
// JAX kernel's.  The opcodes whose operand index depends on the data or the
// count (select, the shifts, the long division) read their limbs in place
// from the register file, so they hold no more registers than K1a's dots.
//
// Bound on the card: the emission banks must be written once and the inputs
// read once; each wide mul or dot does L^2 to 4L^2 32-bit multiplies per
// lane, a narrow op one integer op, a long division ~6L per bit of p.  For
// Poseidon2/bn128 the byte and operation bounds are within a factor of two
// of each other, for SHA256 the byte bound rules (PERF.md).  The wide
// register file (14 rows for Poseidon2) stays in L2; the narrow one of
// SHA256 (1,770 rows, 7 KB a lane) does not, so K1b pays its register
// traffic in HBM.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "narrow.cuh"
#include "wide.cuh"

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
  OP_GMUL = 19,
  OP_GMUL_C = 20,
  OP_ADD = 21,
  OP_SUB = 22,
  OP_SUB_C = 23,
  OP_CSUB_C = 24,
  OP_MUL_C = 25,
  OP_MUL_ONE = 26,
  OP_SELECT = 27,
  OP_EQ = 28,
  OP_NEQ = 29,
  OP_LT = 30,
  OP_LE = 31,
  OP_GT = 32,
  OP_GE = 33,
  OP_LAND = 34,
  OP_LOR = 35,
  OP_LNOT = 36,
  OP_BAND = 37,
  OP_BOR = 38,
  OP_BXOR = 39,
  OP_BNOT = 40,
  OP_SHL_KW = 41,
  OP_SHR_KW = 42,
  OP_WIDEN = 43,
  OP_IDIV = 44,
  OP_NSUB = 45,
  OP_NSEL = 46,
  OP_NSEL_W = 47,
  OP_NIDIV = 48,
  OP_NBAND_W = 49,
  OP_LNOT_N = 50,
  OP_LNOT_W = 51,
  OP_EQ_NN = 52,
  OP_NEQ_NN = 53,
  OP_LT_NN = 54,
  OP_LE_NN = 55,
  OP_GT_NN = 56,
  OP_GE_NN = 57,
  OP_LAND_NN = 58,
  OP_LOR_NN = 59,
  OP_EQ_WW = 60,
  OP_NEQ_WW = 61,
  OP_LT_WW = 62,
  OP_LE_WW = 63,
  OP_GT_WW = 64,
  OP_GE_WW = 65,
  OP_LAND_WW = 66,
  OP_LOR_WW = 67,
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
  // limb 0 of register `row` of this lane; limb i is at [i * B]
  __device__ __forceinline__ const uint32_t* ptr(const uint32_t* base,
                                                 long long row) const {
    return base + row * L * B + b;
  }
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

// One run of steps s0..s1 of opcode OP, whose result is wide.
template <int L, int OP>
__device__ __forceinline__ void run_steps(const InterpArgs& a,
                                          const Lane<L>& ln,
                                          uint32_t* chunk_bank, int s0,
                                          int s1, const FieldConsts& fc,
                                          const WideConsts& wc) {
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
    } else if constexpr (OP == OP_GMUL || OP == OP_GMUL_C) {
      if constexpr (L == 4) {
        uint32_t x[4], y[4];
        ln.load(a.rf, ia, x);
        if (OP == OP_GMUL)
          ln.load(a.rf, ib, y);
        else
          load_const<4>(a.cbank, ib, y);
        gl_mul(x, y, r, fc);
      } else {
#pragma unroll
        for (int i = 0; i < L; ++i) r[i] = 0;  // goldilocks only (wrapper)
      }
    } else if constexpr (OP == OP_ADD || OP == OP_SUB || OP == OP_SUB_C ||
                         OP == OP_CSUB_C) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      if (OP == OP_ADD || OP == OP_SUB)
        ln.load(a.rf, ib, y);
      else
        load_const<L>(a.cbank, ib, y);
      if (OP == OP_ADD)
        mod_add<L>(x, y, r, fc);
      else if (OP == OP_CSUB_C)
        mod_sub<L>(y, x, r, fc);  // bank row minus register
      else
        mod_sub<L>(x, y, r, fc);
    } else if constexpr (OP == OP_MUL_C || OP == OP_MUL_ONE) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      if (OP == OP_MUL_C) {
        load_const<L>(a.cbank, ib, y);
      } else {
#pragma unroll
        for (int i = 0; i < L; ++i) y[i] = i == 0;
      }
      mont_mul<L>(x, y, r, fc);
    } else if constexpr (OP == OP_SELECT) {
      uint32_t x[L];
      ln.load(a.rf, ia, x);
      ln.load(a.rf, nonzero<L>(x) ? ib : ic, r);
    } else if constexpr (OP >= OP_EQ && OP <= OP_LOR) {
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      ln.load(a.rf, ib, y);
#pragma unroll
      for (int i = 1; i < L; ++i) r[i] = 0;
      r[0] = cmp_wide<L, OP - OP_EQ>(x, y, wc);
    } else if constexpr (OP == OP_LNOT) {
      uint32_t x[L];
      ln.load(a.rf, ia, x);
#pragma unroll
      for (int i = 1; i < L; ++i) r[i] = 0;
      r[0] = !nonzero<L>(x);
    } else if constexpr (OP == OP_BAND || OP == OP_BOR || OP == OP_BXOR) {
      uint32_t y[L];
      ln.load(a.rf, ia, r);
      ln.load(a.rf, ib, y);
#pragma unroll
      for (int i = 0; i < L; ++i)
        r[i] = OP == OP_BAND ? r[i] & y[i]
               : OP == OP_BOR ? r[i] | y[i] : r[i] ^ y[i];
      if (OP != OP_BAND) cond_sub<L>(r, 0, fc);
    } else if constexpr (OP == OP_BNOT) {
      ln.load(a.rf, ia, r);
#pragma unroll
      for (int i = 0; i < L; ++i) r[i] ^= wc.mask[i];
      cond_sub<L>(r, 0, fc);
    } else if constexpr (OP == OP_SHL_KW || OP == OP_SHR_KW) {
      shift_w<L, OP == OP_SHL_KW>(ln.ptr(a.rf, ia), ln.B, aux, r, fc, wc);
    } else if constexpr (OP == OP_WIDEN) {
      widen<L>(a.rf_n[ia * ln.B + ln.b], r, wc);
    } else if constexpr (OP == OP_IDIV) {
      uint32_t y[L];
      ln.load(a.rf, ib, y);
      idiv<L>(ln.ptr(a.rf, ia), ln.B, y, r, wc);
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
  else if constexpr (OP == OP_NROTR) r = nrotr32(ux, us);
  else if constexpr (OP == OP_NSUB) r = ux - uy;
  else if constexpr (OP == OP_NIDIV) r = (uint32_t)nidiv32(x, y);
  else if constexpr (OP == OP_LNOT_N) r = x == 0;
  else if constexpr (OP == OP_EQ_NN) r = x == y;
  else if constexpr (OP == OP_NEQ_NN) r = x != y;
  else if constexpr (OP == OP_LT_NN) r = x < y;
  else if constexpr (OP == OP_LE_NN) r = x <= y;
  else if constexpr (OP == OP_GT_NN) r = x > y;
  else if constexpr (OP == OP_GE_NN) r = x >= y;
  else if constexpr (OP == OP_LAND_NN) r = x != 0 && y != 0;
  else r = x != 0 || y != 0;  // OP_LOR_NN
  return (int32_t)r;
}

// One run of steps s0..s1 of opcode OP, whose result is narrow: read the
// operands of the opcode's files (rf_n, or rf for nsel_w, nband_w, lnot_w
// and the *_ww comparisons), write rf_n[dst] and narrow bank row em of
// this chunk.
template <int L, int OP>
__device__ __forceinline__ void run_narrow(const InterpArgs& a,
                                           const Lane<L>& ln,
                                           int32_t* chunk_bank_n, int s0,
                                           int s1, const WideConsts& wc) {
  // narrow_op's opcodes, and those of them with a second operand
  constexpr bool SCALAR = OP <= OP_NROTR || OP == OP_NSUB ||
                          OP == OP_NIDIV || OP == OP_LNOT_N ||
                          (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  constexpr bool TWO = OP == OP_NADD || OP == OP_NMUL || OP == OP_NBAND ||
                       OP == OP_NBOR || OP == OP_NBXOR || OP == OP_NMSHL ||
                       OP == OP_NMSHRU || OP == OP_NSUB || OP == OP_NIDIV ||
                       (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  const long long B = a.B, b = ln.b;
  for (int t = s0; t < s1; ++t) {
    const int32_t* row = a.table + (long long)t * 7;
    const int ia = __ldg(row + 1), dst = __ldg(row + 4);
    const int em = __ldg(row + 5), aux = __ldg(row + 6);
    int32_t r;
    if constexpr (SCALAR) {
      const int32_t x = a.rf_n[ia * B + b];
      const int32_t y = TWO ? a.rf_n[__ldg(row + 2) * B + b] : 0;
      r = narrow_op<OP>(x, y, aux);
    } else if constexpr (OP == OP_NSEL) {
      const int pick = a.rf_n[ia * B + b] != 0 ? __ldg(row + 2)
                                               : __ldg(row + 3);
      r = a.rf_n[pick * B + b];
    } else if constexpr (OP == OP_NSEL_W) {
      uint32_t x[L];
      ln.load(a.rf, ia, x);
      r = a.rf_n[(nonzero<L>(x) ? __ldg(row + 2) : __ldg(row + 3)) * B + b];
    } else if constexpr (OP == OP_NBAND_W) {
      // limbs 0 and 1 ANDed with bank row aux, packed into an int32
      const uint32_t* xr = ln.ptr(a.rf, ia);
      const uint32_t* c = a.cbank + (long long)aux * L;
      r = (int32_t)((xr[0] & __ldg(c)) |
                    ((xr[B] & __ldg(c + 1)) << LIMB_BITS));
    } else if constexpr (OP == OP_LNOT_W) {
      uint32_t x[L];
      ln.load(a.rf, ia, x);
      r = !nonzero<L>(x);
    } else {
      // *_ww: the wide comparison, whose 0/1 result is limb 0
      uint32_t x[L], y[L];
      ln.load(a.rf, ia, x);
      ln.load(a.rf, __ldg(row + 2), y);
      r = cmp_wide<L, OP - OP_EQ_WW>(x, y, wc);
    }
    a.rf_n[dst * B + b] = r;
    chunk_bank_n[em * B + b] = r;
  }
}

// The cases of the run switch: K1a's and K1b's opcodes, then K1c's and
// K1d's.
#define K1AB_CASES \
  WIDE(OP_COPYW) \
  WIDE(OP_MUL) \
  WIDE(OP_MUL_R2) \
  WIDE(OP_ADD_C) \
  WIDE(OP_DOT2_C) \
  WIDE(OP_DOT3_C) \
  NARROW(OP_NCOPY) \
  NARROW(OP_NADD) \
  NARROW(OP_NMUL) \
  NARROW(OP_NBAND) \
  NARROW(OP_NBOR) \
  NARROW(OP_NBXOR) \
  NARROW(OP_NSHL) \
  NARROW(OP_NSHR) \
  NARROW(OP_NSHRU) \
  NARROW(OP_NXBIT) \
  NARROW(OP_NMSHL) \
  NARROW(OP_NMSHRU) \
  NARROW(OP_NROTR)
#define K1CD_CASES \
  WIDE(OP_GMUL) \
  WIDE(OP_GMUL_C) \
  WIDE(OP_ADD) \
  WIDE(OP_SUB) \
  WIDE(OP_SUB_C) \
  WIDE(OP_CSUB_C) \
  WIDE(OP_MUL_C) \
  WIDE(OP_MUL_ONE) \
  WIDE(OP_SELECT) \
  WIDE(OP_EQ) \
  WIDE(OP_NEQ) \
  WIDE(OP_LT) \
  WIDE(OP_LE) \
  WIDE(OP_GT) \
  WIDE(OP_GE) \
  WIDE(OP_LAND) \
  WIDE(OP_LOR) \
  WIDE(OP_LNOT) \
  WIDE(OP_BAND) \
  WIDE(OP_BOR) \
  WIDE(OP_BXOR) \
  WIDE(OP_BNOT) \
  WIDE(OP_SHL_KW) \
  WIDE(OP_SHR_KW) \
  WIDE(OP_WIDEN) \
  WIDE(OP_IDIV) \
  NARROW(OP_NSUB) \
  NARROW(OP_NSEL) \
  NARROW(OP_NSEL_W) \
  NARROW(OP_NIDIV) \
  NARROW(OP_NBAND_W) \
  NARROW(OP_LNOT_N) \
  NARROW(OP_LNOT_W) \
  NARROW(OP_EQ_NN) \
  NARROW(OP_NEQ_NN) \
  NARROW(OP_LT_NN) \
  NARROW(OP_LE_NN) \
  NARROW(OP_GT_NN) \
  NARROW(OP_GE_NN) \
  NARROW(OP_LAND_NN) \
  NARROW(OP_LOR_NN) \
  NARROW(OP_EQ_WW) \
  NARROW(OP_NEQ_WW) \
  NARROW(OP_LT_WW) \
  NARROW(OP_LE_WW) \
  NARROW(OP_GT_WW) \
  NARROW(OP_GE_WW) \
  NARROW(OP_LAND_WW) \
  NARROW(OP_LOR_WW)

// FULL = false instantiates the switch of K1a's and K1b's opcodes only: the
// kernel for plans without K1c/K1d opcodes (Poseidon2/bn128, SHA256) keeps
// the compact code of the earlier kernel, so their hot loops do not pay
// for 49 more cases (K1a measured about 3 % slower with them).
template <int L, bool FULL>
__global__ void __launch_bounds__(128) interp_k1_kernel(InterpArgs a,
                                                        FieldConsts fc,
                                                        WideConsts wc) {
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
      const int op = __ldg(a.r_op + rr);
#define WIDE(OPC)                                             \
  case OPC:                                                   \
    run_steps<L, OPC>(a, ln, chunk_bank, s0, s1, fc, wc);     \
    break;
#define NARROW(OPC)                                           \
  case OPC:                                                   \
    run_narrow<L, OPC>(a, ln, chunk_bank_n, s0, s1, wc);      \
    break;
      // the wrapper picks FULL from the plan's opcodes and refuses plans
      // with opcodes outside OPCODES, so `default` is never taken
      if constexpr (FULL) {
        switch (op) {
          K1AB_CASES
          K1CD_CASES
          default:
            break;
        }
      } else {
        switch (op) {
          K1AB_CASES
          default:
            break;
        }
      }
#undef WIDE
#undef NARROW
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
// bank, rf_n, bank_n (each register file has at least its trash row).
// Host pointers: p_limbs, r2_limbs, half_limbs, mask_limbs, q_limbs (L
// words each).  L is 4 (goldilocks) or 16 (the 256-bit primes); full is
// nonzero when the plan runs K1c or K1d opcodes.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ctpu_interp_k1(
    int L, long long B, const uint32_t* x_w, int n_win, const int32_t* x_n,
    int n_nin, const int32_t* table, const int32_t* r_op,
    const int32_t* r_s0, const int32_t* rstarts, int n_chunks,
    const uint32_t* cbank, const int32_t* mont_tab, const int32_t* mat_regs,
    const uint32_t* mat_limbs, int n_mat, const int32_t* nmat_regs,
    const int32_t* nmat_vals, int n_nmat, uint32_t* rf, uint32_t* bank,
    int K, int32_t* rf_n, int32_t* bank_n, int KN, const uint32_t* p_limbs,
    const uint32_t* r2_limbs, uint32_t n0inv, const uint32_t* half_limbs,
    const uint32_t* mask_limbs, const uint32_t* q_limbs, int bits, int full,
    void* stream) {
  if (L != 4 && L != 16) return (int)cudaErrorInvalidValue;
  ctpu::FieldConsts fc = {};
  ctpu::WideConsts wc = {};
  for (int i = 0; i < L; ++i) {
    fc.p[i] = p_limbs[i];
    fc.r2[i] = r2_limbs[i];
    wc.half[i] = half_limbs[i];
    wc.mask[i] = mask_limbs[i];
    wc.q[i] = q_limbs[i];
  }
  fc.n0inv = n0inv;
  wc.bits = bits;
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
  if (L == 4)  // goldilocks: one instantiation (its code is small)
    ctpu::interp_k1_kernel<4, true><<<blocks, threads, 0, s>>>(a, fc, wc);
  else if (full)
    ctpu::interp_k1_kernel<16, true><<<blocks, threads, 0, s>>>(a, fc, wc);
  else
    ctpu::interp_k1_kernel<16, false><<<blocks, threads, 0, s>>>(a, fc, wc);
  return (int)cudaGetLastError();
}
