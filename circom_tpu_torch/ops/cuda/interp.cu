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
// load, and the opcode switch is taken once per run, not per step.
//
// Bound on the card.  The emission banks must be written once and the
// inputs read once; for Poseidon2/bn128 the byte and operation bounds are
// within a factor of two of each other, for SHA256 the byte bound rules
// (PERF.md).  What the design does about it:
// - K1a's products, dots and trailing REDC, and mul_c and mul_one, compute
//   in 32-bit words (field32.cuh, dot32.cuh): 16-bit limbs packed in pairs
//   on load, 32x32->64-bit products, unpacked on store.  A mul takes 2
//   (L/2)^2 wide products, a dot of n terms (n + 1) (L/2)^2, a REDC
//   (L/2)^2, about a quarter of the integer instructions of the 16-bit
//   steps of field.cuh, whose bits they equal (dot32.cuh).  On an H100
//   80GB HBM3 at 700 W, Poseidon2/bn128's plan at 65,536 lanes (99,200
//   wide products a lane) runs in ~2.5 ms where the 16-bit steps, bound by
//   those instructions, took ~9.5 ms.  K1c and K1d keep the 16-bit steps
//   (ops/cuda/field.cuh, wide.cuh, XLA's int32 semantics in narrow.cuh),
//   so both banks are bit-identical to the JAX kernel's.  The opcodes
//   whose operand index depends on the data or the count (select, the
//   shifts, the long division) read their limbs in place from the file.
// - The compact instantiation (K1a's and K1b's opcodes only) holds the
//   wide register file as packed words, (rows, L/2, B): half the bytes of
//   each register read and write (Poseidon2's 14 rows at 65,536 lanes: 29
//   MB, inside the 50 MB L2; ~19 % faster than the 16-bit limb file).  The
//   emission banks keep the 16-bit limbs, which the gathers and the JAX
//   package's layout read.
// - No step stores the dump row (K, KN) of its bank: nothing reads it.
//   Most SHA256 steps emit nothing (9,697 of 11,675).
// - The narrow constants are copied into every lane's file at the start,
//   as the inputs are.  Reading them from nmat_vals through a per-step
//   table of constant operands instead was ~14 % slower on SHA256's plan:
//   the rows it saves are L2 hits, and the table read lengthens each step.
// - The narrow lane waits on its register file: SHA256's (1,770 rows, 7 KB
//   a lane) does not fit in L2, and a step cannot read before the step
//   before it has stored.  So a narrow run is read in groups of up to
//   NGROUP steps that do not depend on each other (convert.DevicePlan.grp):
//   a group's loads are in flight together.  A group runs in 1, 2, 4 or
//   NGROUP slots: one predicated NGROUP-slot loop for every group took 96
//   registers, not 80, and was ~1.5x slower on SHA256's plan.
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field.cuh"
#include "field32.cuh"
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
  const int32_t* grp;       // (n_steps): length of a narrow step group
  const int32_t* r_op;      // per run: opcode
  const int32_t* r_s0;      // per run: first step (n_runs + 1 entries)
  const int32_t* rstarts;   // per chunk: first run (n_chunks + 1 entries)
  const uint32_t* cbank;    // (n_bank, L) constant bank
  const uint32_t* cbank_w;  // (n_bank, L/2) the same, in 32-bit words
  const int32_t* mont_tab;  // (n_chunks * (K + 1)) trailing-REDC flags
  const int32_t* mat_regs;  // (n_mat) register of each materialized const
  const uint32_t* mat_limbs;  // (n_mat, L)
  const int32_t* nmat_vals;   // (n_nmat) narrow constants
  const int32_t* nmat_regs;   // (n_nmat) register of each narrow constant
  int n_nmat;
  uint32_t* rf;             // wide register file (scratch): (n_regs, L, B),
                            // or (n_regs, L/2, B) words when packed
  uint32_t* bank;           // (n_chunks * (K + 1), L, B) wide emission bank
  int32_t* rf_n;            // (n_nregs, B) narrow register file (scratch)
  int32_t* bank_n;          // (n_chunks * (KN + 1), B) narrow emission bank
  int n_win, n_nin, n_mat, n_chunks, K, KN;
  long long B;
};

// The most narrow steps a group holds: convert.K1B_GROUP, which
// ops/build.py passes as -DCTPU_K1B_GROUP.
#ifndef CTPU_K1B_GROUP
#error "build with -DCTPU_K1B_GROUP=<convert.K1B_GROUP> (ops/build.py)"
#endif
constexpr int NGROUP = CTPU_K1B_GROUP;

template <int L>
struct Lane {
  long long b, B;
  // limb 0 of register `row` of this lane; limb i is at [i * B]
  __device__ __forceinline__ const uint32_t* ptr(const uint32_t* base,
                                                 long long row) const {
    return base + row * L * B + b;
  }
  __device__ __forceinline__ uint32_t* at(uint32_t* base,
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

// Register `row` of the wide file as N = L/2 words: as held in a packed
// file (WORDS), else packed from its 16-bit limbs.
template <int L, bool WORDS>
__device__ __forceinline__ void load32(const InterpArgs& a,
                                       const Lane<L>& ln, int row,
                                       uint32_t (&x)[L / 2]) {
  if constexpr (WORDS) {
    const uint32_t* p = a.rf + (long long)row * (L / 2) * ln.B + ln.b;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) x[i] = p[i * ln.B];
  } else {
    pack32<L>(ln.ptr(a.rf, row), ln.B, x);
  }
}

// A result in words to register dst and, unless em is the dump row K,
// to emission row em of the chunk's bank (16-bit limbs).
template <int L, bool WORDS>
__device__ __forceinline__ void store32(const InterpArgs& a,
                                        const Lane<L>& ln,
                                        uint32_t* chunk_bank, int dst,
                                        int em, const uint32_t (&w)[L / 2]) {
  if constexpr (WORDS) {
    uint32_t* p = a.rf + (long long)dst * (L / 2) * ln.B + ln.b;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) p[i * ln.B] = w[i];
    if (em != a.K) unpack32<L>(w, ln.at(chunk_bank, em), ln.B);
  } else {
    uint32_t r[L];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      r[2 * i] = w[i] & MASK;
      r[2 * i + 1] = w[i] >> LIMB_BITS;
    }
    ln.store(a.rf, dst, r);
    if (em != a.K) ln.store(chunk_bank, em, r);
  }
}

template <int L>
__device__ __forceinline__ void load_const32(const uint32_t* cbank_w,
                                             int row,
                                             uint32_t (&v)[L / 2]) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i)
    v[i] = __ldg(cbank_w + (long long)row * (L / 2) + i);
}

// Narrow register `reg` of lane b.
__device__ __forceinline__ int32_t nreg(const InterpArgs& a, int reg,
                                        long long b) {
  return a.rf_n[reg * a.B + b];
}

// One run of steps s0..s1 of opcode OP, whose result is wide.  WORDS: the
// wide file is packed (the compact instantiation, K1a's opcodes only).
template <int L, int OP, bool WORDS>
__device__ __forceinline__ void run_steps(const InterpArgs& a,
                                          const Lane<L>& ln,
                                          uint32_t* chunk_bank, int s0,
                                          int s1, const FieldConsts& fc,
                                          const WideConsts& wc,
                                          const uint32_t (&pw)[L / 2]) {
  constexpr int N = L / 2;
  // opcodes computed in 32-bit words; the others (K1c, K1d) on the 16-bit
  // limbs of the limb file
  constexpr bool IN_WORDS =
      OP == OP_COPYW || OP == OP_MUL || OP == OP_MUL_R2 || OP == OP_ADD_C ||
      OP == OP_DOT2_C || OP == OP_DOT3_C || OP == OP_MUL_C ||
      OP == OP_MUL_ONE;
  static_assert(IN_WORDS || !WORDS, "a packed file runs K1a's opcodes only");
  for (int t = s0; t < s1; ++t) {
    const int32_t* row = a.table + (long long)t * 7;
    const int ia = __ldg(row + 1), ib = __ldg(row + 2), ic = __ldg(row + 3);
    const int dst = __ldg(row + 4), em = __ldg(row + 5), aux = __ldg(row + 6);
    if constexpr (IN_WORDS) {
      uint32_t w[N];
      if constexpr (OP == OP_COPYW) {
        load32<L, WORDS>(a, ln, ia, w);
      } else if constexpr (OP == OP_ADD_C) {
        uint32_t x[N], c[N];
        load32<L, WORDS>(a, ln, ia, x);
        load_const32<L>(a.cbank_w, ib, c);
        mod_add32<N>(x, c, pw, w);
      } else if constexpr (OP == OP_DOT2_C || OP == OP_DOT3_C) {
        // dot2_c / dot3_c: bank rows aux..aux+n-1 hold the coefficients,
        // row aux+n an additive constant; accumulate every product into
        // one 2N + 1 word sum and reduce once (lazy reduction)
        constexpr int NT = (OP == OP_DOT3_C) ? 3 : 2;
        uint32_t acc[2 * N + 1];
#pragma unroll
        for (int k = 0; k < 2 * N + 1; ++k) acc[k] = 0;
        const int regs[3] = {ia, ib, ic};
#pragma unroll
        for (int term = 0; term < NT; ++term) {
          uint32_t x[N], c[N];
          load32<L, WORDS>(a, ln, regs[term], x);
          load_const32<L>(a.cbank_w, aux + term, c);
          mac32<N>(acc, x, c);
        }
        uint32_t k[N];
        load_const32<L>(a.cbank_w, aux + NT, k);
        add_low32<N>(acc, k);
        mont_reduce32<N>(acc, pw, fc.n0inv32, w);
      } else {
        // the Montgomery products: by a register, R^2, a bank row, 1
        uint32_t x[N], y[N];
        load32<L, WORDS>(a, ln, ia, x);
        if constexpr (OP == OP_MUL) {
          load32<L, WORDS>(a, ln, ib, y);
        } else if constexpr (OP == OP_MUL_C) {
          load_const32<L>(a.cbank_w, ib, y);
        } else if constexpr (OP == OP_MUL_R2) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            y[i] = fc.r2[2 * i] | (fc.r2[2 * i + 1] << LIMB_BITS);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) y[i] = i == 0;
        }
        mont_mul32<N>(x, y, pw, fc.n0inv32, w);
      }
      store32<L, WORDS>(a, ln, chunk_bank, dst, em, w);
    } else {
      uint32_t r[L];
      if constexpr (OP == OP_GMUL || OP == OP_GMUL_C) {
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
        widen<L>(nreg(a, ia, ln.b), r, wc);
      } else {
        // OP_IDIV
        uint32_t y[L];
        ln.load(a.rf, ib, y);
        idiv<L>(ln.ptr(a.rf, ia), ln.B, y, r, wc);
      }
      ln.store(a.rf, dst, r);
      if (em != a.K) ln.store(chunk_bank, em, r);
    }
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

// The value of step t, an opcode whose result is narrow: read the
// operands of the opcode's files (rf_n, or rf for
// nsel_w, nband_w, lnot_w and the *_ww comparisons) and compute.  The wide
// operands are read from the 16-bit limb file: these opcodes are K1d's, so
// only the FULL instantiation runs them.
template <int L, int OP>
__device__ __forceinline__ int32_t narrow_value(const InterpArgs& a,
                                                const Lane<L>& ln, int t,
                                                const WideConsts& wc) {
  // narrow_op's opcodes, and those of them with a second operand
  constexpr bool SCALAR = OP <= OP_NROTR || OP == OP_NSUB ||
                          OP == OP_NIDIV || OP == OP_LNOT_N ||
                          (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  constexpr bool TWO = OP == OP_NADD || OP == OP_NMUL || OP == OP_NBAND ||
                       OP == OP_NBOR || OP == OP_NBXOR || OP == OP_NMSHL ||
                       OP == OP_NMSHRU || OP == OP_NSUB || OP == OP_NIDIV ||
                       (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  const long long B = a.B, b = ln.b;
  const int32_t* row = a.table + (long long)t * 7;
  const int ia = __ldg(row + 1), aux = __ldg(row + 6);
  if constexpr (SCALAR) {
    const int32_t x = nreg(a, ia, b);
    const int32_t y = TWO ? nreg(a, __ldg(row + 2), b) : 0;
    return narrow_op<OP>(x, y, aux);
  } else if constexpr (OP == OP_NSEL) {
    const int j = nreg(a, ia, b) != 0 ? 1 : 2;
    return nreg(a, __ldg(row + 1 + j), b);
  } else if constexpr (OP == OP_NSEL_W) {
    uint32_t x[L];
    ln.load(a.rf, ia, x);
    const int j = nonzero<L>(x) ? 1 : 2;
    return nreg(a, __ldg(row + 1 + j), b);
  } else if constexpr (OP == OP_NBAND_W) {
    // limbs 0 and 1 ANDed with bank row aux, packed into an int32
    const uint32_t* xr = ln.ptr(a.rf, ia);
    const uint32_t* c = a.cbank + (long long)aux * L;
    return (int32_t)((xr[0] & __ldg(c)) |
                     ((xr[B] & __ldg(c + 1)) << LIMB_BITS));
  } else if constexpr (OP == OP_LNOT_W) {
    uint32_t x[L];
    ln.load(a.rf, ia, x);
    return !nonzero<L>(x);
  } else {
    // *_ww: the wide comparison, whose 0/1 result is limb 0
    uint32_t x[L], y[L];
    ln.load(a.rf, ia, x);
    ln.load(a.rf, __ldg(row + 2), y);
    return cmp_wide<L, OP - OP_EQ_WW>(x, y, wc);
  }
}

// Steps t..t+g-1 (g <= N) of opcode OP, whose result is narrow, none of
// which reads a register an earlier one writes: every step reads its
// operands before any stores, then each writes rf_n[dst] and, unless em is
// the dump row KN, narrow bank row em of this chunk, in order.  Slots g..N-1
// compute step t again and store nothing.
template <int L, int OP, int N>
__device__ __forceinline__ void narrow_group(const InterpArgs& a,
                                             const Lane<L>& ln,
                                             int32_t* chunk_bank_n, int t,
                                             int g, const WideConsts& wc) {
  int32_t r[N];
  int dst[N], em[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ti = t + (i < g ? i : 0);
    const int32_t* row = a.table + (long long)ti * 7;
    dst[i] = __ldg(row + 4);
    em[i] = __ldg(row + 5);
    r[i] = narrow_value<L, OP>(a, ln, ti, wc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < g) {
      a.rf_n[dst[i] * a.B + ln.b] = r[i];
      if (em[i] != a.KN) chunk_bank_n[em[i] * a.B + ln.b] = r[i];
    }
  }
}

// One run of steps s0..s1 of opcode OP, whose result is narrow, in the
// groups of convert.DevicePlan.grp (the length of a group at its first
// step, at most NGROUP): a lane has a group's loads in flight at once
// where the step chain would wait a memory round trip a step.  A group
// runs in 1, 2, 4 or NGROUP slots.
template <int L, int OP>
__device__ __forceinline__ void run_narrow(const InterpArgs& a,
                                           const Lane<L>& ln,
                                           int32_t* chunk_bank_n, int s0,
                                           int s1, const WideConsts& wc) {
  int g;
  for (int t = s0; t < s1; t += g) {
    g = __ldg(a.grp + t);
    if (g == 1)
      narrow_group<L, OP, 1>(a, ln, chunk_bank_n, t, g, wc);
    else if (g == 2)
      narrow_group<L, OP, 2>(a, ln, chunk_bank_n, t, g, wc);
    else if (g <= 4)
      narrow_group<L, OP, 4>(a, ln, chunk_bank_n, t, g, wc);
    else
      narrow_group<L, OP, NGROUP>(a, ln, chunk_bank_n, t, g, wc);
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
// for 49 more cases (K1a measured about 3 % slower with them), and holds
// the wide register file as packed 32-bit words, which only K1a's opcodes
// read.
template <int L, bool FULL>
__global__ void __launch_bounds__(128) interp_k1_kernel(InterpArgs a,
                                                        FieldConsts fc,
                                                        WideConsts wc) {
  constexpr int N = L / 2;
  constexpr bool WORDS = !FULL;
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const Lane<L> ln{b, a.B};
  uint32_t pw[N];
  p_words<L>(fc, pw);
  // inputs and materialized wide constants into the wide register file
  // (em = K: no bank row)
  for (int k = 0; k < a.n_win; ++k) {
    if constexpr (WORDS) {
      uint32_t v[N];
      pack32<L>(ln.ptr(a.x_w, k), a.B, v);
      store32<L, WORDS>(a, ln, nullptr, k, a.K, v);
    } else {
      uint32_t v[L];
      ln.load(a.x_w, k, v);
      ln.store(a.rf, k, v);
    }
  }
  for (int m = 0; m < a.n_mat; ++m) {
    if constexpr (WORDS) {
      uint32_t v[N];
      pack32<L>(a.mat_limbs + (long long)m * L, 1, v);
      store32<L, WORDS>(a, ln, nullptr, __ldg(a.mat_regs + m), a.K, v);
    } else {
      uint32_t v[L];
      load_const<L>(a.mat_limbs, m, v);
      ln.store(a.rf, __ldg(a.mat_regs + m), v);
    }
  }
  // narrow inputs and constants into the narrow register file
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
#define WIDE(OPC)                                                     \
  case OPC:                                                           \
    run_steps<L, OPC, WORDS>(a, ln, chunk_bank, s0, s1, fc, wc, pw);  \
    break;
#define NARROW(OPC)                                                   \
  case OPC:                                                           \
    run_narrow<L, OPC>(a, ln, chunk_bank_n, s0, s1, wc);              \
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
    // trailing REDC: flagged Montgomery emission rows -> canonical (the
    // dump row K is nobody's output)
    for (int r = 0; r < a.K; ++r) {
      if (__ldg(a.mont_tab + c * (a.K + 1) + r) == 0) continue;
      uint32_t v[N], t[2 * N + 1], out[N];
      pack32<L>(ln.ptr(chunk_bank, r), a.B, v);
#pragma unroll
      for (int k = 0; k < 2 * N + 1; ++k) t[k] = k < N ? v[k] : 0;
      mont_reduce32<N>(t, pw, fc.n0inv32, out);
      unpack32<L>(out, ln.at(chunk_bank, r), a.B);
    }
  }
}

}  // namespace ctpu

// Launch K1 on `stream`.  Device pointers: x_w, x_n, table, grp, r_op,
// r_s0, rstarts, cbank, cbank_w, mont_tab, mat_regs, mat_limbs, nmat_vals,
// nmat_regs, rf, bank, rf_n, bank_n (each register file has at least its
// trash row, rf L words a row a lane).  Host pointers: p_limbs, r2_limbs,
// half_limbs, mask_limbs, q_limbs (L words each); n0inv32 = -p^-1 mod
// 2^32.  L is 4 (goldilocks) or 16 (the 256-bit primes); full is nonzero
// when the plan runs K1c or K1d opcodes.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int ctpu_interp_k1(
    int L, long long B, const uint32_t* x_w, int n_win, const int32_t* x_n,
    int n_nin, const int32_t* table, const int32_t* grp, const int32_t* r_op,
    const int32_t* r_s0, const int32_t* rstarts, int n_chunks,
    const uint32_t* cbank, const uint32_t* cbank_w, const int32_t* mont_tab,
    const int32_t* mat_regs, const uint32_t* mat_limbs, int n_mat,
    const int32_t* nmat_vals, const int32_t* nmat_regs, int n_nmat,
    uint32_t* rf, uint32_t* bank, int K, int32_t* rf_n, int32_t* bank_n,
    int KN, const uint32_t* p_limbs, const uint32_t* r2_limbs,
    uint32_t n0inv32, const uint32_t* half_limbs, const uint32_t* mask_limbs,
    const uint32_t* q_limbs, int bits, int full, void* stream) {
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
  fc.n0inv32 = n0inv32;
  wc.bits = bits;
  ctpu::InterpArgs a = {};
  a.x_w = x_w;
  a.x_n = x_n;
  a.table = table;
  a.grp = grp;
  a.r_op = r_op;
  a.r_s0 = r_s0;
  a.rstarts = rstarts;
  a.cbank = cbank;
  a.cbank_w = cbank_w;
  a.mont_tab = mont_tab;
  a.mat_regs = mat_regs;
  a.mat_limbs = mat_limbs;
  a.nmat_vals = nmat_vals;
  a.nmat_regs = nmat_regs;
  a.n_nmat = n_nmat;
  a.rf = rf;
  a.bank = bank;
  a.rf_n = rf_n;
  a.bank_n = bank_n;
  a.n_win = n_win;
  a.n_nin = n_nin;
  a.n_mat = n_mat;
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
