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
// booleans, the masked bit ops, the shifts, the widening of a narrow
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
// files and the emission banks live in device memory, batch-minor: the
// banks (rows, L, B) 16-bit limbs in uint32 and (rows, B) int32, which the
// gathers K2 and K3 and the JAX package's witness layout read, the narrow
// file (rows, B) int32, the wide file as below.  Every thread of the grid
// walks the same instruction stream, so each table read is a uniform
// broadcast load, and the opcode switch is taken once per run, not per
// step.
//
// Bound on the card.  The emission banks must be written once and the
// inputs read once; for Poseidon2/bn128 the byte and operation bounds are
// within a factor of two of each other, for SHA256 the byte bound rules
// (PERF.md).  What the design does about it:
// - One wide register file for every opcode, in 32-bit words: N = L/2
//   words a register a lane (WordFile).  The inputs and materialized
//   constants are packed into it at the start; 16-bit limbs appear again
//   only where a result is stored to the emission bank (unpack32).  Every
//   wide opcode computes in words: the products, dots and trailing REDC
//   (field32.cuh, dot32.cuh: 32x32->64-bit products, about a quarter of
//   the integer instructions of field.cuh's 16-bit steps), the modular add
//   and subtract (dot32.cuh), and K1c's and K1d's other opcodes
//   (wide32.cuh), each bit for bit equal to its 16-bit version in
//   field.cuh and wide.cuh, which the tests hold.  The constant bank is
//   read in words too (cbank_w).  Half the bytes of a 16-bit limb file
//   move per register, and no operand is packed or result unpacked on its
//   way through the file.  A plan with many registers is bound by that
//   traffic: the stdlib comparators' file (139 registers, 291 MB at 65,536
//   lanes, far beyond the 50 MB L2) moves ~57 KB a lane, which HBM3 takes
//   about as long to move as the whole launch lasts (PERF.md).
// - Goldilocks (L = 4) is one 64-bit word: a register's two words lie side
//   by side, so an operand is one 8-byte load, and gmul and gmul_c are one
//   64x64->128-bit product folded with 2^64 = 2^32 - 1 and 2^96 = -1 mod p
//   (gl_mul64), where the 16-bit fold took 16 narrow products, four
//   signed carry chains and four 4-byte loads an operand.  A small plan
//   like Poseidon2/goldilocks' (17 registers, 9 MB, inside L2) is bound by
//   the latency of each lane's chain of dependent steps: its time hardly
//   moves between 16,384 and 65,536 lanes.  Keeping its file in shared
//   memory did not shorten that chain (within 2 %, PERF.md), so the file
//   has one home.
// - A run reads its next step's table row while the current step computes,
//   so that read is off the chain (5-9 % on the comparators' and
//   Poseidon2's plans).
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
// - The opcodes whose operand index depends on the data or the count
//   (select, the shifts, the long division) read their words in place.
// - The inputs are read where the caller's rows lie, (n_inputs, Lin, B):
//   wide input k is row win_order[k] packed into words (Lin = L), narrow
//   input k is limb0 | limb1 << 16 of row nin_order[k] (limb0 alone where
//   Lin = 1), the bits of the JAX package's split in _run
//   (astype(int32) | limb1 << 16; limbs 2 and up are not read).  So no
//   gather, widening or cast of the inputs runs before K1: the split took
//   six launches and ~1.4 GB of traffic on SHA256's 512 input rows at
//   8,192 lanes, where K1 reads 33.5 MB of them.
//
// Canonical results at every field.  Every register and constant-bank row
// holds a canonical value (< p, p < R = 2^(32N)), and each wide opcode's
// reduction leaves one, p just under R (secq256r1, goldilocks) included:
// - dot2_c, dot3_c: V = sum x_i c_i + k <= n (p - 1)^2 + p - 1 reduces to
//   at most (V + (R - 1) p) / R, up to ~4p where p / R is near 1, so the
//   dot subtracts p S_n times (dot32.cuh: S_2, S_3 = 2, 3 at secq256r1
//   and goldilocks, 1, 2 at bls12381, else 1), a count the launch computes
//   from p (K1Consts.dot_subs).  A field whose counts are 1 runs the
//   kernels of one subtract (SUBS = false), their code unchanged; the
//   others run the kernels with the counted subtracts (SUBS = true,
//   compact or full as the plan allows).  Kept in the kernels of one
//   subtract, that code made K1a 5.2 % and K1b 0.9 % slower at bn128
//   (PERF.md).  One subtract gave wrong witnesses on Poseidon2 at
//   secq256r1.
// - mul, mul_r2, mul_c, mul_one (field32.cuh's CIOS): x y < p^2 < R p, so
//   (x y + M p) / R < p (p / R + 1) < 2p: one subtract.
// - add, add_c: a + b < 2p; sub, sub_c, csub_c: a + p - b in (0, 2p):
//   one subtract.
// - The trailing REDC of an emission row v < R: (v + M p) / R < p + 1:
//   one subtract.
// - K1d's bor, bxor, bnot and shl_kw (wide32.cuh reduce_once32): a value
//   of at most `bits` = p.bit_length() bits, below 2^bits <= 2p: one
//   subtract; band, shr_kw, select, idiv (the quotient is at most its
//   dividend) and the comparisons are canonical without one; widen
//   gives v or p + v, v a signed int32 and p > 2^32; K1c's gl_mul64
//   folds below 2^64 < 2p and subtracts once.
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "field32.cuh"
#include "narrow.cuh"
#include "wide32.cuh"

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
  const uint32_t* inputs;   // (n_inputs, lin, B) input rows, 16-bit limbs
  const int32_t* win_order;  // (n_win) input row of each wide input
  const int32_t* nin_order;  // (n_nin) input row of each narrow input
  int lin;                  // limbs an input row: L where n_win > 0, else
                            // 1, 2 or L
  const int32_t* table;     // (n_steps, 7): op ia ib ic dst em aux
  const int32_t* grp;       // (n_steps): length of a narrow step group
  const int32_t* r_op;      // per run: opcode
  const int32_t* r_s0;      // per run: first step (n_runs + 1 entries)
  const int32_t* rstarts;   // per chunk: first run (n_chunks + 1 entries)
  const uint32_t* cbank_w;  // (n_bank, L/2) constant bank, 32-bit words
  const int32_t* mont_tab;  // (n_chunks * (K + 1)) trailing-REDC flags
  const int32_t* mat_regs;  // (n_mat) register of each materialized const
  const uint32_t* mat_limbs;  // (n_mat, L)
  const int32_t* nmat_vals;   // (n_nmat) narrow constants
  const int32_t* nmat_regs;   // (n_nmat) register of each narrow constant
  int n_nmat;
  uint32_t* rf;             // wide register file (scratch), WordFile's
  uint32_t* bank;           // (n_chunks * (K + 1), L, B) wide emission bank
  int32_t* rf_n;            // (n_nregs, B) narrow register file (scratch)
  int32_t* bank_n;          // (n_chunks * (KN + 1), B) narrow emission bank
  int n_win, n_nin, n_mat, n_chunks, K, KN;
  long long B;
};

// The field's constants in N = L/2 32-bit words, a kernel parameter.
template <int N>
struct K1Consts {
  uint32_t p[N];
  uint32_t r2[N];    // R^2 mod p, R = 2^(32N)
  uint32_t half[N];  // p / 2, the pivot of the sign rule
  uint32_t mask[N];  // 2^bits - 1, the complement and shift mask
  uint32_t q[N];     // p - 2^32, the widening of a negative int32
  uint32_t n0inv32;  // -p^-1 mod 2^32
  int bits;          // p.bit_length(), the long division's steps
  int dot_subs[2];   // S_2, S_3: the subtracts of dot2_c, dot3_c (dot32.cuh)
};

// The most narrow steps a group holds: convert.K1B_GROUP, which
// ops/build.py passes as -DCTPU_K1B_GROUP.
#ifndef CTPU_K1B_GROUP
#error "build with -DCTPU_K1B_GROUP=<convert.K1B_GROUP> (ops/build.py)"
#endif
constexpr int NGROUP = CTPU_K1B_GROUP;

constexpr int THREADS = 128;

// The wide register file of one lane: N = L/2 32-bit words a register.  V
// words of a register lie side by side, one V * 4-byte load (goldilocks:
// V = 2, its one 64-bit word), and the register's N / V groups of V words
// B lanes apart: the file is (n_regs, N / V, B, V).
template <int L>
struct WordFile {
  static constexpr int N = L / 2;
  static constexpr int V = L == 4 ? 2 : 1;
  uint32_t* base;     // word 0 of register 0 of this lane
  long long stride;   // B * V

  __device__ __forceinline__ uint32_t* word(int row, int w) const {
    return base + ((long long)row * (N / V) + w / V) * stride + w % V;
  }
  __device__ __forceinline__ void load(int row, uint32_t (&x)[N]) const {
    if constexpr (V == 2) {
#pragma unroll
      for (int g = 0; g < N / 2; ++g) {
        const uint64_t v =
            *reinterpret_cast<const uint64_t*>(word(row, 2 * g));
        x[2 * g] = (uint32_t)v;
        x[2 * g + 1] = (uint32_t)(v >> 32);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = *word(row, i);
    }
  }
  __device__ __forceinline__ void store(int row,
                                        const uint32_t (&x)[N]) const {
    if constexpr (V == 2) {
#pragma unroll
      for (int g = 0; g < N / 2; ++g)
        *reinterpret_cast<uint64_t*>(word(row, 2 * g)) =
            x[2 * g] | ((uint64_t)x[2 * g + 1] << 32);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) *word(row, i) = x[i];
    }
  }
};

// Bank row `row` of this lane's column: limb i at [i * B].
template <int L>
__device__ __forceinline__ uint32_t* bank_at(uint32_t* bank, long long row,
                                             long long b, long long B) {
  return bank + row * L * B + b;
}

template <int N>
__device__ __forceinline__ void load_const32(const uint32_t* cbank_w,
                                             int row, uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = __ldg(cbank_w + (long long)row * N + i);
}

// Narrow register `reg` of lane b.
__device__ __forceinline__ int32_t nreg(const InterpArgs& a, int reg,
                                        long long b) {
  return a.rf_n[reg * a.B + b];
}

// Columns 1-6 of a step's table row.
struct StepRow {
  int ia, ib, ic, dst, em, aux;
};

__device__ __forceinline__ StepRow step_row(const int32_t* table, int t) {
  const int32_t* row = table + (long long)t * 7;
  return {__ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
          __ldg(row + 4), __ldg(row + 5), __ldg(row + 6)};
}

// One run of steps s0..s1 of opcode OP, whose result is wide, computed in
// words: each result to register dst and, unless em is the dump row K, to
// emission row em of the chunk's bank (unpacked to 16-bit limbs).  SUBS: a
// dot's reduction subtracts p up to kc.dot_subs times, for the fields
// where once is not enough (else mont_reduce32's one subtract).
template <int L, int OP, bool SUBS>
__device__ __forceinline__ void run_steps(const InterpArgs& a,
                                          const WordFile<L>& rf, long long b,
                                          uint32_t* chunk_bank, int s0,
                                          int s1,
                                          const K1Consts<L / 2>& kc,
                                          const uint32_t (&pw)[L / 2]) {
  constexpr int N = L / 2;
  // the next step's row is read while this one computes: a step's table
  // read is off the chain of dependent loads that bounds a lane
  StepRow next = step_row(a.table, s0);
  for (int t = s0; t < s1; ++t) {
    const StepRow cur = next;
    if (t + 1 < s1) next = step_row(a.table, t + 1);
    const int ia = cur.ia, ib = cur.ib, ic = cur.ic;
    const int dst = cur.dst, em = cur.em, aux = cur.aux;
    uint32_t w[N];
    if constexpr (OP == OP_COPYW) {
      rf.load(ia, w);
    } else if constexpr (OP == OP_ADD || OP == OP_ADD_C || OP == OP_SUB ||
                         OP == OP_SUB_C || OP == OP_CSUB_C) {
      uint32_t x[N], y[N];
      rf.load(ia, x);
      if (OP == OP_ADD || OP == OP_SUB)
        rf.load(ib, y);
      else
        load_const32<N>(a.cbank_w, ib, y);
      if (OP == OP_ADD || OP == OP_ADD_C)
        mod_add32<N>(x, y, pw, w);
      else if (OP == OP_CSUB_C)
        mod_sub32<N>(y, x, pw, w);  // bank row minus register
      else
        mod_sub32<N>(x, y, pw, w);
    } else if constexpr (OP == OP_DOT2_C || OP == OP_DOT3_C) {
      // bank rows aux..aux+n-1 hold the coefficients, row aux+n an
      // additive constant; accumulate every product into one 2N + 1 word
      // sum and reduce once (lazy reduction)
      constexpr int NT = (OP == OP_DOT3_C) ? 3 : 2;
      uint32_t acc[2 * N + 1];
#pragma unroll
      for (int k = 0; k < 2 * N + 1; ++k) acc[k] = 0;
      const int regs[3] = {ia, ib, ic};
#pragma unroll
      for (int term = 0; term < NT; ++term) {
        uint32_t x[N], c[N];
        rf.load(regs[term], x);
        load_const32<N>(a.cbank_w, aux + term, c);
        mac32<N>(acc, x, c);
      }
      uint32_t k[N];
      load_const32<N>(a.cbank_w, aux + NT, k);
      add_low32<N>(acc, k);
      if constexpr (SUBS)
        mont_reduce_dot32<N, NT>(acc, pw, kc.n0inv32,
                                 kc.dot_subs[NT - 2], w);
      else
        mont_reduce32<N>(acc, pw, kc.n0inv32, w);
    } else if constexpr (OP == OP_MUL || OP == OP_MUL_R2 || OP == OP_MUL_C ||
                         OP == OP_MUL_ONE) {
      // the Montgomery products: by a register, R^2, a bank row, 1
      uint32_t x[N], y[N];
      rf.load(ia, x);
      if constexpr (OP == OP_MUL) {
        rf.load(ib, y);
      } else if constexpr (OP == OP_MUL_C) {
        load_const32<N>(a.cbank_w, ib, y);
      } else if constexpr (OP == OP_MUL_R2) {
#pragma unroll
        for (int i = 0; i < N; ++i) y[i] = kc.r2[i];
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) y[i] = i == 0;
      }
      mont_mul32<N>(x, y, pw, kc.n0inv32, w);
    } else if constexpr (OP == OP_GMUL || OP == OP_GMUL_C) {
      if constexpr (L == 4) {
        uint32_t x[2], y[2];
        rf.load(ia, x);
        if (OP == OP_GMUL)
          rf.load(ib, y);
        else
          load_const32<2>(a.cbank_w, ib, y);
        const uint64_t r = gl_mul64(x[0] | ((uint64_t)x[1] << 32),
                                    y[0] | ((uint64_t)y[1] << 32));
        w[0] = (uint32_t)r;
        w[1] = (uint32_t)(r >> 32);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = 0;  // goldilocks only (wrapper)
      }
    } else if constexpr (OP == OP_SELECT) {
      uint32_t x[N];
      rf.load(ia, x);
      rf.load(nonzero32<N>(x) ? ib : ic, w);
    } else if constexpr ((OP >= OP_EQ && OP <= OP_LOR) || OP == OP_LNOT) {
      uint32_t x[N], y[N];
      rf.load(ia, x);
#pragma unroll
      for (int i = 1; i < N; ++i) w[i] = 0;
      if constexpr (OP == OP_LNOT) {
        w[0] = !nonzero32<N>(x);
      } else {
        rf.load(ib, y);
        w[0] = cmp32<N, OP - OP_EQ>(x, y, kc.half);
      }
    } else if constexpr (OP == OP_BAND || OP == OP_BOR || OP == OP_BXOR) {
      uint32_t x[N], y[N];
      rf.load(ia, x);
      rf.load(ib, y);
      bitop32<N, OP - OP_BAND>(x, y, pw, w);
    } else if constexpr (OP == OP_BNOT) {
      uint32_t x[N];
      rf.load(ia, x);
      bnot32<N>(x, kc.mask, pw, w);
    } else if constexpr (OP == OP_SHL_KW || OP == OP_SHR_KW) {
      shift32<N, OP == OP_SHL_KW>([&](int i) { return *rf.word(ia, i); },
                                  aux, pw, kc.mask, w);
    } else if constexpr (OP == OP_WIDEN) {
      widen32<N>(nreg(a, ia, b), kc.q, w);
    } else {
      static_assert(OP == OP_IDIV, "a wide opcode without a case");
      uint32_t y[N];
      rf.load(ib, y);
      idiv32<N>([&](int i) { return *rf.word(ia, i); }, y, kc.bits, w);
    }
    rf.store(dst, w);
    if (em != a.K) unpack32<L>(w, bank_at<L>(chunk_bank, em, b, a.B), a.B);
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
// operands of the opcode's files (rf_n, or the wide file's words for
// nsel_w, nband_w, lnot_w and the *_ww comparisons) and compute.
template <int L, int OP>
__device__ __forceinline__ int32_t narrow_value(const InterpArgs& a,
                                                const WordFile<L>& rf,
                                                long long b, int t,
                                                const K1Consts<L / 2>& kc) {
  constexpr int N = L / 2;
  // narrow_op's opcodes, and those of them with a second operand
  constexpr bool SCALAR = OP <= OP_NROTR || OP == OP_NSUB ||
                          OP == OP_NIDIV || OP == OP_LNOT_N ||
                          (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  constexpr bool TWO = OP == OP_NADD || OP == OP_NMUL || OP == OP_NBAND ||
                       OP == OP_NBOR || OP == OP_NBXOR || OP == OP_NMSHL ||
                       OP == OP_NMSHRU || OP == OP_NSUB || OP == OP_NIDIV ||
                       (OP >= OP_EQ_NN && OP <= OP_LOR_NN);
  const int32_t* row = a.table + (long long)t * 7;
  const int ia = __ldg(row + 1), aux = __ldg(row + 6);
  if constexpr (SCALAR) {
    const int32_t x = nreg(a, ia, b);
    const int32_t y = TWO ? nreg(a, __ldg(row + 2), b) : 0;
    return narrow_op<OP>(x, y, aux);
  } else if constexpr (OP == OP_NSEL) {
    const int j = nreg(a, ia, b) != 0 ? 1 : 2;
    return nreg(a, __ldg(row + 1 + j), b);
  } else if constexpr (OP == OP_NSEL_W || OP == OP_LNOT_W) {
    uint32_t x[N];
    rf.load(ia, x);
    if constexpr (OP == OP_LNOT_W) return !nonzero32<N>(x);
    const int j = nonzero32<N>(x) ? 1 : 2;
    return nreg(a, __ldg(row + 1 + j), b);
  } else if constexpr (OP == OP_NBAND_W) {
    // word 0 (limbs 0 and 1) ANDed with bank row aux's, as an int32
    return (int32_t)(*rf.word(ia, 0) & __ldg(a.cbank_w + (long long)aux * N));
  } else {
    // *_ww: the wide comparison, whose 0/1 result is word 0
    uint32_t x[N], y[N];
    rf.load(ia, x);
    rf.load(__ldg(row + 2), y);
    return cmp32<N, OP - OP_EQ_WW>(x, y, kc.half);
  }
}

// Steps t..t+g-1 (g <= S) of opcode OP, whose result is narrow, none of
// which reads a register an earlier one writes: every step reads its
// operands before any stores, then each writes rf_n[dst] and, unless em is
// the dump row KN, narrow bank row em of this chunk, in order.  Slots g..S-1
// compute step t again and store nothing.
template <int L, int OP, int S>
__device__ __forceinline__ void narrow_group(const InterpArgs& a,
                                             const WordFile<L>& rf,
                                             long long b,
                                             int32_t* chunk_bank_n, int t,
                                             int g,
                                             const K1Consts<L / 2>& kc) {
  int32_t r[S];
  int dst[S], em[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int ti = t + (i < g ? i : 0);
    const int32_t* row = a.table + (long long)ti * 7;
    dst[i] = __ldg(row + 4);
    em[i] = __ldg(row + 5);
    r[i] = narrow_value<L, OP>(a, rf, b, ti, kc);
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < g) {
      a.rf_n[dst[i] * a.B + b] = r[i];
      if (em[i] != a.KN) chunk_bank_n[em[i] * a.B + b] = r[i];
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
                                           const WordFile<L>& rf, long long b,
                                           int32_t* chunk_bank_n, int s0,
                                           int s1,
                                           const K1Consts<L / 2>& kc) {
  int g;
  for (int t = s0; t < s1; t += g) {
    g = __ldg(a.grp + t);
    if (g == 1)
      narrow_group<L, OP, 1>(a, rf, b, chunk_bank_n, t, g, kc);
    else if (g == 2)
      narrow_group<L, OP, 2>(a, rf, b, chunk_bank_n, t, g, kc);
    else if (g <= 4)
      narrow_group<L, OP, 4>(a, rf, b, chunk_bank_n, t, g, kc);
    else
      narrow_group<L, OP, NGROUP>(a, rf, b, chunk_bank_n, t, g, kc);
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
#define K1C_CASES \
  WIDE(OP_GMUL) \
  WIDE(OP_GMUL_C) \
  WIDE(OP_ADD)
#define K1D_CASES \
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
// the compact code, so their hot loops do not pay for 49 more cases (with
// every case, even on the word file, K1a ran 3.9 % and K1b 1.3 % slower).
// SUBS = true: the dots subtract p kc.dot_subs times (the fields where
// once is not enough).
template <int L, bool FULL, bool SUBS>
__global__ void __launch_bounds__(THREADS) interp_k1_kernel(
    InterpArgs a, K1Consts<L / 2> kc) {
  constexpr int N = L / 2, V = WordFile<L>::V;
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const WordFile<L> rf{a.rf + b * V, a.B * V};
  uint32_t pw[N];
#pragma unroll
  for (int i = 0; i < N; ++i) pw[i] = kc.p[i];
  // inputs (rows of the caller's tensor) and materialized wide constants
  // into the wide register file
  for (int k = 0; k < a.n_win; ++k) {
    uint32_t v[N];
    pack32<L>(a.inputs + (long long)__ldg(a.win_order + k) * L * a.B + b,
              a.B, v);
    rf.store(k, v);
  }
  for (int m = 0; m < a.n_mat; ++m) {
    uint32_t v[N];
    pack32<L>(a.mat_limbs + (long long)m * L, 1, v);
    rf.store(__ldg(a.mat_regs + m), v);
  }
  // narrow inputs and constants into the narrow register file
  for (int k = 0; k < a.n_nin; ++k) {
    const uint32_t* row =
        a.inputs + (long long)__ldg(a.nin_order + k) * a.lin * a.B + b;
    const uint32_t v = a.lin > 1 ? row[0] | (row[a.B] << 16) : row[0];
    a.rf_n[k * a.B + b] = (int32_t)v;
  }
  for (int m = 0; m < a.n_nmat; ++m)
    a.rf_n[__ldg(a.nmat_regs + m) * a.B + b] = __ldg(a.nmat_vals + m);
  for (int c = 0; c < a.n_chunks; ++c) {
    uint32_t* chunk_bank = a.bank + (long long)c * (a.K + 1) * L * a.B;
    int32_t* chunk_bank_n = a.bank_n + (long long)c * (a.KN + 1) * a.B;
    const int r1 = __ldg(a.rstarts + c + 1);
    for (int rr = __ldg(a.rstarts + c); rr < r1; ++rr) {
      const int s0 = __ldg(a.r_s0 + rr), s1 = __ldg(a.r_s0 + rr + 1);
      const int op = __ldg(a.r_op + rr);
#define WIDE(OPC)                                                  \
  case OPC:                                                        \
    run_steps<L, OPC, SUBS>(a, rf, b, chunk_bank, s0, s1, kc, pw); \
    break;
#define NARROW(OPC)                                                \
  case OPC:                                                        \
    run_narrow<L, OPC>(a, rf, b, chunk_bank_n, s0, s1, kc);        \
    break;
      // the wrapper picks FULL from the plan's opcodes and refuses plans
      // with opcodes outside OPCODES, so `default` is never taken
      if constexpr (FULL) {
        switch (op) {
          K1AB_CASES
          K1C_CASES
          K1D_CASES
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
      uint32_t* at = bank_at<L>(chunk_bank, r, b, a.B);
      pack32<L>(at, a.B, v);
#pragma unroll
      for (int k = 0; k < 2 * N + 1; ++k) t[k] = k < N ? v[k] : 0;
      mont_reduce32<N>(t, pw, kc.n0inv32, out);
      unpack32<L>(out, at, a.B);
    }
  }
}

// L 16-bit limbs -> N = L/2 words.
template <int N>
void words_of(const uint32_t* limbs, uint32_t (&w)[N]) {
  for (int i = 0; i < N; ++i) w[i] = limbs[2 * i] | (limbs[2 * i + 1] << 16);
}

// The field's constants packed into words, with its dots' subtracts.
template <int L>
K1Consts<L / 2> k1_consts(const uint32_t* p_limbs, const uint32_t* r2_limbs,
                          uint32_t n0inv32, const uint32_t* half_limbs,
                          const uint32_t* mask_limbs,
                          const uint32_t* q_limbs, int bits) {
  constexpr int N = L / 2;
  K1Consts<N> kc = {};
  words_of<N>(p_limbs, kc.p);
  words_of<N>(r2_limbs, kc.r2);
  words_of<N>(half_limbs, kc.half);
  words_of<N>(mask_limbs, kc.mask);
  words_of<N>(q_limbs, kc.q);
  kc.n0inv32 = n0inv32;
  kc.bits = bits;
  kc.dot_subs[0] = dot_subtractions<N>(kc.p, 2);
  kc.dot_subs[1] = dot_subtractions<N>(kc.p, 3);
  return kc;
}

template <int L, bool FULL, bool SUBS>
int launch(const InterpArgs& a, const K1Consts<L / 2>& kc, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.B + THREADS - 1) / THREADS);
  interp_k1_kernel<L, FULL, SUBS><<<blocks, THREADS, 0, s>>>(a, kc);
  return (int)cudaGetLastError();
}

}  // namespace ctpu

// Launch K1 on `stream`.  Device pointers: inputs, win_order, nin_order,
// table, grp, r_op, r_s0, rstarts, cbank_w, mont_tab, mat_regs, mat_limbs,
// nmat_vals, nmat_regs, rf, bank, rf_n, bank_n.  inputs holds the caller's
// input rows, (n_inputs, lin, B) 16-bit limbs; win_order and nin_order
// (n_win, n_nin) name the row of each wide and narrow input, every one
// below n_inputs; lin is L where n_win > 0, else 1, 2 or L.  rf holds the
// plan's wide registers (the trash register included), L/2 words a
// register a lane: (n_regs, L/2, B) for L = 16, (n_regs, B, 2) for L = 4.
// Host pointers: p_limbs, r2_limbs, half_limbs, mask_limbs, q_limbs (L
// 16-bit limbs each); n0inv32 = -p^-1 mod 2^32.  L is 4 (goldilocks) or 16
// (the 256-bit primes); full is nonzero when the plan runs K1c or K1d
// opcodes.  Returns the launch's cudaError_t (0 on success).
extern "C" int ctpu_interp_k1(
    int L, long long B, const uint32_t* inputs, int lin,
    const int32_t* win_order, int n_win, const int32_t* nin_order, int n_nin,
    const int32_t* table, const int32_t* grp, const int32_t* r_op,
    const int32_t* r_s0, const int32_t* rstarts, int n_chunks,
    const uint32_t* cbank_w, const int32_t* mont_tab,
    const int32_t* mat_regs, const uint32_t* mat_limbs, int n_mat,
    const int32_t* nmat_vals, const int32_t* nmat_regs, int n_nmat,
    uint32_t* rf, uint32_t* bank, int K, int32_t* rf_n,
    int32_t* bank_n, int KN, const uint32_t* p_limbs,
    const uint32_t* r2_limbs, uint32_t n0inv32, const uint32_t* half_limbs,
    const uint32_t* mask_limbs, const uint32_t* q_limbs, int bits, int full,
    void* stream) {
  if (L != 4 && L != 16) return (int)cudaErrorInvalidValue;
  if ((lin != 1 && lin != 2 && lin != L) || (n_win > 0 && lin != L))
    return (int)cudaErrorInvalidValue;
  ctpu::InterpArgs a = {};
  a.inputs = inputs;
  a.win_order = win_order;
  a.nin_order = nin_order;
  a.lin = lin;
  a.table = table;
  a.grp = grp;
  a.r_op = r_op;
  a.r_s0 = r_s0;
  a.rstarts = rstarts;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_CONSTS(LL)                                                      \
  ctpu::k1_consts<LL>(p_limbs, r2_limbs, n0inv32, half_limbs, mask_limbs, \
                      q_limbs, bits)
  if (L == 4)  // goldilocks (S_2, S_3 = 2, 3): one instantiation
    return ctpu::launch<4, true, true>(a, K1_CONSTS(4), s);
  const ctpu::K1Consts<8> kc = K1_CONSTS(16);
#undef K1_CONSTS
  // a field whose dots need more than one subtract runs the kernels that
  // count them, the others those of one subtract; each compact where the
  // plan allows
  if (kc.dot_subs[0] > 1 || kc.dot_subs[1] > 1)
    return full ? ctpu::launch<16, true, true>(a, kc, s)
                : ctpu::launch<16, false, true>(a, kc, s);
  return full ? ctpu::launch<16, true, false>(a, kc, s)
              : ctpu::launch<16, false, false>(a, kc, s);
}
