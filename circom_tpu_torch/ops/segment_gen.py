"""Kernel K4: CUDA C++ generated from a SegmentedProgram's segments.

`generate(segments, field)` writes one source per program with one
`__global__` per segment and one C entry point `ctpu_k4_seg<s>` per
segment, each under `#if K4_SEG == s` (ops/build.py `build_generated`
builds a library a segment from the same text, all in parallel: nvcc's
time grows faster than linearly with a kernel's length).
Each kernel is the segment's straight-line instructions for one lane a
thread: operands are `F` values (N = L/2 32-bit words in registers,
indexed only by compile-time constants), constants are word literals,
and nothing dispatches on an opcode or indexes a register file at run
time, which is what K4 offers over the interpreter K1.  Every kernel
takes the base pointers of the program's inputs, the witness and the
crossing buffer; the row of each operand it loads and of each result it
stores is a literal (SegmentedProgram._place: `src`, `dst`, `fill`).
The device arithmetic is the word arithmetic K1 and KS compute with
(field32.cuh, dot32.cuh, wide32.cuh); the results equal the plain version
(backend/segments.py `segment_ref`) bit for bit.  The generator handles
every op of backend/plan.KERNEL_OPS but `idiv`, which the segmented
backend refuses.
"""

import re

from ..field.primes import LIMB_BITS
from .field import GOLDILOCKS_P

# the ops a segment may hold: plan.KERNEL_OPS without idiv
CMP = {"eq": "WCMP_EQ", "neq": "WCMP_NEQ", "lt": "WCMP_LT", "le": "WCMP_LE",
       "gt": "WCMP_GT", "ge": "WCMP_GE", "land": "WCMP_LAND",
       "lor": "WCMP_LOR"}
OPS = frozenset({"mul", "mulp", "add", "sub", "select", "lnot", "band",
                 "bor", "bxor", "bnot", "shl_k", "shr_k"} | set(CMP))
THREADS = 128

HEADER = """\
// Kernel K4, generated by circom_tpu_torch/ops/segment_gen.py for one
// SegmentedProgram: one kernel per segment of the witness tape.
//
// Replaces the JAX package's Pallas kernel SegmentedProgram._call_segment
// (circom_tpu/backend/segments.py:242, body _make_kernel).  One thread
// takes one lane of the batch: it loads the segment's operands where they
// lie (rows of the inputs x, of the witness w that an earlier segment
// wrote, or of the crossing buffer c, all (n, L, B) planes of 16-bit
// limbs), runs the segment's field ops straight through with every
// temporary in registers (`F`, indexed by compile-time constants only)
// and constants as literals, and stores each result to every witness row
// that names it, or to its crossing row; the first kernel also writes
// the witness rows that are constants or inputs.  Every row is a literal,
// so the host assembles nothing: no stacked inputs or outputs, no copy of
// the witness.  Neighbouring threads take neighbouring lanes, so every
// limb row is one coalesced line a warp.
//
// Words, not limbs: a value is N = L/2 32-bit words, packed from its two
// limb rows a word once at each load and unpacked once at each store, as
// K1 and KS do.  The card's 32x32->64
// multiply-add gives the CIOS product in 2 N^2 word products (128 at L =
// 16) where 16-bit limbs took 2 L^2 (512), each with a mask, a shift and
// two adds; goldilocks' plain product is one 64x64-bit product folded
// (gl_mul64).  R = 2^(16 L) = 2^(32 N), so the Montgomery values, and the
// rows, are the 16-bit kernels' own.
//
// Bound on the card: a segment of shifts and bit ops (Num2Bits) does a
// few 32-bit operations a word and writes L * 4 bytes a stored row a
// lane, so it is bound by device-memory bytes (operands read once, results
// written once to each of their rows); a segment of products does 4 N^2
// 32-bit instructions a `mul` and is bound by the integer lane rate.  The
// design keeps the bytes at that minimum (no register file in memory,
// unlike K1, and no stacked copy of a segment's inputs or outputs) and
// keeps nvcc's time and the code small: the CIOS product, goldilocks'
// product and the bit ops' conditional subtract are __noinline__
// functions called per use, one product function per distinct constant
// multiplicand (the compiler drops the constant's zero words), the cheap
// ops inline.
//
// Canonical results at every field: operands are canonical (< p < R).
// mul's CIOS (mont_mul32) leaves (x y + M p) / R < (p^2 + R p) / R < 2p
// and subtracts p once (cond_sub32); add (mod_add32) a + b < 2p and sub
// (mod_sub32) a + p - b in [1, 2p), each less p once; bor, bxor (bitop32)
// and bnot (bnot32) give at most p.bit_length() bits, below 2p, less p
// once (reduce_once32); shl_k (shift32) masks to those bits and subtracts
// once; shr_k of a canonical value is below it; gl_mul64 is canonical for
// any 64-bit operands; comparisons and booleans are 0 or 1 (cmp32,
// nonzero32), select and band by a constant no larger than an operand.
// No segment op is a lazy dot.
#include <cuda_runtime.h>

#include <cstdint>

#include "dot32.cuh"
#include "wide32.cuh"

#pragma nv_diag_suppress 177  // a helper or constant a program does not use

namespace {

constexpr int L = %(L)d;       // 16-bit limbs a row
constexpr int N = L / 2;      // 32-bit words a value
constexpr int THREADS = %(threads)d;
constexpr uint32_t N0INV32 = %(n0inv32)du;  // -p^-1 mod 2^32

// p, p / 2 (the sign rule's pivot) and 2^bits - 1 as words: literals in
// every function that uses them
#define K4_P {%(p)s}
#define K4_HALF {%(half)s}
#define K4_MASK {%(mask)s}

struct F {
  uint32_t v[N];
};

__device__ __noinline__ F k4_mul(F a, F b) {
  const uint32_t p[N] = K4_P;
  F r;
  ctpu::mont_mul32<N>(a.v, b.v, p, N0INV32, r.v);
  return r;
}

// bor (OP 1), bxor (OP 2), each less p once
template <int OP>
__device__ __noinline__ F k4_bitop(F a, F b) {
  const uint32_t p[N] = K4_P;
  F r;
  ctpu::bitop32<N, OP>(a.v, b.v, p, r.v);
  return r;
}

__device__ __noinline__ F k4_bnot(F a) {
  const uint32_t p[N] = K4_P, mask[N] = K4_MASK;
  F r;
  ctpu::bnot32<N>(a.v, mask, p, r.v);
  return r;
}

// A row's limbs packed two a word on load and unpacked on store, as
// field32.cuh's pack32 and unpack32 do, but each limb's address written
// (row L + k) B with literal row and k: through pack32's row base and
// stride, nvcc computed Num2Bits(254)'s 4,096 store addresses with 2,030
// IMADs where this form takes 300, and 4 x Num2Bits(254) ran 3 %% slower
// (H100 80GB HBM3, 700 W)
__device__ __forceinline__ F ld(const uint32_t* x, long long row,
                                long long B) {
  F r;
#pragma unroll
  for (int i = 0; i < N; ++i)
    r.v[i] = x[(row * L + 2 * i) * B] | x[(row * L + 2 * i + 1) * B] << 16;
  return r;
}

__device__ __forceinline__ void st(uint32_t* x, long long row, long long B,
                                   const F& r) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[(row * L + 2 * i) * B] = r.v[i] & ctpu::MASK;
    x[(row * L + 2 * i + 1) * B] = r.v[i] >> ctpu::LIMB_BITS;
  }
}

// word i of a value, for shift32: one type for every shift, so that nvcc
// instantiates shift32 once a direction and KEEP, not once a call (a
// lambda is a type of its own at each call)
struct Words {
  const uint32_t* v;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return v[i];
  }
};

__device__ __forceinline__ F bit(bool b) {
  F r;
  r.v[0] = b ? 1u : 0u;
#pragma unroll
  for (int i = 1; i < N; ++i) r.v[i] = 0u;
  return r;
}
"""

GL_MUL = """
__device__ __forceinline__ uint64_t u64(const F& a) {
  return a.v[0] | (uint64_t)a.v[1] << 32;
}

__device__ __forceinline__ F of64(uint64_t r) {
  return F{{(uint32_t)r, (uint32_t)(r >> 32)}};
}

__device__ __noinline__ F k4_gl_mul(F a, F b) {
  return of64(ctpu::gl_mul64(u64(a), u64(b)));
}
"""

CONST_MUL = """
// a * %(value)s (the constant's words are literals: zero words fold away)
__device__ __noinline__ F %(name)s(F a) {
  const uint32_t p[N] = K4_P, c[N] = {%(words)s};
  F r;
  ctpu::mont_mul32<N>(a.v, c, p, N0INV32, r.v);
  return r;
}
"""

CONST_GL_MUL = """
// a * %(value)s mod p, goldilocks
__device__ __noinline__ F %(name)s(F a) {
  return of64(ctpu::gl_mul64(u64(a), %(value)sull));
}
"""

KERNEL = """
#if !defined(K4_SEG) || K4_SEG == %(s)d
__global__ void __launch_bounds__(THREADS)
k4_seg%(s)d(const uint32_t* __restrict__ x, uint32_t* __restrict__ w,
           uint32_t* __restrict__ c, long long B) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= B) return;
  x += lane;
  w += lane;
  c += lane;
  const uint32_t P[N] = K4_P, HALF[N] = K4_HALF, MASK[N] = K4_MASK;
%(body)s
}
"""

ENTRY = """
// segment %(s)d: %(n_instr)d ops, %(n_in)d inputs, %(n_out)d outputs
extern "C" int ctpu_k4_seg%(s)d(const uint32_t* x, uint32_t* w, uint32_t* c,
                               long long B, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + THREADS - 1) / THREADS;
  k4_seg%(s)d<<<(unsigned)blocks, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(x, w, c, B);
  return (int)cudaGetLastError();
}
#endif
"""


def _lits(values):
    return ", ".join(f"{int(v)}u" for v in values)


def _words(x, N):
    """x as N 32-bit words, the lowest first."""
    return tuple((x >> (32 * i)) & 0xFFFFFFFF for i in range(N))


def _value_of(limbs):
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def _loop(stmt):
    return f"#pragma unroll\nfor (int i = 0; i < N; ++i) {stmt}"


class _Gen:
    """Source text of one program: the prelude, the constant-product
    functions (deduplicated), one kernel and one entry point a segment."""

    def __init__(self, field):
        self.field = field
        self.N = field.L // 2
        self.goldilocks = field.p == GOLDILOCKS_P
        self.const_fns = {}     # (kind, value) -> function name
        self.fn_text = []

    def const_product(self, value, kind="mont"):
        """Name of the __noinline__ function a -> a·c of one constant
        operand c (an integer): the Montgomery product a·c·R^-1 ("mont")
        or goldilocks' product a·c mod p ("gl")."""
        key = (kind, value)
        name = self.const_fns.get(key)
        if name is None:
            name = self.const_fns[key] = f"k4_{kind}c{len(self.const_fns)}"
            text = CONST_GL_MUL if kind == "gl" else CONST_MUL
            self.fn_text.append(text % {
                "name": name, "value": hex(value),
                "words": _lits(_words(value, self.N))})
        return name

    def kernel(self, s, seg):
        f = self.field
        need = _needed_words(seg, self.N)
        body = []
        out_var, rf_var = {}, {}
        loads, consts = {}, {}

        def load(buf, row):
            """The variable that holds a row of x, w or c, loaded once."""
            if (buf, row) not in loads:
                loads[buf, row] = f"l{buf}{row}"
                body.append(f"const F l{buf}{row} = ld({buf}, {row}, B);")
            return loads[buf, row]

        def operand(d):
            """(C++ expression of an F, the constant's value or None)."""
            tag, v = d
            if tag == "const":
                value = _value_of(v)
                if value not in consts:
                    consts[value] = f"k{len(consts)}"
                return consts[value], value
            if tag == "in":
                return load(*seg.src[v]), None
            if tag == "out":
                return out_var[v], None
            return rf_var[v], None

        for (tag, v), rows in seg.fill:
            value = operand(("const", v))[0] if tag == "const" \
                else load("x", v)
            body.extend(f"st(%s, %d, B, {value});" % r for r in rows)

        for j, (op, descs, imm, out_row, rf_slot) in enumerate(seg.instrs):
            if op not in OPS:
                raise ValueError(f"K4 has no code for op {op!r}")
            ops = [operand(d) for d in descs]
            (a, ca), (b, cb) = (ops + [(None, None)] * 2)[:2]
            v = f"v{j}"
            if op in ("mul", "mulp"):
                if ca is not None:          # the constant as b, as
                    (a, ca), (b, cb) = (b, cb), (a, ca)   # emit_mul does
                if op == "mulp" and not self.goldilocks:
                    # a·b mod p: a Montgomery product, then · R^2; with a
                    # constant c one Montgomery product by c·R mod p
                    if cb is not None:
                        cr = (cb << (LIMB_BITS * f.L)) % f.p
                        expr = f"{self.const_product(cr)}({a})"
                    else:
                        r2 = self.const_product(_value_of(f.r2_list))
                        expr = f"{r2}(k4_mul({a}, {b}))"
                elif cb is not None:
                    kind = "gl" if op == "mulp" else "mont"
                    expr = f"{self.const_product(cb, kind)}({a})"
                elif op == "mulp":
                    expr = f"k4_gl_mul({a}, {b})"
                else:
                    expr = f"k4_mul({a}, {b})"
                body.append(f"const F {v} = {expr};")
            elif op in ("add", "sub"):
                body.append(f"F {v};")
                body.append(f"ctpu::mod_{op}32<N>({a}.v, {b}.v, P, {v}.v);")
            elif op == "select":
                c, (x, _), (y, _) = a, ops[1], ops[2]
                body.append(f"F {v};")
                body.append("{")
                body.append(f"const bool t = ctpu::nonzero32<N>({c}.v);")
                body.append(_loop(f"{v}.v[i] = t ? {x}.v[i] : {y}.v[i];"))
                body.append("}")
            elif op in CMP:
                body.append(f"const F {v} = bit(ctpu::cmp32<N, "
                            f"ctpu::{CMP[op]}>({a}.v, {b}.v, HALF));")
            elif op == "lnot":
                body.append(f"const F {v} = bit(!ctpu::nonzero32<N>({a}.v));")
            elif op == "band" and (ca is not None or cb is not None):
                # a constant's zero words are the result's, written as
                # literals: the other operand's may be unset (shift32's
                # KEEP)
                (x, _), c = (ops[1], ca) if ca is not None else (ops[0], cb)
                body.append(f"F {v};")
                body.extend(f"{v}.v[{i}] = {x}.v[{i}] & {w}u;" if w
                            else f"{v}.v[{i}] = 0u;"
                            for i, w in enumerate(_words(c, self.N)))
            elif op == "band":
                body.append(f"F {v};")
                body.append(f"ctpu::bitop32<N, 0>({a}.v, {b}.v, P, {v}.v);")
            elif op in ("bor", "bxor"):
                body.append(f"const F {v} = k4_bitop<"
                            f"{1 if op == 'bor' else 2}>({a}, {b});")
            elif op == "bnot":
                body.append(f"const F {v} = k4_bnot({a});")
            else:                           # shl_k, shr_k: a static count
                args = "N, true" if op == "shl_k" else (
                    "N, false" if need[j] == (1 << self.N) - 1
                    else f"N, false, {need[j]:#x}u")
                body.append(f"F {v};")
                body.append(f"ctpu::shift32<{args}>(Words{{{a}.v}}, "
                            f"{int(imm)}, P, MASK, {v}.v);")
            if out_row is not None:
                out_var[out_row] = v
                body.extend(f"st({buf}, {row}, B, {v});"
                            for buf, row in seg.dst[out_row])
            if rf_slot is not None:
                rf_var[rf_slot] = v
        used = set(re.findall(r"\bk\d+\b", "\n".join(body)))
        decls = [f"const F {name} = {{{{{_lits(_words(v, self.N))}}}}};"
                 for v, name in consts.items() if name in used]
        text = "\n".join("  " + line.replace("\n", "\n  ")
                         for line in decls + body)
        return (KERNEL % {"s": s, "body": text}
                + ENTRY % {"s": s, "n_instr": len(seg.instrs),
                           "n_in": len(seg.src),
                           "n_out": len(seg.dst)})


def _needed_words(seg, N):
    """The result words of each instruction that are read later, as a bit
    mask: all of a stored output's; of a value that only a constant `band`
    reads, the constant's nonzero words; of a value that a right shift
    reads, the words behind the shift's needed ones.  The right shifts
    compute only these (shift32's KEEP), so the code of a bit
    decomposition holds one word a bit, not N."""
    full = (1 << N) - 1
    producer, out_of, rf_of = [], {}, {}
    for j, (_op, descs, _imm, out_row, rf_slot) in enumerate(seg.instrs):
        producer.append([out_of.get(d[1]) if d[0] == "out" else
                         rf_of.get(d[1]) if d[0] == "rf" else None
                         for d in descs])
        if out_row is not None:
            out_of[out_row] = j
        if rf_slot is not None:
            rf_of[rf_slot] = j
    need = [full if ins[3] is not None else 0 for ins in seg.instrs]
    for k in range(len(seg.instrs) - 1, -1, -1):
        op, descs, imm, _out_row, _rf = seg.instrs[k]
        consts = [_value_of(d[1]) for d in descs if d[0] == "const"]
        for j in producer[k]:
            if j is None:
                continue
            if op == "band" and consts:
                m = sum(1 << i for i, w in enumerate(_words(consts[0], N))
                        if w)
                need[j] |= m & need[k]
            elif op == "shr_k":
                q, r = divmod(int(imm), 32)
                for i in range(N):
                    if need[k] >> i & 1:
                        need[j] |= (1 << (i + q)) | ((1 << (i + q + 1))
                                                     if r else 0)
                need[j] &= full
            else:
                need[j] = full
    return need


def generate(segments, field):
    """CUDA C++ source of K4 for a program's placed segments
    (SegmentedProgram.kernels) over one field (TorchField): one kernel and
    one entry point ctpu_k4_seg<s> each."""
    if field.L % 2:
        raise ValueError(f"K4 packs pairs of 16-bit limbs into 32-bit "
                         f"words: it takes an even number of limbs, not "
                         f"{field.L}")
    gen = _Gen(field)
    kernels = [gen.kernel(s, seg) for s, seg in enumerate(segments)]
    f, N = field, field.L // 2
    bits = f.p.bit_length()
    prelude = HEADER % {
        "L": f.L, "threads": THREADS, "n0inv32": f.n0inv32,
        "p": _lits(_words(f.p, N)), "half": _lits(_words(f.p // 2, N)),
        "mask": _lits(_words((1 << bits) - 1, N))}
    if gen.goldilocks:
        prelude += GL_MUL
    return (prelude + "".join(gen.fn_text) + "\n}  // namespace\n"
            + "".join(kernels))
