"""Kernel K4: CUDA C++ generated from a SegmentedProgram's segments.

`generate(segments, field)` writes one source per program with one
`__global__` per segment and one C entry point `ctpu_k4_seg<s>` per
segment, each under `#if K4_SEG == s` (ops/build.py `build_generated`
builds a library a segment from the same text, all in parallel: nvcc's
time grows faster than linearly with a kernel's length).
Each kernel is the segment's straight-line instructions for one lane a
thread: operands are `Fe` values (L limbs in registers, indexed only by
compile-time constants), constants are literals, and nothing dispatches
on an opcode or indexes a register file at run time, which is what K4
offers over the interpreter K1.  Every kernel takes the base pointers of
the program's inputs, the witness and the crossing buffer; the row of
each operand it loads and of each result it stores is a literal
(SegmentedProgram._place: `src`, `dst`, `fill`).  The device arithmetic
is field.cuh's and wide.cuh's, called as limb_emit's LimbEmitter.emit
would compute each op; the results equal the plain version
(backend/segments.py `segment_ref`) bit for bit.  The generator handles
every op of backend/plan.KERNEL_OPS but `idiv`, which the segmented
backend refuses.
"""

import re

from ..field.primes import LIMB_BITS
from .field import GOLDILOCKS_P

# the ops a segment may hold: plan.KERNEL_OPS without idiv
CMP = {"eq": "CMP_EQ", "neq": "CMP_NEQ", "lt": "CMP_LT", "le": "CMP_LE",
       "gt": "CMP_GT", "ge": "CMP_GE", "land": "CMP_LAND",
       "lor": "CMP_LOR"}
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
// wrote, or of the crossing buffer c, all (n, L, B)), runs the segment's
// field ops straight through with every temporary in registers (`Fe`,
// indexed by compile-time constants only) and constants as literals, and
// stores each result to every witness row that names it, or to its
// crossing row; the first kernel also writes the witness rows that are
// constants or inputs.  Every row is a literal, so the host assembles
// nothing: no stacked inputs or outputs, no copy of the witness.
// Neighbouring threads take neighbouring lanes, so every limb row is one
// coalesced line a warp.
//
// Bound on the card: a segment of shifts and bit ops (Num2Bits) does a
// few 32-bit operations a limb and writes L * 4 bytes a stored row a
// lane, so it is bound by device-memory bytes (operands read once, results
// written once to each of their rows); a segment of products does 2L^2
// 32-bit multiplies a `mul` and is bound by the integer lane rate.  The
// design keeps the bytes at that minimum (no register file in memory,
// unlike K1, and no stacked copy of a segment's inputs or outputs) and
// keeps nvcc's time and the code small: the CIOS product, goldilocks'
// folded product and the conditional subtract are __noinline__ functions
// called per use, one product function per distinct constant multiplicand
// (the compiler drops the constant's zero limbs), the cheap ops inline.
//
// Canonical results at every field: operands are canonical (< p < R =
// 2^(16 L)); mul's CIOS leaves (x y + M p) / R < 2p and add/sub a value
// below 2p, each subtracting p once; k4_cond_sub follows bor, bxor and
// bnot, whose values have at most p.bit_length() bits, below 2p; shl_k
// masks to those bits and subtracts once (wide.cuh).  No segment op is a
// lazy dot.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "wide.cuh"

#pragma nv_diag_suppress 177  // a helper or constant a program does not use

namespace {

constexpr int L = %(L)d;
constexpr int THREADS = %(threads)d;

__constant__ ctpu::FieldConsts FC = {{%(p)s}, {%(r2)s}, %(n0inv)du};
__constant__ ctpu::WideConsts WC = {{%(half)s}, {%(mask)s}, {%(q)s},
                                    %(bits)d};

template <int N>
struct Fe {
  uint32_t v[N];
};
using F = Fe<L>;

template <int N>
__device__ __noinline__ Fe<N> k4_mul(Fe<N> a, Fe<N> b) {
  Fe<N> r;
  ctpu::mont_mul<N>(a.v, b.v, r.v, FC);
  return r;
}

template <int N>
__device__ __noinline__ Fe<N> k4_cond_sub(Fe<N> a) {
  ctpu::cond_sub<N>(a.v, 0, FC);
  return a;
}

__device__ __forceinline__ F ld(const uint32_t* x, long long row,
                                long long B) {
  F r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = x[(row * L + i) * B];
  return r;
}

__device__ __forceinline__ void st(uint32_t* x, long long row, long long B,
                                   const F& r) {
#pragma unroll
  for (int i = 0; i < L; ++i) x[(row * L + i) * B] = r.v[i];
}

__device__ __forceinline__ F bit(bool b) {
  F r;
  r.v[0] = b ? 1u : 0u;
#pragma unroll
  for (int i = 1; i < L; ++i) r.v[i] = 0u;
  return r;
}
"""

GL_MUL = """
__device__ __noinline__ F k4_gl_mul(F a, F b) {
  F r;
  ctpu::gl_mul(a.v, b.v, r.v, FC);
  return r;
}
"""

CONST_MUL = """
// a * %(value)s (the constant's limbs are literals: zero limbs fold away)
__device__ __noinline__ F %(name)s(F a) {
  const uint32_t c[L] = {%(limbs)s};
  F r;
  %(call)s;
  return r;
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


def _limbs_of(x, L):
    return tuple((x >> (LIMB_BITS * i)) & 0xFFFF for i in range(L))


def _value_of(limbs):
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def _loop(stmt):
    return f"#pragma unroll\nfor (int i = 0; i < L; ++i) {stmt}"


class _Gen:
    """Source text of one program: the prelude, the constant-product
    functions (deduplicated), one kernel and one entry point a segment."""

    def __init__(self, field):
        self.field = field
        self.L = field.L
        self.goldilocks = field.p == GOLDILOCKS_P
        self.const_fns = {}     # (kind, limbs) -> function name
        self.fn_text = []

    def const_product(self, limbs, kind="mont"):
        """Name of the __noinline__ function a -> a·c of one constant
        operand c: the Montgomery product a·c·R^-1 ("mont") or
        goldilocks' folded product a·c ("gl")."""
        key = (kind, tuple(limbs))
        name = self.const_fns.get(key)
        if name is None:
            name = self.const_fns[key] = f"k4_{kind}c{len(self.const_fns)}"
            call = ("ctpu::gl_mul(a.v, c, r.v, FC)" if kind == "gl"
                    else "ctpu::mont_mul<L>(a.v, c, r.v, FC)")
            self.fn_text.append(CONST_MUL % {
                "name": name, "limbs": _lits(limbs), "call": call,
                "value": hex(_value_of(limbs))})
        return name

    def kernel(self, s, seg):
        L = self.L
        f = self.field
        body = []
        out_var, rf_var = {}, {}
        loads, consts = {}, {}
        need = _needed_limbs(seg, L)

        def load(buf, row):
            """The variable that holds a row of x, w or c, loaded once."""
            if (buf, row) not in loads:
                loads[buf, row] = f"l{buf}{row}"
                body.append(f"const F l{buf}{row} = ld({buf}, {row}, B);")
            return loads[buf, row]

        def operand(d):
            """(C++ expression of an Fe, constant limbs or None)."""
            tag, v = d
            if tag == "const":
                if v not in consts:
                    consts[v] = f"k{len(consts)}"
                return consts[v], v
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
                    r2 = self.const_product(f.r2_list)
                    if cb is not None:
                        cr = _value_of(cb) * (1 << (LIMB_BITS * L)) % f.p
                        expr = f"{self.const_product(_limbs_of(cr, L))}({a})"
                    else:
                        expr = f"{r2}(k4_mul<L>({a}, {b}))"
                elif cb is not None:
                    kind = "gl" if op == "mulp" else "mont"
                    expr = f"{self.const_product(cb, kind)}({a})"
                elif op == "mulp":
                    expr = f"k4_gl_mul({a}, {b})"
                else:
                    expr = f"k4_mul<L>({a}, {b})"
                body.append(f"const F {v} = {expr};")
            elif op in ("add", "sub"):
                fn = "mod_add" if op == "add" else "mod_sub"
                body.append(f"F {v};")
                body.append(f"ctpu::{fn}<L>({a}.v, {b}.v, {v}.v, FC);")
            elif op == "select":
                c, (x, _), (y, _) = ops[0][0], ops[1], ops[2]
                if ca is not None:          # a constant condition
                    body.append(f"const F {v} = {x if any(ca) else y};")
                else:
                    body.append(f"F {v};")
                    body.append("{")
                    body.append(f"const bool t = ctpu::nonzero<L>({c}.v);")
                    body.append(_loop(f"{v}.v[i] = t ? {x}.v[i] : {y}.v[i];"))
                    body.append("}")
            elif op in CMP:
                body.append(f"const F {v} = bit(ctpu::cmp_wide<L, "
                            f"ctpu::{CMP[op]}>({a}.v, {b}.v, WC));")
            elif op == "lnot":
                body.append(f"const F {v} = bit(!ctpu::nonzero<L>({a}.v));")
            elif op == "band" and (ca or cb):
                # a constant's zero limbs zero the result's (LimbEmitter
                # ANDs the literal in; here the zero limbs are written)
                (x, _), c = (ops[1], ca) if ca else (ops[0], cb)
                body.append(f"F {v};")
                body.extend(f"{v}.v[{i}] = {x}.v[{i}] & {c[i]}u;" if c[i]
                            else f"{v}.v[{i}] = 0u;" for i in range(L))
            elif op in ("band", "bor", "bxor"):
                sym = {"band": "&", "bor": "|", "bxor": "^"}[op]
                body.append(f"F {v};")
                body.append(_loop(f"{v}.v[i] = {a}.v[i] {sym} {b}.v[i];"))
                if op != "band":
                    body.append(f"{v} = k4_cond_sub<L>({v});")
            elif op == "bnot":
                body.append(f"F {v};")
                body.append(_loop(f"{v}.v[i] = {a}.v[i] ^ WC.mask[i];"))
                body.append(f"{v} = k4_cond_sub<L>({v});")
            else:                           # shl_k, shr_k: a static count
                args = "L, true" if op == "shl_k" else (
                    "L, false" if need[j] == (1 << L) - 1
                    else f"L, false, {need[j]:#x}u")
                body.append(f"F {v};")
                body.append(f"ctpu::shift_w<{args}>({a}.v, 1, {int(imm)}, "
                            f"{v}.v, FC, WC);")
            if out_row is not None:
                out_var[out_row] = v
                body.extend(f"st({buf}, {row}, B, {v});"
                            for buf, row in seg.dst[out_row])
            if rf_slot is not None:
                rf_var[rf_slot] = v
        used = set(re.findall(r"\bk\d+\b", "\n".join(body)))
        decls = [f"const F {name} = {{{{{_lits(v)}}}}};"
                 for v, name in consts.items() if name in used]
        text = "\n".join("  " + line.replace("\n", "\n  ")
                         for line in decls + body)
        return (KERNEL % {"s": s, "body": text}
                + ENTRY % {"s": s, "n_instr": len(seg.instrs),
                           "n_in": len(seg.src),
                           "n_out": len(seg.dst)})


def _needed_limbs(seg, L):
    """The result limbs of each instruction that are read later, as a bit
    mask: all of a stored output's; of a value that only a constant `band`
    reads, the constant's nonzero limbs; of a value that a right shift
    reads, the limbs behind the shift's needed ones.  The right shifts
    compute only these (shift_w's KEEP), so the code of a bit
    decomposition holds one limb a bit, not L."""
    full = (1 << L) - 1
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
        consts = [d[1] for d in descs if d[0] == "const"]
        for j in producer[k]:
            if j is None:
                continue
            if op == "band" and consts:
                m = sum(1 << i for i, c in enumerate(consts[0]) if c)
                need[j] |= m & need[k]
            elif op == "shr_k":
                q, r = divmod(int(imm), LIMB_BITS)
                for i in range(L):
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
    if field.L > 16:
        raise ValueError(f"K4 takes fields of at most 16 limbs (wide.cuh's "
                         f"MAX_L), not {field.L}")
    gen = _Gen(field)
    kernels = [gen.kernel(s, seg) for s, seg in enumerate(segments)]
    f = field
    prelude = HEADER % {
        "L": f.L, "threads": THREADS, "p": _lits(f.p_list),
        "r2": _lits(f.r2_list), "n0inv": f.n0inv,
        "half": _lits(f.half_list), "mask": _lits(f.mask_list),
        "q": _lits(f.q_list), "bits": f.p.bit_length()}
    if gen.goldilocks:
        prelude += GL_MUL
    return (prelude + "".join(gen.fn_text) + "\n}  // namespace\n"
            + "".join(kernels))
