"""The segmented backend: one straight-line kernel per segment of a tape.

The port of the JAX package's backend/segments.py.  The expanded tape
(backend/plan.py) is split into segments of a fixed compute budget, and
each segment runs as ONE kernel over the batch: kernel K4, generated per
program as CUDA C++ (ops/segment_gen.py) with one `__global__` per
segment, constants inlined as literals and the segment's temporaries in
registers.  The planning (`_op_cost`, `_Seg`, `_segment`) is the JAX
package's, step for step, so that both packages cut the same tapes into
the same segments and refuse the same tapes: `idiv` (no loop construct in
straight-line code) and a total cost above MAX_COST (the JAX package
bounds Mosaic's compile time with it; nvcc's compile time grows with the
unrolled code the same way).

Nothing is assembled on the host.  A run allocates the witness
(n_witness, L, B) and one crossing buffer (n_cross, L, B), and each
segment's kernel reads its operands where they lie and writes its results
in place: an operand is a row of the program's inputs, a witness row an
earlier segment wrote, or a crossing row, which holds a value that a
later segment reads and that no witness row holds; a result goes to every
witness row that names it, or to its crossing row.  The witness rows that
are inputs are written by the first kernel that reads the input (else the
first), those that are constants by the first.  `_place` plans those rows
once, at construction, as compile-time constants of the generated source:
`kernels`, one a segment (one with nothing to compute where the tape has
no segment), is what a run launches.  The layout is (n, L, B)
throughout, batch-minor, one lane a thread in the kernel.  The TPU's
(8, B/8) retiling, its padding of the batch to whole (8, 128) tiles and
its stacked segment inputs and outputs are not carried over.

`segment_k4` launches a segment's kernel on CUDA tensors and runs the
plain version `segment_ref` (ops/wide.py, TorchField: the plain functions
K1 is held against) on CPU tensors, with the same in-place contract.
"""

import copy

import torch

from ..convert import u32_on
from ..field.primes import FieldSpec
from ..ops.build import build_generated, launch, stream_ptr
from ..ops.field import GOLDILOCKS_P, TorchField, as_i64, as_u32
from ..ops.limbs import int_to_limbs
from ..ops.wide import emit, gl_mul64, shift_w
from ..utils.device import resolve_device
from .plan import ExpandedTape, UnsupportedTapeOp


# a segment's cost budget: where one segment ends and the next begins
# (results do not depend on it).  The JAX package takes 60,000 for
# Mosaic; nvcc's time on a kernel grows faster than linearly with its
# length (PERF.md, section 6), so the port cuts segments at 24,000
# units, about 600 bit ops or 9 products at bn128, and builds the
# segments' kernels in parallel.
BUDGET = 24_000
# the largest total cost the segments take, the JAX package's: a longer
# tape goes to the per-op backend
MAX_COST = 300_000
# a word no 16-bit limb holds: the oracles fill buffers with it, so that a
# witness row that no kernel wrote shows
UNWRITTEN = -0x21524111      # 0xdeadbeef as int32


def _op_cost(op, nz_b, L):
    """Approximate native-VPU-op count per (8,128) batch tile."""
    if op == "mul":
        return L * (5 * nz_b + 5 * L) + 6 * L
    if op == "mulp":
        return 2 * (L * (5 * nz_b + 5 * L) + 6 * L)
    if op in ("add", "sub"):
        return 6 * L
    if op == "band":
        return L
    if op in ("bor", "bxor", "bnot", "shl_k", "shr_k"):
        return 4 * L
    if op == "select":
        return 2 * L
    return 4 * L  # comparisons / booleans


class _Seg:
    __slots__ = ("instrs", "in_nodes", "out_nodes", "n_rf", "cost")

    def __init__(self):
        self.instrs = []      # (op, arg_descs, imm, out_row, rf_slot)
        self.in_nodes = []
        self.out_nodes = []
        self.n_rf = 0
        self.cost = 0


class _Kernel:
    """One K4 kernel: a segment's instructions and where it reads and
    writes (SegmentedProgram._place).  src[k] is the row of operand
    ("in", k), ("x" | "w" | "c", row) in the inputs, the witness or the
    crossing buffer; dst[k] the rows output k is stored to; fill the
    witness rows it writes from a constant or an input,
    (("const", limbs) | ("x", row), (("w", row), ...))."""

    __slots__ = ("instrs", "n_rf", "src", "dst", "fill")

    def __init__(self, instrs=(), n_rf=0, src=(), dst=(), fill=()):
        self.instrs = instrs
        self.n_rf = n_rf
        self.src = src
        self.dst = dst
        self.fill = fill


class SegmentedProgram:
    """Executable segmented form of a DomainTape for one field on one
    device.

    ``_run(inputs)`` maps uint32 (n_inputs, L, B) to the witness
    (n_witness, L, B), outputs canonical (non-Montgomery).  `segments`
    are the planner's (the JAX package's); `kernels` the K4 kernels a run
    launches in order, one a segment placed, or one that only writes the
    constant and input rows of a tape with nothing to compute."""

    def __init__(self, dtape, spec: FieldSpec, device="cuda", *,
                 budget=BUDGET):
        self.spec = spec
        self.device = resolve_device(device)
        self.field = TorchField(spec, self.device)
        self.L = spec.n_limbs
        self.budget = budget
        self.n_inputs = dtape.n_inputs
        self.xt = ExpandedTape(dtape, spec)
        if any(op == "idiv" and lv
               for op, lv in zip(self.xt.ops, self.xt.live)):
            # long division needs the interpreter's in-kernel loop;
            # the unrolled segment emitter has no loop construct
            raise UnsupportedTapeOp("idiv requires the interpreter "
                                    "backend")
        self._segment()
        self.total_cost = sum(s.cost for s in self.segments)
        if self.total_cost > MAX_COST:
            # unrolled compile time would explode; callers fall back to
            # the per-op backend
            raise UnsupportedTapeOp(
                f"tape too large for unrolled segments "
                f"({self.total_cost} > {MAX_COST} cost units)")
        self.n_witness = len(self.xt.out_ids)
        self._place()
        self._lib = None     # the generated kernels, built at first launch

    def for_field(self, field: TorchField):
        """This program on `field`'s device: the same segments and the same
        generated kernels (each card loads its own copy of a library's
        module, with its constants, at its first launch there)."""
        twin = copy.copy(self)
        twin.field = field
        twin.device = field.device
        return twin

    # ------------------------------------------------------------------
    # planning: split into budgeted segments, assign rows/slots
    # ------------------------------------------------------------------
    def _segment(self):
        xt = self.xt
        n = len(xt.ops)
        L = self.L

        def nz_of(a):
            nz = L
            for x in a:
                if xt.kind[x] == "const":
                    nz = min(nz, sum(
                        1 for v in int_to_limbs(xt.cval[x], L) if v))
            return nz

        node_cost = [0] * n
        comp = []
        for i in range(n):
            if xt.kind[i] == "compute" and xt.live[i]:
                node_cost[i] = _op_cost(xt.ops[i], nz_of(xt.args[i]), L)
                comp.append(i)

        seg_of = [-1] * n
        bounds = []
        cur, acc = [], 0
        for i in comp:
            if acc + node_cost[i] > self.budget and cur:
                bounds.append(cur)
                cur, acc = [], 0
            cur.append(i)
            acc += node_cost[i]
        if cur:
            bounds.append(cur)
        for s, nodes in enumerate(bounds):
            for i in nodes:
                seg_of[i] = s

        out_set = set(xt.out_ids)
        last_seg_use = [-1] * n
        last_local_use = [-1] * n
        for i in comp:
            for a in xt.args[i]:
                last_seg_use[a] = max(last_seg_use[a], seg_of[i])
                if seg_of[a] == seg_of[i]:
                    last_local_use[a] = i

        self.segments = []
        for s, nodes in enumerate(bounds):
            seg = _Seg()
            in_ix, out_ix = {}, {}
            for i in nodes:
                if last_seg_use[i] > s or i in out_set:
                    out_ix[i] = len(out_ix)
            for i in nodes:
                for a in xt.args[i]:
                    if a in in_ix or xt.kind[a] == "const":
                        continue
                    if xt.kind[a] == "input" or seg_of[a] < s:
                        in_ix[a] = len(in_ix)
            # register-file slots for intra-segment temporaries
            rf_of, free, expire = {}, [], {}
            n_rf = 0
            for i in nodes:
                for r in expire.pop(i, ()):
                    free.append(r)
                if i not in out_ix and last_local_use[i] > i:
                    slot = free.pop() if free else n_rf
                    if slot == n_rf:
                        n_rf += 1
                    rf_of[i] = slot
                    expire.setdefault(last_local_use[i], []).append(slot)

            def desc(a):
                if xt.kind[a] == "const":
                    return ("const",
                            tuple(int(x) for x in
                                  int_to_limbs(xt.cval[a], L)))
                if a in in_ix:
                    return ("in", in_ix[a])
                if a in out_ix:
                    return ("out", out_ix[a])
                return ("rf", rf_of[a])

            for i in nodes:
                seg.instrs.append((
                    xt.ops[i],
                    tuple(desc(a) for a in xt.args[i]),
                    xt.imms[i],
                    out_ix.get(i),
                    rf_of.get(i),
                ))
            seg.in_nodes = sorted(in_ix, key=in_ix.get)
            seg.out_nodes = sorted(out_ix, key=out_ix.get)
            seg.n_rf = n_rf
            seg.cost = sum(node_cost[i] for i in nodes)
            self.segments.append(seg)

    def _place(self):
        """`kernels`, each segment placed: its operand rows (`src`), its
        result rows (`dst`) and the witness rows it copies from a constant
        or an input (`fill`).  A result that is a witness value goes to
        every witness row that names it and is read back from the first;
        any other result that a later segment reads gets a crossing row of
        its own.  An input's witness rows go to the first kernel that reads
        the input, which then loads it once for both; the constants' and
        any other input's to the first kernel."""
        xt = self.xt
        rows = {}
        for r, nid in enumerate(xt.out_ids):
            rows.setdefault(nid, []).append(("w", r))
        home, n_cross = {}, 0
        self.kernels = []
        for seg in self.segments:
            dst = []
            for a in seg.out_nodes:
                if a in rows:
                    dst.append(tuple(rows[a]))
                else:
                    dst.append((("c", n_cross),))
                    n_cross += 1
                home[a] = dst[-1][0]
            src = tuple(("x", xt.iidx[a]) if xt.kind[a] == "input"
                        else home[a] for a in seg.in_nodes)
            self.kernels.append(_Kernel(seg.instrs, seg.n_rf, src,
                                        tuple(dst)))
        self.n_cross = n_cross
        if not self.kernels:
            self.kernels.append(_Kernel())
        fill = [[] for _ in self.kernels]
        for nid, rs in rows.items():
            if xt.kind[nid] == "const":
                fill[0].append((("const", tuple(
                    int(v) for v in int_to_limbs(xt.cval[nid], self.L))),
                    tuple(rs)))
            elif xt.kind[nid] == "input":
                x = ("x", xt.iidx[nid])
                k = next((k for k, kn in enumerate(self.kernels)
                          if x in kn.src), 0)
                fill[k].append((x, tuple(rs)))
        for kn, f in zip(self.kernels, fill):
            kn.fill = tuple(f)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def source(self):
        """The CUDA C++ source of this program's K4 kernels."""
        from ..ops.segment_gen import generate

        return generate(self.kernels, self.field)

    def library(self):
        """The built K4 entry points (nvcc at first use, cached by the
        source's hash in the build directory of utils/cache.py)."""
        if self._lib is None:
            self._lib = build_generated(self.source(), len(self.kernels))
        return self._lib

    def _run(self, inputs):
        """uint32 (n_inputs, L, B) -> (n_witness, L, B): the witness and
        the crossing buffer allocated, then one K4 launch a kernel of
        `kernels`, in order, each writing its rows in place."""
        x = u32_on(inputs, self.device).contiguous()
        if x.dim() != 3 or tuple(x.shape[:2]) != (self.n_inputs, self.L):
            raise ValueError(f"the segments take uint32 ({self.n_inputs}, "
                             f"{self.L}, B) inputs, got {tuple(x.shape)}")
        wit, cross = self.buffers(x.shape[-1])
        if wit.numel():
            for s in range(len(self.kernels)):
                segment_k4(self, s, x, wit, cross)
        return wit

    def buffers(self, B, fill=None):
        """(the witness (n_witness, L, B), the crossing buffer
        (n_cross, L, B)), uint32 on the program's device: uninitialised,
        or every word `fill`, an int32 (UNWRITTEN for an oracle)."""
        return tuple(
            (torch.empty((n, self.L, B), dtype=torch.int32,
                         device=self.device) if fill is None else
             torch.full((n, self.L, B), fill, dtype=torch.int32,
                        device=self.device)).view(torch.uint32)
            for n in (self.n_witness, self.n_cross))

    def stats(self):
        return {
            "segments": len(self.segments),
            "nodes": sum(len(s.instrs) for s in self.segments),
            "cost": self.total_cost,
            "max_in": max((len(s.in_nodes) for s in self.segments),
                          default=0),
            "max_out": max((len(s.out_nodes) for s in self.segments),
                           default=0),
            "max_rf": max((s.n_rf for s in self.segments), default=0),
        }


def segment_k4(prog: SegmentedProgram, s, x, wit, cross):
    """Kernel s of prog.kernels on the inputs x (n_inputs, L, B), writing
    its rows of the witness wit (n_witness, L, B) and of the crossing
    buffer cross (n_cross, L, B) in place, all uint32: K4 on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return segment_ref(prog.field, prog.kernels[s], x, wit, cross)
    L, B = prog.L, x.shape[-1]
    for t, n, what in ((x, prog.n_inputs, "inputs"),
                       (wit, prog.n_witness, "witness"),
                       (cross, prog.n_cross, "crossing buffer")):
        if t.dtype != torch.uint32 or tuple(t.shape) != (n, L, B) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"K4 takes contiguous uint32 {what} ({n}, {L}, "
                             f"{B}) on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if B:
        launch_k4(prog, s, x, wit, cross)


def launch_k4(prog: SegmentedProgram, s, x, wit, cross):
    """Launch kernel s of prog.kernels without checks: contiguous uint32
    x (n_inputs, L, B), wit (n_witness, L, B) and cross (n_cross, L, B)
    on one card, B > 0."""
    launch("k4", getattr(prog.library(), f"ctpu_k4_seg{s}"), x.device,
           x.data_ptr(), wit.data_ptr(), cross.data_ptr(), x.shape[-1],
           stream_ptr(x.device))


def segment_ref(field: TorchField, seg, x, wit, cross):
    """The plain version of K4: one kernel's (a _Kernel's) instructions on int64 limb
    tensors, each op by the plain function K1 is held against (ops/wide.py
    `emit` and `shift_w`, TorchField's Montgomery product, `gl_mul64`);
    operands ("const", limbs), ("in", k), ("out", k), ("rf", k) read as
    the Pallas kernel reads them, ("in", k) from its row seg.src[k] of x,
    wit or cross.  Writes each output to its rows seg.dst[k] and the
    witness rows of seg.fill, in place, as K4 does: uint32 x
    (n_inputs, L, B), wit (n_witness, L, B), cross (n_cross, L, B)."""
    bufs = {"x": x, "w": wit, "c": cross}
    L, B = wit.shape[1], wit.shape[2]
    dev = wit.device
    r2 = torch.as_tensor(field.r2_list, dtype=torch.int64,
                         device=dev)[:, None]

    def const(limbs):
        return torch.as_tensor(limbs, dtype=torch.int64, device=dev)[:, None]

    def store(rows, r):
        r = as_u32(r.expand(L, B)).view(torch.int32)
        for buf, row in rows:
            bufs[buf].view(torch.int32)[row] = r

    for (tag, v), rows in seg.fill:
        store(rows, const(v) if tag == "const" else as_i64(x[v]))
    out = [None] * len(seg.dst)
    rf = [None] * seg.n_rf

    def rd(d):
        tag, v = d
        if tag == "const":
            return const(v)
        if tag == "in":
            buf, row = seg.src[v]
            return as_i64(bufs[buf][row])
        if tag == "out":
            return out[v]
        return rf[v]

    for (op, descs, imm, out_row, rf_slot) in seg.instrs:
        a = [rd(d) for d in descs]
        if op == "mul":
            r = field.mont_mul64(a[0], a[1])
        elif op == "mulp":
            r = gl_mul64(field, a[0], a[1]) if field.p == GOLDILOCKS_P \
                else field.mont_mul64(field.mont_mul64(a[0], a[1]), r2)
        elif op in ("shl_k", "shr_k"):
            r = shift_w(field, a[0], imm, op == "shl_k")
        else:
            r = emit(field, op, *a)
        r = r.expand(L, B)
        if out_row is not None:
            out[out_row] = r
            store(seg.dst[out_row], r)
        if rf_slot is not None:
            rf[rf_slot] = r
