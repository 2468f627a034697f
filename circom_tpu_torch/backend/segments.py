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

Values that cross a segment boundary travel as one stacked tensor
(n_in, L, B) per segment; the layout is (n, L, B) throughout, batch-minor,
one lane a thread in the kernel.  The TPU's (8, B/8) retiling and its
padding of the batch to whole (8, 128) tiles are not carried over.

`segment_k4` launches a segment's kernel on a CUDA tensor and runs the
plain version `segment_ref` (ops/wide.py, TorchField: the plain functions
K1 is held against) on a CPU tensor.
"""

import copy

import numpy as np
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


class SegmentedProgram:
    """Executable segmented form of a DomainTape for one field on one
    device.

    ``_run(inputs)`` maps uint32 (n_inputs, L, B) to the witness
    (n_witness, L, B), outputs canonical (non-Montgomery)."""

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

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def source(self):
        """The CUDA C++ source of this program's K4 kernels."""
        from ..ops.segment_gen import generate

        return generate(self.segments, self.field)

    def library(self):
        """The built K4 entry points (nvcc at first use, cached by the
        source's hash in the build directory of utils/cache.py)."""
        if self._lib is None:
            self._lib = build_generated(self.source(), len(self.segments))
        return self._lib

    def _run(self, inputs):
        """uint32 (n_inputs, L, B) -> (n_witness, L, B)."""
        L = self.L
        xt = self.xt
        x = u32_on(inputs, self.device).view(torch.int32)
        B = x.shape[-1]
        vals = {}
        for s, seg in enumerate(self.segments):
            parts = []
            for a in seg.in_nodes:
                if xt.kind[a] == "input":
                    parts.append(x[xt.iidx[a]])
                else:
                    arr, row = vals[a]
                    parts.append(arr[row])
            xin = torch.stack(parts) if parts else torch.zeros(
                (1, L, B), dtype=torch.int32, device=x.device)
            out = segment_k4(self, s, xin.view(torch.uint32))
            for row, a in enumerate(seg.out_nodes):
                vals[a] = (out.view(torch.int32), row)

        rows = []
        for nid in xt.out_ids:
            k = xt.kind[nid]
            if k == "const":
                limb = torch.as_tensor(
                    int_to_limbs(xt.cval[nid], L).astype(np.int32),
                    device=x.device)
                rows.append(limb[:, None].expand(L, B))
            elif k == "input":
                rows.append(x[xt.iidx[nid]])
            else:
                arr, row = vals[nid]
                rows.append(arr[row])
        if not rows:
            return torch.empty((0, L, B), dtype=torch.uint32,
                               device=x.device)
        return torch.stack(rows).view(torch.uint32)

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


def segment_k4(prog: SegmentedProgram, s, xin):
    """Segment s of prog on its inputs uint32 (n_in, L, B) -> its outputs
    uint32 (n_out, L, B): kernel K4 on a CUDA tensor, the plain version
    on a CPU tensor."""
    seg = prog.segments[s]
    if xin.device.type == "cpu":
        return segment_ref(prog.field, seg, xin)
    L = prog.L
    if xin.dtype != torch.uint32 or xin.dim() != 3 or xin.shape[1] != L \
            or xin.shape[0] != max(len(seg.in_nodes), 1):
        raise ValueError(f"K4 segment {s} takes uint32 "
                         f"({max(len(seg.in_nodes), 1)}, {L}, B), got "
                         f"{xin.dtype} {tuple(xin.shape)}")
    xin = xin.contiguous()
    B = xin.shape[-1]
    out = torch.empty((len(seg.out_nodes), L, B), dtype=torch.uint32,
                      device=xin.device)
    if out.numel():
        launch_k4(prog, s, xin, out)
    return out


def launch_k4(prog: SegmentedProgram, s, xin, out):
    """Launch segment s's K4 without checks: contiguous uint32 xin
    (n_in, L, B) and out (n_out, L, B) on the card, n_out and B > 0."""
    launch("k4", getattr(prog.library(), f"ctpu_k4_seg{s}"), xin.device,
           xin.data_ptr(), out.data_ptr(), xin.shape[-1],
           stream_ptr(xin.device))


def segment_ref(field: TorchField, seg, xin):
    """The plain version of K4: one segment's instructions on int64 limb
    tensors, each op by the plain function K1 is held against (ops/wide.py
    `emit` and `shift_w`, TorchField's Montgomery product, `gl_mul64`);
    operands ("const", limbs), ("in", k), ("out", k), ("rf", k) read as
    the Pallas kernel reads them.  uint32 (n_in, L, B) -> (n_out, L, B)."""
    x = as_i64(xin)
    L, B = x.shape[1], x.shape[2]
    out = torch.zeros((len(seg.out_nodes), L, B), dtype=torch.int64,
                      device=x.device)
    rf = [None] * seg.n_rf
    r2 = torch.as_tensor(field.r2_list, dtype=torch.int64,
                         device=x.device)[:, None]

    def rd(d):
        tag, v = d
        if tag == "const":
            return torch.as_tensor(v, dtype=torch.int64,
                                   device=x.device)[:, None]
        if tag == "in":
            return x[v]
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
        if rf_slot is not None:
            rf[rf_slot] = r
    return as_u32(out)
