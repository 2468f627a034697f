"""WitnessProgram: a witness tape made executable on one device.

The port of the JAX package's backend/jax_backend.py WitnessProgram: the
tape's dynamic ops are lowered, range analysis marks the narrow nodes,
DomainTape assigns Montgomery and canonical domains, and one of three
backends runs it, chosen as the JAX package chooses (`jax_backend.py`
:220-253):

1. the in-kernel interpreter (TorchInterpreter: kernels K1, K2 and K3),
   unless its planner refuses the tape (register files beyond the JAX
   kernel's VMEM budget);
2. the segments (SegmentedProgram: kernel K4, generated per program),
   unless the tape holds a live `idiv` or its unrolled cost is above
   segments.MAX_COST;
3. the per-op executors: a tape of up to `unroll_threshold` ops runs
   straight-line (PerOpProgram, JAX's `_run_ssa`), a longer one on the
   scan (ScanProgram, JAX's `lax.scan` path).  On the card either run is
   one launch of kernel KS over the tape's live nodes (backend/ks.py);
   on the CPU each runs its plain version (a field-library call a live
   node; steps of same-(level, opcode) nodes over a register file).  The
   JAX entry points pass `unroll_threshold=0`, and so do the port's.

The choice depends on the tape and the threshold alone: it is made at
construction from the planners' refusals (NotImplementedError /
UnsupportedTapeOp), never from whether a kernel builds or launches, so
both packages send every tape to the same executor.  On the CPU each
executor runs its kernels' plain versions; nothing falls back to another
executor on the card.
"""

import copy

import numpy as np
import torch

from ..convert import plan_from_arrays
from ..field.primes import FieldSpec
from ..ops.field import GOLDILOCKS_P, TorchField
from ..ops.limbs import ints_to_limbs, limbs_to_int
from ..utils.device import resolve_device
from ..utils.profiling import span
from .domain import DomainTape
from .dynops import lower_dynamic_ops
from .interp import TorchInterpreter
from .interp_plan import InterpreterPlan
from .perop import PerOpProgram
from .plan import UnsupportedTapeOp
from .ranges import narrow_nodes
from .scan import ScanProgram, schedule
from .segments import SegmentedProgram

MODES = ("auto", "interp", "segments", "scan")


def domain_tape(tape, spec: FieldSpec, input_ranges=None):
    """The DomainTape of a lowered tape, with the planner's range
    results, as the JAX package's WitnessProgram builds it."""
    nset, rng = narrow_nodes(tape, input_ranges or {})
    return DomainTape(tape, narrow=nset, plain_field=spec.p == GOLDILOCKS_P,
                      node_rng=rng)


def interp_plan(dt, spec: FieldSpec, input_ranges=None):
    """The InterpreterPlan of a DomainTape; UnsupportedTapeOp when the
    planner refuses the tape."""
    try:
        return InterpreterPlan(dt, spec, input_ranges=input_ranges or {})
    except NotImplementedError as e:
        raise UnsupportedTapeOp(
            f"the interpreter planner refuses this tape: {e}") from e


def build_plan(tape, spec: FieldSpec, input_ranges=None):
    """(DomainTape, InterpreterPlan) of a lowered tape, as the JAX
    package's WitnessProgram builds them."""
    dt = domain_tape(tape, spec, input_ranges)
    return dt, interp_plan(dt, spec, input_ranges)


class WitnessProgram:
    """Executable form of a tape for one field on one device.

    mode: "auto" tries the interpreter, then the segments, then the
    per-op executors; "interp" and "segments" raise UnsupportedTapeOp
    when their backend refuses the tape; "scan" takes the per-op
    executors.  `fused` is the TorchInterpreter, the SegmentedProgram or
    None; without it, `unroll` (len(dt.ops) <= unroll_threshold, as in
    JAX) picks `perop`, the straight-line path, else `scan`, planned
    here with `slots` slots a step."""

    def __init__(self, tape, spec: FieldSpec, device="cuda",
                 input_ranges=None, mode="auto", unroll_threshold=4096,
                 slots=8):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.device = resolve_device(device)
        tape = lower_dynamic_ops(tape)
        self.spec = spec
        self.field = TorchField(spec, self.device)
        self.input_ranges = input_ranges or {}
        self.dt = domain_tape(tape, spec, self.input_ranges)
        self.n_inputs = tape.n_inputs
        self.slots = max(1, slots)
        self.fused = self.plan = self.interp = self.perop = self.scan = None
        if mode in ("auto", "interp"):
            try:
                self.plan = interp_plan(self.dt, spec, self.input_ranges)
            except UnsupportedTapeOp:
                if mode == "interp":
                    raise
            else:
                self.fused = self.interp = TorchInterpreter(
                    plan_from_arrays(self.plan.plan_arrays(), self.device),
                    self.field)
        if self.fused is None and mode in ("auto", "segments"):
            try:
                self.fused = SegmentedProgram(self.dt, spec, self.device)
            except NotImplementedError:
                if mode == "segments":
                    raise
        self.unroll = len(self.dt.ops) <= unroll_threshold
        if self.fused is None and self.unroll:
            self.perop = PerOpProgram(self.dt, self.field)
        elif self.fused is None:
            self.scan = ScanProgram(schedule(self.dt, self.slots),
                                    self.field, self.dt)
        self.n_witness = len(self.dt.outputs)
        # trailing guard outputs from predicated while unrolling: the
        # caller must check these rows are zero (see pipeline.build_tape)
        self.n_guards = getattr(tape, "n_guards", 0)
        # this program on each device it was asked for, itself included
        # (shared by every copy)
        self._copies = {self.device: self}

    def for_device(self, device):
        """This program on `device`: the same DomainTape and plan, whose
        host tables (the interpreter's plan arrays, the segments, the
        straight-line path's constants, the scan's schedule) are carried
        there; nothing is planned again.  One copy a device, kept: shards
        on one device share it."""
        device = resolve_device(device)
        twin = self._copies.get(device)
        if twin is None:
            twin = copy.copy(self)
            twin.device = device
            twin.field = TorchField(self.spec, device)
            if self.interp is not None:
                twin.fused = twin.interp = TorchInterpreter(
                    self.interp.plan.to(device), twin.field)
            elif self.fused is not None:
                twin.fused = self.fused.for_field(twin.field)
            elif self.scan is not None:
                twin.scan = self.scan.for_field(twin.field)
            else:
                twin.perop = self.perop.for_field(twin.field)
            self._copies[device] = twin
        return twin

    def run(self, inputs):
        """uint32 (n_inputs, L, B) array or tensor -> witness uint32
        tensor (n_witness, L, B) on the program's device."""
        with span("ctpu.run"):
            return self._run(inputs)

    def _run(self, inputs):
        if self.fused is not None:
            return self.fused._run(inputs)
        if self.scan is not None:
            return self.scan._run(inputs)
        return self.perop._run(inputs)

    def run_mixed(self, inputs):
        """Witness in MIXED representation: (narrow int32 tensor (n_nw, B),
        wide uint32 tensor (n_wd, L, B)) on the program's device, rows in
        the order of mixed_layout().  inputs: uint32 (n_inputs, L, B), or
        (n_inputs, 2, B) when every input is narrow (range-hinted).  A
        bit-class witness value stays one int32: the SHA256 witness at
        batch 65,536 takes 7.2 GB so, against 115 GB in limbs.  Only the
        interpreter produces a narrow part; the other backends return
        every row wide."""
        with span("ctpu.run_mixed"):
            if self.interp is not None:
                return self.interp._run_mixed(inputs)
            wide = self._run(inputs)
            return (torch.zeros((0, wide.shape[2]), dtype=torch.int32,
                                device=wide.device), wide)

    def mixed_layout(self):
        """(narrow witness indices, wide witness indices) matching the row
        order of run_mixed's two arrays."""
        if self.interp is not None:
            return self.interp.mixed_layout()
        return [], list(range(self.n_witness))

    # -- host-side convenience ------------------------------------------
    def encode_inputs(self, columns):
        """columns: list (len n_inputs) of lists of ints (len batch)
        -> uint32 (n_inputs, L, batch)."""
        L = self.field.L
        arrs = [ints_to_limbs(col, L).T.copy() for col in columns]
        return np.stack(arrs, axis=0)

    def decode_outputs(self, arr):
        """(n_outputs, L, batch) -> list of lists of ints [output][batch]."""
        if isinstance(arr, torch.Tensor):
            arr = arr.view(torch.int32).cpu().numpy().view(np.uint32)
        arr = np.asarray(arr)
        return [
            [limbs_to_int(arr[i, :, j]) for j in range(arr.shape[2])]
            for i in range(arr.shape[0])
        ]
