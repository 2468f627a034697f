"""WitnessProgram: a witness tape made executable on one device.

The port of the JAX package's backend/jax_backend.py WitnessProgram for its
interpreter mode: the tape's dynamic ops are lowered, range analysis marks
the narrow nodes, DomainTape assigns Montgomery and canonical domains, the
interpreter planner builds the tables, and TorchInterpreter runs them
(kernels K1, K2 and K3 on CUDA, the plain executor on the CPU).

Every plan the interpreter planner produces runs (kernel K1 takes all of
its opcodes).  A tape the planner refuses (its register files exceed the
JAX kernel's VMEM budget) raises UnsupportedTapeOp; the JAX package runs
such tapes on its segmented and per-op backends, which the port does not
have yet.  Nothing falls back to another executor on the card.
"""

import numpy as np
import torch

from ..convert import plan_from_arrays
from ..field.primes import FieldSpec
from ..ops.field import GOLDILOCKS_P, TorchField
from ..ops.limbs import ints_to_limbs, limbs_to_int
from ..utils.device import resolve_device
from .domain import DomainTape
from .dynops import lower_dynamic_ops
from .interp import TorchInterpreter
from .interp_plan import InterpreterPlan
from .plan import UnsupportedTapeOp
from .ranges import narrow_nodes


def build_plan(tape, spec: FieldSpec, input_ranges=None):
    """(DomainTape, InterpreterPlan) of a lowered tape, as the JAX
    package's WitnessProgram builds them."""
    input_ranges = input_ranges or {}
    nset, rng = narrow_nodes(tape, input_ranges)
    dt = DomainTape(tape, narrow=nset, plain_field=spec.p == GOLDILOCKS_P,
                    node_rng=rng)
    try:
        return dt, InterpreterPlan(dt, spec, input_ranges=input_ranges)
    except NotImplementedError as e:
        raise UnsupportedTapeOp(
            f"the interpreter planner refuses this tape: {e}") from e


class WitnessProgram:
    """Executable form of a tape for one field on one device."""

    def __init__(self, tape, spec: FieldSpec, device="cuda",
                 input_ranges=None):
        self.device = resolve_device(device)
        tape = lower_dynamic_ops(tape)
        self.spec = spec
        self.field = TorchField(spec, self.device)
        self.input_ranges = input_ranges or {}
        self.dt, self.plan = build_plan(tape, spec, self.input_ranges)
        self.n_inputs = tape.n_inputs
        self.interp = TorchInterpreter(
            plan_from_arrays(self.plan.plan_arrays(), self.device),
            self.field)
        self.n_witness = len(self.dt.outputs)
        # trailing guard outputs from predicated while unrolling: the
        # caller must check these rows are zero (see pipeline.build_tape)
        self.n_guards = getattr(tape, "n_guards", 0)

    def run(self, inputs):
        """uint32 (n_inputs, L, B) array or tensor -> witness uint32
        tensor (n_witness, L, B) on the program's device."""
        return self.interp._run(inputs)

    def run_mixed(self, inputs):
        """Witness in MIXED representation: (narrow int32 tensor (n_nw, B),
        wide uint32 tensor (n_wd, L, B)) on the program's device, rows in
        the order of mixed_layout().  inputs: uint32 (n_inputs, L, B), or
        (n_inputs, 2, B) when every input is narrow (range-hinted).  A
        bit-class witness value stays one int32: the SHA256 witness at
        batch 65,536 takes 7.2 GB so, against 115 GB in limbs."""
        return self.interp._run_mixed(inputs)

    def mixed_layout(self):
        """(narrow witness indices, wide witness indices) matching the row
        order of run_mixed's two arrays."""
        return self.interp.mixed_layout()

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
