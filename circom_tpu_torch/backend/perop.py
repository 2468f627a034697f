"""The per-op backend: the straight-line path over a tape's live nodes.

The port of the JAX package's straight-line per-op path
(backend/jax_backend.py `WitnessProgram._run_ssa`) for the tapes that
both fused backends refuse.  On the card a run is one launch of kernel
KS (ops/cuda/scan.cu) over the tables backend/ks.py builds from the
DomainTape's live nodes, as the scan executor's is: no field op runs in
plain PyTorch there, and no node is a launch of its own.

On the CPU a run takes KS's plain version, the per-node path
(`run_nodes`): each node that reaches a witness output is one call of
the per-op library (ops/field.py `TorchField`), each value freed after
its last use, an output row written into the witness as soon as it is
computed.  It runs on any device when it is called by name (on the card
its products, adds and subtracts are K5 and K6, the rest plain PyTorch):
the tests and chip_smoke.py hold KS against it.

Longer tapes (above WitnessProgram's `unroll_threshold`) go to the scan
executor (backend/scan.py), as the JAX package sends them to its scan;
both plain versions compute a node with `node_value`.
"""

import copy

import numpy as np
import torch

from ..convert import move, u32_on
from ..field.primes import LIMB_BITS
from ..ops import field_kernels as fk
from ..ops.field import TorchField
from ..ops.limbs import int_to_limbs
from .domain import MONT
from .ks import KsProgram


class PerOpProgram:
    """Executable per-op form of a DomainTape on one field's device: KS
    on the card (`ks`, a KsProgram), the per-node path on the CPU."""

    def __init__(self, dt, field: TorchField):
        self.dt = dt
        self.field = field
        self.ks = KsProgram(dt, field)
        self.L = field.L
        self.n_witness = len(dt.outputs)
        n = len(dt.ops)
        live = [False] * n
        stack = list(dt.outputs)
        while stack:
            i = stack.pop()
            if not live[i]:
                live[i] = True
                stack.extend(dt.args[i])
        self.order = [i for i in range(n) if live[i]]
        # the last node that reads each value (outputs are written out
        # at once, so being an output does not keep a value alive)
        self.last_use = {i: i for i in self.order}
        for i in self.order:
            for a in dt.args[i]:
                self.last_use[a] = i
        self.out_pos = {}
        for w, o in enumerate(dt.outputs):
            self.out_pos.setdefault(o, []).append(w)
        R = 1 << (LIMB_BITS * self.L)
        self.consts = {}
        for i in self.order:
            if dt.ops[i] == "const":
                v = dt.imms[i]
                if dt.domains[i] == MONT:
                    v = v * R % field.p
                self.consts[i] = torch.as_tensor(
                    int_to_limbs(v, self.L).astype(np.int32),
                    device=field.device)[:, None].view(torch.uint32)

    def for_field(self, field: TorchField):
        """This program on `field`'s device: the same order and last uses,
        the constants copied there."""
        twin = copy.copy(self)
        twin.field = field
        twin.consts = {i: move(c, field.device)
                       for i, c in self.consts.items()}
        twin.ks = self.ks.for_field(field)
        return twin

    def n_live(self):
        return len(self.order)

    def _run(self, inputs):
        """uint32 (n_inputs, L, B), an array or a tensor -> witness uint32
        (n_witness, L, B) on the field's device: KS on the card, the
        per-node path on the CPU."""
        if self.field.device.type == "cpu":
            return self.run_nodes(inputs)
        return self.ks.run(inputs)

    def run_nodes(self, inputs):
        """KS's plain version: a library call a live node, on the field's
        device."""
        dt = self.dt
        x = u32_on(inputs, self.field.device).view(torch.int32)
        B = x.shape[-1]
        out = torch.empty((self.n_witness, self.L, B), dtype=torch.int32,
                          device=x.device)
        vals = {}
        for i in self.order:
            op = dt.ops[i]
            if op == "const":
                v = self.consts[i]
            elif op == "input":
                v = x[dt.imms[i]].view(torch.uint32)
            else:
                v = node_value(self.field, op,
                               [vals[a] for a in dt.args[i]], dt.imms[i])
            for w in self.out_pos.get(i, ()):
                out[w] = v.view(torch.int32)
            if self.last_use[i] > i:
                vals[i] = v
            for a in set(dt.args[i]):
                if self.last_use[a] == i:
                    del vals[a]
        return out.view(torch.uint32)


def node_value(f: TorchField, op, a, imm):
    """The value of a compute node of opcode `op` from its operands'
    values `a` (uint32 limb tensors) and its immediate: one call of the
    per-op library."""
    if op == "mul":
        return fk.mont_mul(f, a[0], a[1])
    if op == "add":
        return fk.add(f, a[0], a[1])
    if op == "sub":
        return fk.sub(f, a[0], a[1])
    if op == "to_mont":
        return fk.to_mont(f, a[0])
    if op == "from_mont":
        return fk.from_mont(f, a[0])
    if op == "mulp":
        return f.mul_norm(a[0], a[1])
    if op == "div":
        return f.div_mont(a[0], a[1])
    if op == "pow_k":
        return f.pow_mont(a[0], imm)
    if op == "mod":
        return f.imod(a[0], a[1])
    if op == "shl_k":
        return f.shift_l_const(a[0], imm)
    if op == "shr_k":
        return f.shift_r_const(a[0], imm)
    method = _METHODS.get(op)
    if method is None:
        raise NotImplementedError(op)
    return getattr(f, method)(*a)


# ops whose per-op method takes the operands alone
_METHODS = {
    "neg": "neg", "idiv": "idiv", "select": "select",
    "band": "bit_and", "bor": "bit_or", "bxor": "bit_xor",
    "bnot": "complement", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
    "eq": "eq", "neq": "neq", "land": "bool_and", "lor": "bool_or",
    "lnot": "bool_not",
}
