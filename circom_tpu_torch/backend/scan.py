"""The scan executor: a witness tape run as steps of packed nodes.

The port of the JAX package's scan path (backend/jax_backend.py
`WitnessProgram._schedule_and_allocate`, `_branch`, `_init_regfile` and
`_run`), which runs the long tapes that both fused backends refuse.
`schedule` packs the compute nodes of one dataflow level and one opcode
into steps of up to `slots` slots and gives each value a register by
linear-scan liveness, with the same tables, element for element, as the
JAX package.  `ScanProgram` runs them.

On the card a run is one launch of kernel KS (ops/cuda/scan.cu) over
tables that backend/ks.py builds from the same DomainTape: KS's own
schedule of the live nodes, not JAX's, since a witness does not depend on
the order its nodes run in.

On the CPU a run takes KS's plain version, the step loop (`run_loop`)
over JAX's schedule: the register file (n_regs, L, B) and a witness
buffer (n_witness + 1, L, B); a step gathers its operands (S, L, B), computes them with one call of
the per-op library (ops/field.py `TorchField`), and writes the S results
into their registers and witness rows.  Padding slots read register 0 and
write the trash register and the trash row.  The loop runs on any device
when it is called by name (on the card its gathers are K2, its products,
adds and subtracts K5 and K6): the tests and chip_smoke.py hold KS
against it.
"""

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_device, u32_on
from ..field.primes import LIMB_BITS
from ..ops.field import TorchField
from ..ops.limbs import int_to_limbs
from .domain import MONT
from .interp import launch_gather_w
from .interp_ref import gather_rows
from .ks import KsProgram, arity
from .perop import node_value


@dataclass
class Schedule:
    """The scan's tables, as the JAX WitnessProgram's attributes of the
    same names: `tables` is (opc, a_i, b_i, c_i, o_i, w_i, imm), int32
    (n_steps,) and (n_steps, slots) arrays, opc indexing `branch_ops`;
    `n_regs` counts the trash register (the last), and row n_witness of
    the witness buffer is the trash row."""
    slots: int
    tables: tuple
    const_loads: list     # (register, value, domain)
    input_loads: list     # (register, input index)
    out_dups: list        # (witness row written by a step, its copy)
    load_outputs: list    # (register of a const or input, [witness rows])
    out_regs: np.ndarray
    n_regs: int
    n_steps: int
    n_witness: int
    branch_ops: list


def schedule(dt, slots) -> Schedule:
    """Pack the DomainTape's compute nodes, dead ones included, into
    steps of same-(level, opcode) nodes of up to `slots` each, and
    allocate registers over the steps (`_schedule_and_allocate`,
    jax_backend.py:261-388).  An immediate >= 2^31 raises
    NotImplementedError."""
    n = len(dt.ops)
    S = max(1, slots)
    level = [0] * n
    compute_nodes = []
    for i in range(n):
        if dt.ops[i] in ("const", "input"):
            continue
        level[i] = max((level[a] + 1 for a in dt.args[i]), default=0)
        compute_nodes.append(i)
    # group by (level, opcode), in a deterministic order
    compute_nodes.sort(key=lambda i: (level[i], dt.ops[i], i))
    steps_nodes = []
    j = 0
    while j < len(compute_nodes):
        key = (level[compute_nodes[j]], dt.ops[compute_nodes[j]])
        k = j
        while (k < len(compute_nodes) and k - j < S
               and (level[compute_nodes[k]], dt.ops[compute_nodes[k]])
               == key):
            k += 1
        steps_nodes.append((key[1], compute_nodes[j:k]))
        j = k
    pos = [-1] * n                # the step of each node; loads at -1
    for si, (_op, nodes) in enumerate(steps_nodes):
        for i in nodes:
            pos[i] = si
    # a step streams its outputs into the witness buffer, so being an
    # output does not extend a register's life
    out_pos = {}
    for w, o in enumerate(dt.outputs):
        out_pos.setdefault(o, []).append(w)
    n_witness = len(dt.outputs)
    last_use = list(pos)
    for i in range(n):
        for a in dt.args[i]:
            last_use[a] = max(last_use[a], pos[i])
    INF = len(steps_nodes) + 1
    for o in dt.outputs:
        if dt.ops[o] in ("const", "input"):
            last_use[o] = INF     # copied to the witness at the start
    reg_of = [None] * n
    free = []
    next_reg = 0
    expiring = [[] for _ in range(len(steps_nodes) + 2)]
    const_loads, input_loads = [], []
    for i in range(n):
        if dt.ops[i] in ("const", "input"):
            reg_of[i] = next_reg
            if last_use[i] < INF:
                expiring[last_use[i] + 1].append(next_reg)
            if dt.ops[i] == "const":
                const_loads.append((next_reg, dt.imms[i], dt.domains[i]))
            else:
                input_loads.append((next_reg, dt.imms[i]))
            next_reg += 1
    for si, (_op, nodes) in enumerate(steps_nodes):
        free.extend(expiring[si])
        for i in nodes:
            if free:
                reg = free.pop()
            else:
                reg = next_reg
                next_reg += 1
            reg_of[i] = reg
            if last_use[i] < INF:
                expiring[last_use[i] + 1].append(reg)
    trash = next_reg
    branch_ops = sorted({op for op, _nodes in steps_nodes})
    op_id = {op: k for k, op in enumerate(branch_ops)}
    n_steps = len(steps_nodes)
    opc = np.zeros(n_steps, np.int32)
    a_i = np.zeros((n_steps, S), np.int32)
    b_i = np.zeros((n_steps, S), np.int32)
    c_i = np.zeros((n_steps, S), np.int32)
    o_i = np.full((n_steps, S), trash, np.int32)
    w_i = np.full((n_steps, S), n_witness, np.int32)
    imm = np.zeros((n_steps, S), np.int64)
    out_dups = []
    for si, (op, nodes) in enumerate(steps_nodes):
        opc[si] = op_id[op]
        for sj, i in enumerate(nodes):
            for col, a in zip((a_i, b_i, c_i), dt.args[i]):
                col[si, sj] = reg_of[a]
            o_i[si, sj] = reg_of[i]
            if i in out_pos:
                first, *rest = out_pos[i]
                w_i[si, sj] = first
                out_dups.extend((first, d) for d in rest)
            v = dt.imms[i]
            if v is not None:
                if v >= 2 ** 31:
                    raise NotImplementedError(
                        f"immediate too large for op '{op}'")
                imm[si, sj] = v
    load_outputs = [(reg_of[i], out_pos[i]) for i in range(n)
                    if dt.ops[i] in ("const", "input") and i in out_pos]
    return Schedule(
        slots=S, tables=(opc, a_i, b_i, c_i, o_i, w_i, imm.astype(np.int32)),
        const_loads=const_loads, input_loads=input_loads, out_dups=out_dups,
        load_outputs=load_outputs,
        out_regs=np.asarray([reg_of[o] for o in dt.outputs], np.int32),
        n_regs=next_reg + 1, n_steps=n_steps, n_witness=n_witness,
        branch_ops=branch_ops)


def check_schedule(sched: Schedule):
    """Every register index inside the register file and every witness
    row inside the buffer (the trash row included), once: the steps then
    launch K2 without a range check."""
    _opc, a_i, b_i, c_i, o_i, w_i, _imm = sched.tables
    regs = [a_i, b_i, c_i, o_i, sched.out_regs,
            [r for r, _v, _d in sched.const_loads],
            [r for r, _ in sched.input_loads],
            [r for r, _ in sched.load_outputs]]
    rows = [w_i, [d for _, ds in sched.load_outputs for d in ds],
            [x for pair in sched.out_dups for x in pair]]
    for arrs, n in ((regs, sched.n_regs), (rows, sched.n_witness + 1)):
        for a in arrs:
            a = np.asarray(a)
            if a.size and (a.min() < 0 or a.max() >= n):
                raise ValueError("scan table index outside [0, "
                                 f"{n})")


class ScanProgram:
    """A Schedule made executable on one field's device: on the card KS
    over the DomainTape `dt` the schedule was made from (`ks`, a
    KsProgram), on the CPU the step loop over the schedule."""

    def __init__(self, sched: Schedule, field: TorchField, dt):
        check_schedule(sched)
        self.ks = KsProgram(dt, field)
        L = field.L
        self.sched = sched
        self.n_witness = sched.n_witness
        R = 1 << (LIMB_BITS * L)
        init = np.zeros((sched.n_regs, L), np.uint32)
        for reg, value, domain in sched.const_loads:
            init[reg] = int_to_limbs(
                value * R % field.p if domain == MONT else value, L)
        self._host = {
            "init": init,
            "in_regs": [r for r, _ in sched.input_loads],
            "in_idx": [i for _, i in sched.input_loads],
            "load_src": [r for r, ds in sched.load_outputs for _ in ds],
            "load_dst": [d for _, ds in sched.load_outputs for d in ds],
            "dup_src": [s for s, _ in sched.out_dups],
            "dup_dst": [d for _, d in sched.out_dups],
        }
        self._place(field)

    def _place(self, field: TorchField):
        """The register file's initial rows and the step tables on
        field's device: an index row a step (int32 for K2's gathers, int64
        for the writes and the immediates)."""
        self.field = field
        dev = field.device
        h = self._host
        self.init = to_device(h["init"].view(np.int32), dev)
        self.idx = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                    for k, v in h.items() if k != "init"}
        opc, a_i, b_i, c_i, o_i, w_i, imm = self.sched.tables
        gath = [to_device(t, dev) for t in (a_i, b_i, c_i)]
        o, w, k = (torch.as_tensor(t, dtype=torch.int64, device=dev)
                   for t in (o_i, w_i, imm))
        ops = self.sched.branch_ops
        self.steps = []
        for si in range(self.sched.n_steps):
            op = ops[opc[si]]
            self.steps.append((op, [g[si] for g in gath[:arity(op)]], o[si],
                               w[si], k[si]))

    def for_field(self, field: TorchField):
        """This program on field's device: the same schedule, its tables
        copied there, KS's tables shared."""
        twin = copy.copy(self)
        twin._place(field)
        twin.ks = self.ks.for_field(field)
        return twin

    def _gather(self, rf, idx):
        """Rows idx (int32 (S,)) of the register file (K2 on the card)."""
        if rf.device.type == "cpu":
            return gather_rows(rf, idx)
        out = torch.empty((idx.shape[0],) + tuple(rf.shape[1:]),
                          dtype=torch.uint32, device=rf.device)
        launch_gather_w(rf, idx, out)
        return out

    def _step(self, op, args, k):
        """One step's values uint32 (S, L, B) from its operands; k the
        slots' immediates, int64 (S,)."""
        f = self.field
        if op == "shr_k":
            return f.shift_r_dyn(args[0], k)
        if op == "shl_k":
            return f.shift_l_dyn(args[0], k)
        if op == "pow_k":
            return f.pow_dyn(args[0], k)
        return node_value(f, op, args, None)

    def _run(self, inputs):
        """uint32 (n_inputs, L, B), an array or a tensor -> witness uint32
        (n_witness, L, B) on the field's device: KS on the card, the step
        loop on the CPU."""
        if self.field.device.type == "cpu":
            return self.run_loop(inputs)
        return self.run_ks(inputs)

    def run_ks(self, inputs, warps=None):
        """The run as one KS launch of `warps` warps a block (by default
        the width KsProgram picks), on the field's device."""
        return self.ks.run(inputs, warps)

    def run_loop(self, inputs):
        """KS's plain version: the step loop, on the field's device."""
        dev = self.field.device
        x = u32_on(inputs, dev).view(torch.int32)
        idx = self.idx
        n_regs, L = self.init.shape
        B = x.shape[-1]
        rf = torch.empty((n_regs, L, B), dtype=torch.int32, device=dev)
        rf.copy_(self.init[:, :, None].expand(n_regs, L, B))
        rf.index_copy_(0, idx["in_regs"], x.index_select(0, idx["in_idx"]))
        out = torch.zeros((self.n_witness + 1, L, B), dtype=torch.int32,
                          device=dev)
        out.index_copy_(0, idx["load_dst"],
                        rf.index_select(0, idx["load_src"]))
        bank = rf.view(torch.uint32)
        for op, gathers, o, w, k in self.steps:
            res = self._step(op, [self._gather(bank, g) for g in gathers], k)
            res = res.view(torch.int32)
            rf.index_copy_(0, o, res)
            out.index_copy_(0, w, res)
        out.index_copy_(0, idx["dup_dst"], out.index_select(0, idx["dup_src"]))
        return out[:self.n_witness].view(torch.uint32)
