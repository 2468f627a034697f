"""The scan executor: a witness tape run as steps of packed nodes.

The port of the JAX package's scan path (backend/jax_backend.py
`WitnessProgram._schedule_and_allocate`, `_branch`, `_init_regfile` and
`_run`), which runs the long tapes that both fused backends refuse.
`schedule` packs the compute nodes of one dataflow level and one opcode
into steps of up to `slots` slots and gives each value a register by
linear-scan liveness, with the same tables, element for element, as the
JAX package.  `ScanProgram` runs them.

On the card a run is one launch of kernel KS (ops/cuda/scan.cu): the
constants' and inputs' loads, every step's gathers and field op, its
register and witness writes, and the witness rows that copy another, over
KS's own register file of 32-bit words.  `ks_tables` packs the schedule
into KS's entries once a program and checks there what KS then need not:
no register read before it is written, no step reading what it writes,
every witness row written once.

On the CPU a run takes KS's plain version, the step loop (`run_loop`):
the register file (n_regs, L, B) and a witness buffer (n_witness + 1, L,
B); a step gathers its operands (S, L, B), computes them with one call of
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
from ..ops import build
from ..ops.field import TorchField
from ..ops.limbs import int_to_limbs
from .domain import MONT
from .interp import launch_gather_w
from .interp_ref import gather_rows
from .perop import node_value

# the opcodes of one operand (select takes three, the others two)
_UNARY = {"neg", "lnot", "bnot", "shl_k", "shr_k", "pow_k", "to_mont",
          "from_mont"}

# KS's opcodes in the order of ops/cuda/scan.cu's KsOp: the 27 branches of
# the JAX package's `_branch`, then the entries of the run's first step
# (a constant, an input) and last (a witness row copied)
KS_OPS = ("add", "sub", "mul", "mulp", "div", "neg", "lt", "le", "gt", "ge",
          "eq", "neq", "land", "lor", "lnot", "band", "bor", "bxor", "bnot",
          "shl_k", "shr_k", "pow_k", "idiv", "mod", "select", "to_mont",
          "from_mont", "const", "input", "dup")
KS_BRANCHES = KS_OPS[:27]
KS_LIMBS = (4, 16, 24)     # the L that scan.cu instantiates
# warps a block of 32 lanes: 1 is a thread a lane, more spread a step's
# slots over the warps (chip_smoke.py's phase KS times 1 and 8)
KS_WARPS = 8
KS_LAYOUTS = (1, 8)


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


def _arity(op):
    return 1 if op in _UNARY else 3 if op == "select" else 2


def _entries(op, a=0, b=0, c=0, o=-1, w=-1, imm=0):
    """KS entries (n, 8) int32 of one opcode from columns or scalars."""
    cols = np.broadcast_arrays(KS_OPS.index(op), a, b, c, o, w, imm, 0)
    return np.stack(cols, -1).reshape(-1, 8).astype(np.int32)


def ks_tables(sched: Schedule):
    """KS's tables of a schedule: (off int32 (n_steps + 1,), entries int32
    (off[-1], 8)), the run's steps as ops/cuda/scan.cu describes them: the
    constants' and inputs' loads (entry imm: the constant's index in
    `const_loads`; a: the input's index), each step's real slots, the
    witness rows' copies.  Raises NotImplementedError for an opcode KS
    lacks, ValueError where the tables break what KS relies on: padding
    before a real slot or writing a witness row, a register read before a
    constant, an input or an earlier step writes it, a step writing a
    register twice or one that it reads, a witness row written other than
    once."""
    opc, a_i, b_i, c_i, o_i, w_i, imm = sched.tables
    trash, n_w = sched.n_regs - 1, sched.n_witness
    for op in sched.branch_ops:
        if op not in KS_BRANCHES:
            raise NotImplementedError(f"KS has no opcode {op!r}")
    defined = np.zeros(sched.n_regs, bool)
    rows = np.zeros(n_w + 1, np.int64)
    first = []
    for k, (reg, _v, _d) in enumerate(sched.const_loads):
        first.append(_entries("const", o=reg, imm=k))
        defined[reg] = True
    for reg, idx in sched.input_loads:
        first.append(_entries("input", a=idx, o=reg))
        defined[reg] = True
    load = {reg: ("const", {"imm": k})
            for k, (reg, _v, _d) in enumerate(sched.const_loads)}
    load.update({reg: ("input", {"a": idx}) for reg, idx in
                 sched.input_loads})
    for reg, ws in sched.load_outputs:
        op, kw = load[reg]
        first.append(_entries(op, w=np.asarray(ws), **kw))
        np.add.at(rows, ws, 1)
    steps = [np.concatenate(first) if first else np.zeros((0, 8), np.int32)]
    for si in range(sched.n_steps):
        op = sched.branch_ops[opc[si]]
        real = o_i[si] != trash
        n = int(real.sum())
        if not real[:n].all() or (w_i[si, n:] != n_w).any():
            raise ValueError(f"scan step {si}: a padding slot before a real "
                             "slot or writing a witness row")
        reads = np.concatenate([t[si, :n] for t in (a_i, b_i, c_i)
                                [:_arity(op)]])
        bad = reads[~defined[reads]]
        if bad.size:
            raise ValueError(f"scan step {si} reads register {bad[0]} "
                             "before it is written")
        o = o_i[si, :n]
        if len(set(o.tolist())) < n or np.isin(o, reads).any():
            raise ValueError(f"scan step {si} writes a register twice or "
                             "one that it reads")
        defined[o] = True
        w = w_i[si, :n]
        np.add.at(rows, w, 1)
        steps.append(_entries(op, a_i[si, :n], b_i[si, :n], c_i[si, :n], o,
                              np.where(w == n_w, -1, w), imm[si, :n]))
    if sched.out_dups:
        src, dst = np.asarray(sched.out_dups, np.int64).T
        if (rows[src] != 1).any():
            raise ValueError("a witness row copies a row no step writes")
        np.add.at(rows, dst, 1)
        steps.append(_entries("dup", a=src, w=dst))
    if (rows[:n_w] != 1).any():
        raise ValueError("scan tables write a witness row other than once")
    off = np.cumsum([0] + [len(t) for t in steps]).astype(np.int32)
    return off, np.concatenate(steps)


def ks_args(scan, x, rf, out, warps, stream):
    """ctpu_scan's arguments (ops/build.py SIGNATURES["scan"]) for one run
    of `scan` on x uint32 (n_inputs, L, B), into rf uint32 (n_regs, L/2, B)
    and out uint32 (n_witness, L, B), all contiguous on one device."""
    f, t = scan.field, scan.ks
    limbs = (f.p_list + f.r2_list + f.one_mont_list + f.half_list
             + f.mask_list)
    return (f.L, t["off"].data_ptr(), t["ent"].data_ptr(), t["n_steps"],
            t["consts"].data_ptr(), x.data_ptr(), rf.data_ptr(),
            out.data_ptr(), x.shape[-1], build.u32_array(limbs), f.n0inv32,
            f.p.bit_length(), warps, stream)


def launch_scan(scan, x, rf, out, warps=KS_WARPS):
    """KS on the card: one launch, counted, for a whole run."""
    lib = build.library("scan")
    build.launch("scan", lib.ctpu_scan, x.device,
                 *ks_args(scan, x, rf, out, warps, build.stream_ptr(x.device)))


class ScanProgram:
    """A Schedule made executable on one field's device."""

    def __init__(self, sched: Schedule, field: TorchField):
        check_schedule(sched)
        L = field.L
        if L not in KS_LIMBS:
            raise ValueError(f"KS is built for L = 4, 16 or 24, not L = {L}")
        self.sched = sched
        self.n_witness = sched.n_witness
        R = 1 << (LIMB_BITS * L)
        init = np.zeros((sched.n_regs, L), np.uint32)
        for reg, value, domain in sched.const_loads:
            init[reg] = int_to_limbs(
                value * R % field.p if domain == MONT else value, L)
        off, ent = ks_tables(sched)
        const_regs = [r for r, _v, _d in sched.const_loads]
        words = init[const_regs, 0::2] | (init[const_regs, 1::2] << 16)
        self._host = {
            "init": init,
            "in_regs": [r for r, _ in sched.input_loads],
            "in_idx": [i for _, i in sched.input_loads],
            "load_src": [r for r, ds in sched.load_outputs for _ in ds],
            "load_dst": [d for _, ds in sched.load_outputs for d in ds],
            "dup_src": [s for s, _ in sched.out_dups],
            "dup_dst": [d for _, d in sched.out_dups],
        }
        self._ks_host = {"off": off, "ent": ent, "consts": words}
        self.n_inputs_read = 1 + max((i for _, i in sched.input_loads),
                                     default=-1)
        self._place(field)

    def _place(self, field: TorchField):
        """The register file's initial rows, the step tables and KS's
        tables on field's device: an index row a step (int32 for K2's
        gathers, int64 for the writes and the immediates)."""
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
            self.steps.append((op, [g[si] for g in gath[:_arity(op)]], o[si],
                               w[si], k[si]))
        ks = self._ks_host
        self.ks = {k: to_device(v, dev) for k, v in ks.items()}
        self.ks["n_steps"] = len(ks["off"]) - 1

    def for_field(self, field: TorchField):
        """This program on field's device: the same schedule, its tables
        copied there."""
        twin = copy.copy(self)
        twin._place(field)
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

    def run_ks(self, inputs, warps=KS_WARPS):
        """The run as one KS launch of `warps` warps a block (KS_LAYOUTS),
        on the field's device."""
        dev = self.field.device
        x = u32_on(inputs, dev).contiguous()
        L, B = self.field.L, x.shape[-1]
        if x.dim() != 3 or x.shape[1] != L or x.shape[0] < self.n_inputs_read:
            raise ValueError(f"inputs of shape {tuple(x.shape)}: need "
                             f"({self.n_inputs_read}, {L}, B)")
        out = torch.empty((self.n_witness, L, B), dtype=torch.int32,
                          device=dev)
        if B:
            rf = torch.empty((self.sched.n_regs, L // 2, B),
                             dtype=torch.int32, device=dev)
            launch_scan(self, x, rf.view(torch.uint32), out, warps)
        return out.view(torch.uint32)

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
