"""KS's tables and runs: a DomainTape's live nodes as one launch of kernel
KS (ops/cuda/scan.cu), shared by both per-op executors.

The scan executor (backend/scan.py `ScanProgram`) and the straight-line
executor (backend/perop.py `PerOpProgram`) run a tape on the card as one
KS launch over tables built here from its DomainTape; each keeps its own
plain version for the CPU (the step loop over JAX's schedule, a library
call a node).  A witness does not depend on the order its nodes run in,
so KS's tables and either plain version give the same witness bit for
bit.

`ks_tables` builds KS's own schedule, not JAX's:

- Nodes: only those that reach a witness output.  Constants are no nodes
  of it: an entry reads one as an operand (index -1 - k into the
  constant table), and it holds no register.  Inputs are loaded by
  entries of their own, scheduled just ahead of their first reader.
- Steps: a list schedule of up to `warps` independent entries a step,
  lowest tape index first; an entry reads only what earlier steps
  wrote.  A power whose exponent needs more than 32 bits becomes a chain
  of 16-bit powers and products first (the same field element: every
  product is exact), and a shift by 2^31 or more a shift by 2^31 - 1
  (both clear every bit).
- Registers: linear-scan liveness over the steps, the lowest free index
  first, so the busiest registers are the lowest; registers 0 ..
  n_smem - 1 live in the block's shared memory (as many as
  `budget` bytes hold at this L), the rest in a file in device memory.
- Witness rows: a node's first row is written by its own entry; the
  rows that repeat it, and the rows of constants, by a last step.

`ks_check` then checks once, on the host, what KS relies on and never
tests: every register read after an earlier step wrote it, no step
writing a register twice or one that it reads, every index inside its
table, every witness row written exactly once.
"""

import copy
import heapq
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_device, u32_on
from ..field.primes import LIMB_BITS
from ..ops import build
from ..ops.limbs import int_to_limbs
from .domain import MONT

# KS's opcodes in the order of ops/cuda/scan.cu's KsOp: the 27 branches of
# the JAX package's `_branch`, then the entries that load an input, write
# a constant's witness row and copy a witness row
KS_OPS = ("add", "sub", "mul", "mulp", "div", "neg", "lt", "le", "gt", "ge",
          "eq", "neq", "land", "lor", "lnot", "band", "bor", "bxor", "bnot",
          "shl_k", "shr_k", "pow_k", "idiv", "mod", "select", "to_mont",
          "from_mont", "const", "input", "dup")
KS_BRANCHES = KS_OPS[:27]
KS_LIMBS = (4, 16, 24)     # the L that scan.cu instantiates
KS_LANES = 32              # lanes a block
KS_WIDTHS = (1, 2, 4, 8, 16)   # warps a block that scan.cu takes
# the lanes of one wave at 16 warps a block: two blocks of 512 threads an
# SM (scan.cu's 64 registers a thread at L = 16) on an H100's 132 SMs
KS_ONE_WAVE_LANES = 2 * 132 * KS_LANES
# bytes of a block's shared register file: 64 registers at L = 16, 42 at
# L = 24, 256 at L = 4; three blocks an SM at the most
KS_SMEM_BUDGET = 64 * 1024
# the opcodes of one operand (select reads three, the others two)
_UNARY = {"neg", "lnot", "bnot", "shl_k", "shr_k", "pow_k", "to_mont",
          "from_mont"}
_SHIFTS = ("shl_k", "shr_k")
_IMM_MAX = 2 ** 31 - 1
_POW_DIGIT = 16            # the bits of each power of a long exponent's chain


def arity(op):
    return 1 if op in _UNARY else 3 if op == "select" else 2


def ks_width(depth, nodes, lanes):
    """Warps a block for a run of `lanes` lanes over a tape of `nodes` live
    entries whose longest chain is `depth` entries: the most that its
    steps fill on average (nodes / depth), up to 16 while the run's blocks
    fit the card in one wave at 16 warps (KS_ONE_WAVE_LANES), else up to
    8.  On the H100, 16 x Num2Bits(254) at 8,192 lanes took 0.98 ms at 16
    warps against 1.35 at 8; at 65,536, 8.58 at 8 against 8.76 at 16."""
    cap = 16 if lanes <= KS_ONE_WAVE_LANES else 8
    fill = nodes // max(1, depth)
    return max(w for w in KS_WIDTHS if w <= max(1, min(cap, fill)))


@dataclass
class KsTables:
    """One tape's KS tables at one width.  `ent` holds (op, a, b, c, o, w,
    imm, 0) an entry, op indexing KS_OPS; step s is the entries off[s] ..
    off[s + 1] - 1.  An operand a, b or c >= 0 is a register, < 0 the
    constant -1 - a; an input entry's a is the input's index, a copy's the
    row it copies.  o < 0 writes no register, w < 0 no witness row."""
    warps: int
    off: np.ndarray
    ent: np.ndarray
    consts: list          # (value, domain) of each constant operand
    n_regs: int
    n_smem: int
    n_witness: int
    n_inputs_read: int

    @property
    def n_steps(self):
        return len(self.off) - 1

    @property
    def n_spill(self):
        return self.n_regs - self.n_smem

    def smem_bytes(self, L):
        """Bytes of a block's shared register file at L limbs."""
        return self.n_smem * (L // 2) * 4 * KS_LANES


def live_nodes(dt):
    """Every node that reaches a witness output, in tape order."""
    live = [False] * len(dt.ops)
    stack = list(dt.outputs)
    while stack:
        i = stack.pop()
        if not live[i]:
            live[i] = True
            stack.extend(dt.args[i])
    return [i for i in range(len(dt.ops)) if live[i]]


def ks_opcodes(dt):
    """The live compute opcodes of a tape; NotImplementedError for one KS
    lacks."""
    ops = {dt.ops[i] for i in live_nodes(dt)} - {"const", "input"}
    for op in sorted(ops):
        if op not in KS_BRANCHES:
            raise NotImplementedError(f"KS has no opcode {op!r}")
    return ops


def ks_depth(dt):
    """(the longest chain of live compute nodes, their number)."""
    level = {}
    for i in live_nodes(dt):
        if dt.ops[i] in ("const", "input"):
            level[i] = 0
        else:
            level[i] = 1 + max((level[a] for a in dt.args[i]), default=0)
    return max(level.values(), default=0), sum(
        1 for i in level if dt.ops[i] not in ("const", "input"))


def _expand(dt):
    """The tape's (ops, args, imms, priorities), each power whose exponent
    needs more than 32 bits replaced by a chain of powers of 16-bit
    exponents and products, Horner's rule over its digits:
    a^e = (..(a^d0)^(2^16) a^d1 ..)^(2^16) a^dk.  A chain's nodes are
    appended, with priorities just below the power's own."""
    ops, args, imms = list(dt.ops), [tuple(a) for a in dt.args], \
        list(dt.imms)
    prio = [(i, 0) for i in range(len(ops))]
    for i in range(len(dt.ops)):
        if ops[i] != "pow_k" or imms[i] < 2 ** 32:
            continue
        e, a = imms[i], args[i][0]
        digits = []
        while e:
            digits.append(e & ((1 << _POW_DIGIT) - 1))
            e >>= _POW_DIGIT
        first = len(ops)

        def new(op, ar, imm):
            ops.append(op)
            args.append(ar)
            imms.append(imm)
            prio.append((i, len(ops) - first - len(digits) * 3))
            return len(ops) - 1

        acc = new("pow_k", (a,), digits[-1])
        for d in reversed(digits[:-1]):
            acc = new("pow_k", (acc,), 1 << _POW_DIGIT)
            if d:
                acc = new("mul", (acc, new("pow_k", (a,), d)), None)
        # the power becomes the chain's last node, which nothing reads
        ops[i], args[i], imms[i] = ops[acc], args[acc], imms[acc]
    return ops, args, imms, prio


def ks_tables(dt, L, warps, budget=KS_SMEM_BUDGET):
    """KS's tables (KsTables) of a DomainTape's live nodes at `warps`
    entries a step, with as many registers in shared memory as `budget`
    bytes a block hold at L limbs.  NotImplementedError for an opcode KS
    lacks; the tables pass ks_check."""
    if warps not in KS_WIDTHS:
        raise ValueError(f"KS takes {KS_WIDTHS} warps a block, not {warps}")
    ks_opcodes(dt)
    ops, args, imms, prio = _expand(dt)
    n = len(ops)
    live = [False] * n
    stack = list(dt.outputs)
    while stack:
        i = stack.pop()
        if not live[i]:
            live[i] = True
            stack.extend(args[i])
    const_of = {}
    consts = []
    for i in range(len(dt.ops)):
        if live[i] and ops[i] == "const":
            const_of[i] = len(consts)
            consts.append((dt.imms[i], dt.domains[i]))
    nodes = [i for i in range(n) if live[i] and ops[i] != "const"]
    producers = {i: sorted({a for a in args[i] if ops[a] != "const"})
                 for i in nodes}
    consumers = {i: [] for i in nodes}
    for i in nodes:
        for a in producers[i]:
            consumers[a].append(i)
    # an input is loaded just ahead of its first reader
    key = {}
    for i in nodes:
        if ops[i] == "input" and consumers[i]:
            key[i] = min(prio[c] for c in consumers[i]) + (-1,)
        else:
            key[i] = prio[i] + (0,)
    pending = {i: len(producers[i]) for i in nodes}
    ready = [(key[i], i) for i in nodes if not pending[i]]
    heapq.heapify(ready)
    steps = []
    while ready:
        step = [heapq.heappop(ready)[1]
                for _ in range(min(warps, len(ready)))]
        steps.append(step)
        for i in step:
            for c in consumers[i]:
                pending[c] -= 1
                if not pending[c]:
                    heapq.heappush(ready, (key[c], c))
    if sum(map(len, steps)) != len(nodes):
        raise ValueError("KS tables: the tape's nodes form a cycle")
    step_of = {i: s for s, step in enumerate(steps) for i in step}
    # registers: a value's register is free again in the step after its
    # last reader's
    reg = {}
    free, next_reg = [], 0
    expiring = {}
    for s, step in enumerate(steps):
        for r in expiring.pop(s, ()):
            heapq.heappush(free, r)
        for i in step:
            if not consumers[i]:
                reg[i] = -1
                continue
            if free:
                r = heapq.heappop(free)
            else:
                r, next_reg = next_reg, next_reg + 1
            reg[i] = r
            last = max(step_of[c] for c in consumers[i])
            expiring.setdefault(last + 1, []).append(r)
    out_pos = {}
    for w, o in enumerate(dt.outputs):
        out_pos.setdefault(o, []).append(w)

    def operand(a):
        return -1 - const_of[a] if ops[a] == "const" else reg[a]

    code = {op: k for k, op in enumerate(KS_OPS)}
    rows, dups = [], []
    for step in steps:
        ent = []
        for i in step:
            rows_i = out_pos.get(i, [])
            w = rows_i[0] if rows_i else -1
            dups.extend((w, d) for d in rows_i[1:])
            if ops[i] == "input":
                ent.append((code["input"], imms[i], 0, 0, reg[i], w, 0, 0))
                continue
            opnd = [operand(a) for a in args[i]] + [0] * (3 - len(args[i]))
            imm = imms[i] or 0
            if ops[i] in _SHIFTS:
                imm = min(imm, _IMM_MAX)
            elif ops[i] == "pow_k":
                imm = imm - 2 ** 32 if imm > _IMM_MAX else imm
            else:
                imm = 0
            ent.append((code[ops[i]], *opnd, reg[i], w, imm, 0))
        rows.append(ent)
    last = [(code["dup"], src, 0, 0, -1, dst, 0, 0) for src, dst in dups]
    for i in range(len(dt.ops)):
        if live[i] and ops[i] == "const":
            last.extend((code["const"], 0, 0, 0, -1, w, const_of[i], 0)
                        for w in out_pos.get(i, ()))
    if last:
        rows.append(last)
    off = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    ent = (np.asarray([e for r in rows for e in r], np.int64)
           .reshape(-1, 8).astype(np.int32))
    n_smem = min(next_reg, budget // ((L // 2) * 4 * KS_LANES))
    inputs = [imms[i] for i in nodes if ops[i] == "input"]
    t = KsTables(warps=warps, off=off, ent=ent, consts=consts,
                 n_regs=next_reg, n_smem=n_smem,
                 n_witness=len(dt.outputs),
                 n_inputs_read=1 + max(inputs, default=-1))
    _check_holders(steps, ops, args, reg, const_of)
    ks_check(t)
    return t


def _check_holders(steps, ops, args, reg, const_of):
    """Every operand of every entry names the value its node reads: the
    register holds that node's value when the entry runs (no later write
    came between), a constant operand that constant."""
    holder = {}
    for step in steps:
        for i in step:
            if ops[i] == "input":
                continue
            for a in args[i]:
                ok = (const_of.get(a) is not None if ops[a] == "const"
                      else holder.get(reg[a]) == a)
                if not ok:
                    raise ValueError(f"KS tables: node {i} reads node {a} "
                                     "from a register that no longer holds "
                                     "it")
        for i in step:
            if reg[i] >= 0:
                holder[reg[i]] = i


def ks_check(t: KsTables):
    """What KS relies on and never tests at run time: every opcode in
    KS_OPS and every index inside its table, no register read before an
    earlier step writes it, no step writing a register twice or one that
    it reads, every witness row written exactly once (a copy after the
    row it copies).  Raises ValueError."""
    ent, n_w = t.ent, t.n_witness
    if ent.size and (ent[:, 0].min() < 0 or ent[:, 0].max() >= len(KS_OPS)):
        raise ValueError("KS tables: an opcode outside KS_OPS")
    if ent.size and ent[:, 4].max() >= t.n_regs:
        raise ValueError(f"KS tables: a register outside [0, {t.n_regs})")
    if ent.size and (ent[:, 5].max() >= n_w or ent[:, 5].min() < -1):
        raise ValueError(f"KS tables: a witness row outside [0, {n_w})")
    defined = np.zeros(t.n_regs, bool)
    rows = np.zeros(n_w, np.int64)
    for s in range(t.n_steps):
        e = ent[t.off[s]:t.off[s + 1]]
        op = np.asarray(KS_OPS)[e[:, 0]]
        reads = []
        for k, o in enumerate(op):
            if o == "input":
                if not 0 <= e[k, 1] < t.n_inputs_read:
                    raise ValueError(f"KS step {s} loads input {e[k, 1]} "
                                     f"outside [0, {t.n_inputs_read})")
            elif o == "const":
                if not 0 <= e[k, 6] < len(t.consts):
                    raise ValueError(f"KS step {s}: a constant outside "
                                     f"[0, {len(t.consts)})")
            elif o == "dup":
                if not 0 <= e[k, 1] < n_w or rows[e[k, 1]] != 1:
                    raise ValueError(f"KS step {s} copies witness row "
                                     f"{e[k, 1]}, which no earlier step "
                                     "writes once")
            else:
                for a in e[k, 1:1 + arity(o)]:
                    if a < -len(t.consts) or a >= t.n_regs:
                        raise ValueError(f"KS step {s}: operand {a} outside "
                                         "the constants and registers")
                    if a >= 0:
                        reads.append(a)
        reads = np.asarray(reads, np.int64)
        bad = reads[~defined[reads]]
        if bad.size:
            raise ValueError(f"KS step {s} reads register {bad[0]} before "
                             "it is written")
        o = e[:, 4][e[:, 4] >= 0]
        if len(set(o.tolist())) < len(o) or np.isin(o, reads).any():
            raise ValueError(f"KS step {s} writes a register twice or one "
                             "that it reads")
        defined[o] = True
        w = e[:, 5][e[:, 5] >= 0]
        np.add.at(rows, w, 1)
    if (rows != 1).any():
        raise ValueError("KS tables write a witness row other than once")


def const_words(consts, field):
    """The constant table uint32 (n_consts, L/2): each constant's value
    (Montgomery form in the MONT domain) in 32-bit words."""
    L = field.L
    R = 1 << (LIMB_BITS * L)
    limbs = np.zeros((len(consts), L), np.uint32)
    for k, (value, domain) in enumerate(consts):
        limbs[k] = int_to_limbs(value * R % field.p if domain == MONT
                                else value, L)
    return limbs[:, 0::2] | (limbs[:, 1::2] << 16)


def ks_args(field, d, x, spill, out, stream):
    """ctpu_scan's arguments (ops/build.py SIGNATURES["scan"]) for one run
    on x uint32 (n_inputs, L, B) into out uint32 (n_witness, L, B), with
    the spilled registers' file uint32 (n_spill, L/2, B) or None; d: the
    tables on x's device (KsProgram.device_tables)."""
    f, t = field, d["t"]
    limbs = (f.p_list + f.r2_list + f.one_mont_list + f.half_list
             + f.mask_list)
    return (f.L, d["off"].data_ptr(), d["ent"].data_ptr(), t.n_steps,
            d["consts"].data_ptr(), x.data_ptr(),
            0 if spill is None else spill.data_ptr(), out.data_ptr(),
            x.shape[-1], t.n_smem, build.u32_array(limbs), f.n0inv32,
            f.p.bit_length(), t.warps, stream)


def launch_scan(field, d, x, spill, out):
    """KS on the card: one launch, counted, for a whole run."""
    lib = build.library("scan")
    build.launch("scan", lib.ctpu_scan, x.device,
                 *ks_args(field, d, x, spill, out, build.stream_ptr(x.device)))


class KsProgram:
    """A DomainTape's KS tables, built on the host once a width (shared
    by every copy of the program) and placed on the field's device once a
    width, and its runs there."""

    def __init__(self, dt, field, budget=KS_SMEM_BUDGET):
        if field.L not in KS_LIMBS:
            raise ValueError(f"KS is built for L = 4, 16 or 24, not L = "
                             f"{field.L}")
        ks_opcodes(dt)
        self.dt, self.budget = dt, budget
        self.n_witness = len(dt.outputs)
        self.depth, self.n_nodes = ks_depth(dt)
        self._host = {}
        self._place(field)

    def _place(self, field):
        self.field = field
        self._dev = {}

    def for_field(self, field):
        """This program on field's device: the host tables shared, placed
        there at first use."""
        twin = copy.copy(self)
        twin._place(field)
        return twin

    def width(self, lanes):
        """The warps a block of a run of `lanes` lanes (ks_width)."""
        return ks_width(self.depth, self.n_nodes, lanes)

    def tables(self, warps):
        """The KsTables at `warps` a block, built once."""
        t = self._host.get(warps)
        if t is None:
            t = self._host[warps] = ks_tables(self.dt, self.field.L, warps,
                                              self.budget)
        return t

    def device_tables(self, warps):
        """{"t": KsTables, "off", "ent", "consts": tensors} on the field's
        device, placed once."""
        d = self._dev.get(warps)
        if d is None:
            t = self.tables(warps)
            dev = self.field.device
            d = self._dev[warps] = {
                "t": t, "off": to_device(t.off, dev),
                "ent": to_device(t.ent, dev),
                "consts": to_device(np.ascontiguousarray(
                    const_words(t.consts, self.field)), dev)}
        return d

    def run(self, inputs, warps=None):
        """uint32 (n_inputs, L, B), an array or a tensor -> witness uint32
        (n_witness, L, B): one KS launch on the field's device, at `warps`
        a block (by default ks_width's)."""
        dev = self.field.device
        x = u32_on(inputs, dev).contiguous()
        L, B = self.field.L, x.shape[-1]
        d = self.device_tables(warps or self.width(B))
        t = d["t"]
        if x.dim() != 3 or x.shape[1] != L or x.shape[0] < t.n_inputs_read:
            raise ValueError(f"inputs of shape {tuple(x.shape)}: need "
                             f"({t.n_inputs_read}, {L}, B)")
        out = torch.empty((self.n_witness, L, B), dtype=torch.int32,
                          device=dev)
        if B and t.n_steps:
            spill = (torch.empty((t.n_spill, L // 2, B), dtype=torch.int32,
                                 device=dev).view(torch.uint32)
                     if t.n_spill else None)
            launch_scan(self.field, d, x, spill, out)
        return out.view(torch.uint32)
