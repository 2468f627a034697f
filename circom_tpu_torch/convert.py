"""Carry an interpreter plan across: numpy tables -> the port's device plan.

`plan_from_arrays` takes the tables of an interpreter plan (the port's
`InterpreterPlan.plan_arrays()`, or the same attributes of the JAX
package's `InterpreterProgram`) and returns a `DevicePlan`: the tables in
the numbering of the CUDA interpreter kernel, as host arrays for the plain
executor and as tensors on the device for the kernel.  Feeding both
packages' plans through it is how the tests show that both execute one
identical plan.
"""

import copy
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .backend.interp_plan import (_NARROW_RESULT, _OPERAND_FILES,
                                  mixed_split)
from .backend.plan import UnsupportedTapeOp
from .ops.limbs import int_to_limbs
from .utils.device import resolve_device

# the opcodes of the interpreter kernel, in its numbering (enum Op in
# ops/cuda/interp.cu): K1a's wide opcodes, K1b's narrow ones, K1c's
# goldilocks ones, then K1d, every other opcode of the planner (wide
# results first, narrow results after)
K1A_OPCODES = ("copyw", "mul", "mul_r2", "add_c", "dot2_c", "dot3_c")
K1B_OPCODES = ("ncopy", "nadd", "nmul", "nband", "nbor", "nbxor", "nshl",
               "nshr", "nshru", "nxbit", "nmshl", "nmshru", "nrotr")
K1C_OPCODES = ("gmul", "gmul_c", "add")
CMP_OPS = ("eq", "neq", "lt", "le", "gt", "ge", "land", "lor")
K1D_OPCODES = (
    ("sub", "sub_c", "csub_c", "mul_c", "mul_one", "select") + CMP_OPS
    + ("lnot", "band", "bor", "bxor", "bnot", "shl_kw", "shr_kw", "widen",
       "idiv", "nsub", "nsel", "nsel_w", "nidiv", "nband_w", "lnot_n",
       "lnot_w")
    + tuple(f"{o}_nn" for o in CMP_OPS) + tuple(f"{o}_ww" for o in CMP_OPS))
OPCODES = K1A_OPCODES + K1B_OPCODES + K1C_OPCODES + K1D_OPCODES
# the kernel's parts, by the opcodes each runs (launch counts per part)
PARTS = {"interp_k1a": K1A_OPCODES, "interp_k1b": K1B_OPCODES,
         "interp_k1c": K1C_OPCODES, "interp_k1d": K1D_OPCODES}
# register operands each opcode reads (columns 1..3 of the table, in the
# files of _OPERAND_FILES); bank rows are column 2 (add_c, sub_c, csub_c,
# mul_c, gmul_c) or column 6 (the dots, nband_w); shift counts column 6
_TWO = {"mul", "dot2_c", "nadd", "nmul", "nband", "nbor", "nbxor", "nmshl",
        "nmshru", "gmul", "add", "sub", "band", "bor", "bxor", "idiv",
        "nsub", "nidiv"} | set(CMP_OPS) \
    | {f"{o}_{f}" for o in CMP_OPS for f in ("nn", "ww")}
_THREE = {"dot3_c", "select", "nsel", "nsel_w"}
N_OPERANDS = {op: 3 if op in _THREE else 2 if op in _TWO else 1
              for op in OPCODES}
# opcodes whose column 2 is a constant-bank row
BANK_B = {"add_c", "sub_c", "csub_c", "mul_c", "gmul_c"}
# goldilocks' folded products: only the goldilocks field runs them
GOLDILOCKS_OPS = {"gmul", "gmul_c"}
# the most narrow steps K1 reads before it stores (NGROUP in interp.cu,
# which ops/build.py sets from this)
K1B_GROUP = 8


@dataclass
class DevicePlan:
    L: int
    K: int
    KN: int
    n_regs: int
    n_nregs: int
    n_chunks: int
    win_order: list        # input index of each wide input slot
    nin_order: list        # input index of each narrow input slot
    table: np.ndarray      # (n_steps, 7) int32, column 0 in OPCODES numbering
    r_op: np.ndarray       # (n_runs,) int32, OPCODES numbering
    r_s0: np.ndarray       # (n_runs + 1,) int32
    rstarts: np.ndarray    # (n_chunks + 1,) int32
    cbank: np.ndarray      # (n_bank, L) uint32
    mont_tab: np.ndarray   # (n_chunks * (K + 1),) int32
    mat_regs: np.ndarray   # (n_mat,) int32
    mat_limbs: np.ndarray  # (n_mat, L) uint32
    nmat_regs: np.ndarray  # (n_nmat,) int32: narrow register of a constant
    nmat_vals: np.ndarray  # (n_nmat,) int32
    # witness sources, in the row order of mixed_layout(): narrow rows read
    # [narrow bank; narrow inputs], unpacking bit nw_shift (-1: raw); wide
    # rows read [wide bank; wide inputs (at least one slot); consts]
    nw_src: np.ndarray     # (n_nw,) int32
    nw_shift: np.ndarray   # (n_nw,) int32
    nw_idx: np.ndarray     # (n_nw,) int64 witness index of each narrow row
    wd_src: np.ndarray     # (n_wd,) int32
    wd_idx: np.ndarray     # (n_wd,) int64
    consts: np.ndarray     # (n_const, L) uint32
    device: torch.device
    dev: dict = field(default_factory=dict)  # the tables as device tensors

    def to(self, device):
        """This plan on another device: the same host tables, their device
        tensors copied there (nothing is converted again)."""
        device = resolve_device(device)
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device = device
        twin.dev = {k: move(v, device) for k, v in self.dev.items()}
        return twin

    @property
    def n_input_rows(self):
        """The input rows the plan reads: 1 + the largest row of
        win_order and nin_order (0 where it reads none)."""
        return max(self.win_order + self.nin_order, default=-1) + 1

    @property
    def n_bank_rows(self):
        return self.n_chunks * (self.K + 1)

    @property
    def n_bank_n_rows(self):
        return self.n_chunks * (self.KN + 1)

    @property
    def n_witness(self):
        return len(self.nw_idx) + len(self.wd_idx)

    @property
    def n_steps(self):
        return int(self.r_s0[-1])

    @cached_property
    def opcodes(self):
        """The opcodes the steps run, by name."""
        return {OPCODES[k] for k in set(self.table[:self.n_steps, 0]
                                        .tolist())}

    @property
    def parts(self):
        """The kernel's parts the steps run ("interp_k1a" .. "interp_k1d",
        see PARTS)."""
        return tuple(part for part, ops in PARTS.items()
                     if self.opcodes & set(ops))

    @cached_property
    def grp(self):
        """(len(table),) int32, K1's groups of narrow steps: each run whose
        result is narrow cut, from its first step on, into groups of at most
        K1B_GROUP consecutive steps none of which reads a register that an
        earlier step of its group writes; the group's length at its first
        step, 1 at every other step and in the other runs.  The kernel
        reads a group's operands before it stores any of its results."""
        grp = np.ones(len(self.table), np.int32)
        for rr in range(self.rstarts[0], self.rstarts[-1]):
            op = OPCODES[self.r_op[rr]]
            if op not in _NARROW_RESULT:
                continue
            files = _OPERAND_FILES.get(op, "www")[:N_OPERANDS[op]]
            t, s1 = int(self.r_s0[rr]), int(self.r_s0[rr + 1])
            while t < s1:
                written = {int(self.table[t, 4])}
                g = 1
                while t + g < s1 and g < K1B_GROUP and not written & {
                        int(self.table[t + g, 1 + j])
                        for j, f in enumerate(files) if f == "n"}:
                    written.add(int(self.table[t + g, 4]))
                    g += 1
                grp[t] = g
                t += g
        return grp

    @cached_property
    def cbank_w(self):
        """The constant bank in 32-bit words, (n_bank, L/2) uint32: limbs
        2i and 2i + 1 in word i, as the kernel packs registers."""
        cb = self.cbank.astype(np.uint32)
        return cb[:, 0::2] | (cb[:, 1::2] << np.uint32(16))

    def written_rows(self, narrow=False):
        """Bank rows the steps write (emission and dump rows) of the wide
        bank, or of the narrow bank: the rows of the steps whose result
        lands in that file."""
        codes = [k for k, op in enumerate(OPCODES)
                 if (op in _NARROW_RESULT) == narrow]
        per = (self.KN if narrow else self.K) + 1
        rows = set()
        for c in range(self.n_chunks):
            t = self.table[self.r_s0[self.rstarts[c]]:
                           self.r_s0[self.rstarts[c + 1]]]
            t = t[np.isin(t[:, 0], codes)]
            rows.update((c * per + t[:, 5]).tolist())
        return np.asarray(sorted(rows), np.int64)

    def emitted_rows(self, narrow=False):
        """written_rows without each chunk's dump row (K or KN): the rows
        that K1 stores on the card, and the only ones the witness gathers
        (wd_src, nw_src) and the trailing REDC (mont_tab) name."""
        per = (self.KN if narrow else self.K) + 1
        rows = self.written_rows(narrow)
        return rows[rows % per != per - 1]


def plan_from_arrays(arrays, device) -> DevicePlan:
    """arrays: dict with the keys of InterpreterPlan.plan_arrays()."""
    device = resolve_device(device)
    opnames = list(arrays["opset_n"]) + list(arrays["opset_w"])
    table = np.asarray(arrays["table"], np.int32)
    n_steps = int(np.asarray(arrays["r_s0"])[-1])
    used = sorted({opnames[k] for k in table[:n_steps, 0]})
    bad = [op for op in used if op not in OPCODES]
    if bad:
        raise UnsupportedTapeOp(
            "opcodes outside the interpreter kernel K1: " + ", ".join(bad))
    code = np.asarray([OPCODES.index(op) if op in OPCODES else -1
                       for op in opnames] or [0], np.int32)
    table = table.copy()
    table[:, 0] = code[table[:, 0]]
    K, KN = int(arrays["K"]), int(arrays["KN"])
    n_chunks = int(arrays["n_chunks"])
    cbank = np.asarray(arrays["cbank"]).astype(np.uint32)
    L = cbank.shape[1]
    mat, nmat = list(arrays["mat_loads"]), list(arrays["nmat_loads"])
    win_of, nin_of = arrays["win_of"], arrays["nin_of"]
    (nw_src, nw_shift, wd_src), (nw_idx, wd_idx), consts = mixed_split(
        arrays["wit_src"], nin_of, win_of, K, KN, n_chunks)
    plan = DevicePlan(
        L=L, K=K, KN=KN, n_regs=int(arrays["n_regs"]),
        n_nregs=int(arrays["n_nregs"]), n_chunks=n_chunks,
        win_order=sorted(win_of, key=win_of.get),
        nin_order=sorted(nin_of, key=nin_of.get),
        table=table,
        r_op=code[np.asarray(arrays["r_op"], np.int64)],
        r_s0=np.asarray(arrays["r_s0"], np.int32),
        rstarts=np.asarray(arrays["rstarts"], np.int32),
        cbank=cbank,
        mont_tab=np.asarray(arrays["mont_tab"], np.int32),
        mat_regs=np.asarray([r for r, _ in mat], np.int32),
        mat_limbs=np.asarray([limbs for _, limbs in mat],
                             np.uint32).reshape(len(mat), L),
        nmat_regs=np.asarray([r for r, _ in nmat], np.int32),
        nmat_vals=np.asarray([v for _, v in nmat], np.int64)
        .astype(np.int32),
        nw_src=np.asarray(nw_src, np.int32),
        nw_shift=np.asarray(nw_shift, np.int32),
        nw_idx=np.asarray(nw_idx, np.int64),
        wd_src=np.asarray(wd_src, np.int32),
        wd_idx=np.asarray(wd_idx, np.int64),
        consts=np.asarray([int_to_limbs(v, L) for v in consts],
                          np.uint32).reshape(len(consts), L),
        device=device,
    )
    _check_bounds(plan)
    for name in ("table", "grp", "r_op", "r_s0", "rstarts", "cbank_w",
                 "mont_tab", "mat_regs", "mat_limbs", "nmat_regs",
                 "nmat_vals", "nw_src", "nw_shift", "wd_src", "consts"):
        plan.dev[name] = to_device(getattr(plan, name), device)
    # the input row of each wide and narrow input: K1's and K3's tables
    for name in ("win_order", "nin_order"):
        plan.dev[name] = to_device(np.asarray(getattr(plan, name), np.int32),
                                   device)
    return plan


def narrow_unit_arrays(L, counts=(0, 1, 31, 32, 33, -1)):
    """Plan arrays (the keys of plan_arrays()) of a unit plan for the
    narrow lane: two narrow inputs a and b, then one step per K1b opcode
    and shift count, op(a, b, count), each emitted to its own narrow bank
    row and witness row.  Returns (arrays, [(opcode, count)] per row)."""
    cases = [(op, s) for op in K1B_OPCODES for s in counts]
    table = np.zeros((len(cases), 7), np.int32)
    for t, (op, s) in enumerate(cases):
        table[t] = (K1B_OPCODES.index(op), 0, 1, 0, 2, t, s)
    r_s0 = list(range(len(cases) + 1))
    return {
        "table": table, "r_op": table[:, 0].copy(),
        "r_s0": np.asarray(r_s0, np.int32),
        "rstarts": np.asarray([0, len(cases)], np.int32),
        "cbank": np.zeros((1, L), np.int32),
        "mont_tab": np.zeros(1, np.int32), "mat_loads": [],
        "nmat_loads": [],
        "wit_src": [("emitn", 0, t) for t in range(len(cases))],
        "win_of": {}, "nin_of": {0: 0, 1: 1}, "K": 0, "KN": len(cases),
        "n_regs": 1, "n_nregs": 3, "n_chunks": 1,
        "calls": [(0, 1, 0, len(cases))],
        "opset_n": list(K1B_OPCODES), "opset_w": [],
    }, cases


NARROW_EDGES = (-2 ** 31, -1, 0, 1, 2 ** 31 - 1)


def wide_edges(p):
    """The wide operand values at the edges of the arithmetic: 0, 1,
    p - 1, the p/2 pivot of the sign rule and its successor, one full
    limb, and 2^64 - 2^32 (goldilocks' p - 1)."""
    return (0, 1, p - 1, p // 2, p // 2 + 1, 2 ** 16 - 1, 2 ** 64 - 2 ** 32)


def unit_shifts(L):
    return (0, 1, 15, 16, 17, 16 * L - 1, 16 * L)


def unit_arrays(p, L, ops):
    """Plan arrays (the keys of plan_arrays()) of a unit plan for opcodes
    of K1c and K1d: three wide inputs x, y, z (input indices 0-2) and
    three narrow inputs u, v, w (3-5); one step per case, each reading
    the operands of its files in that order and emitted to its own bank
    row and witness row.  An opcode with a bank operand takes one case
    per bank row, which holds wide_edges(p); a wide shift one per count
    of unit_shifts(L).  Returns (arrays, [(opcode, aux)] per step)."""
    edges = wide_edges(p)
    cases = []
    for op in ops:
        if op in BANK_B or op == "nband_w":
            cases += [(op, k) for k in range(len(edges))]
        elif op in ("shl_kw", "shr_kw"):
            cases += [(op, s) for s in unit_shifts(L)]
        else:
            cases.append((op, 0))
    opset_n = sorted({op for op, _ in cases if op in _NARROW_RESULT})
    opset_w = sorted({op for op, _ in cases if op not in _NARROW_RESULT})
    opnames = opset_n + opset_w
    table = np.zeros((len(cases), 7), np.int32)
    wit_src, em = [], {"n": 0, "w": 0}
    for t, (op, aux) in enumerate(cases):
        f = "n" if op in _NARROW_RESULT else "w"
        cols = [0, 1, 2]
        if op in BANK_B:
            cols[1] = aux
        table[t] = (opnames.index(op), *cols, 3, em[f], aux)
        wit_src.append(("emitn" if f == "n" else "emit", 0, em[f]))
        em[f] += 1
    return {
        "table": table, "r_op": table[:, 0].copy(),
        "r_s0": np.arange(len(cases) + 1, dtype=np.int32),
        "rstarts": np.asarray([0, len(cases)], np.int32),
        "cbank": np.stack([int_to_limbs(v, L) for v in edges]),
        "mont_tab": np.zeros(em["w"] + 1, np.int32), "mat_loads": [],
        "nmat_loads": [], "wit_src": wit_src,
        "win_of": {0: 0, 1: 1, 2: 2}, "nin_of": {3: 0, 4: 1, 5: 2},
        "K": em["w"], "KN": em["n"], "n_regs": 4, "n_nregs": 4,
        "n_chunks": 1, "calls": [(0, 1, 0, len(cases))],
        "opset_n": opset_n, "opset_w": opset_w,
    }, cases


def unit_inputs(p, L, B, seed):
    """Inputs of a unit plan: wide uint32 (3, L, B) and narrow int32
    (3, B).  The first 343 lanes take every triple of wide_edges(p), the
    first 125 every triple of NARROW_EDGES; the other lanes are random
    canonical values and random int32s."""
    rng = np.random.default_rng(seed)
    top = p >> (16 * (L - 1))
    x_w = rng.integers(0, 1 << 16, size=(3, L, B), dtype=np.uint32)
    x_w[:, L - 1] = rng.integers(0, top, size=(3, B), dtype=np.uint32)
    x_n = rng.integers(-2 ** 31, 2 ** 31, size=(3, B)).astype(np.int32)
    for vals, out, n in ((wide_edges(p), x_w, 7), (NARROW_EDGES, x_n, 5)):
        for b in range(min(B, n ** 3)):
            for k in range(3):
                v = vals[b // n ** k % n]
                if out is x_w:
                    out[k, :, b] = int_to_limbs(v, L)
                else:
                    out[k, b] = v
    return x_w, x_n


def input_rows(plan, x_w, x_n):
    """Input rows uint32 (plan.n_input_rows, L, B), a numpy array, that K1
    splits into the wide inputs x_w uint32 (n_win, L, B) and the narrow
    inputs x_n int32 (n_nin, B): row win_order[k] holds x_w[k], row
    nin_order[k] the two 16-bit halves of x_n[k] in limbs 0 and 1, every
    other limb 0.  The inverse of the interpreter's input split, for plans
    built from arrays (unit_arrays, narrow_unit_arrays)."""
    x_w, x_n = np.asarray(x_w, np.uint32), np.asarray(x_n, np.int32)
    if set(plan.win_order) & set(plan.nin_order):
        raise ValueError("an input row is both wide and narrow")
    B = x_n.shape[-1] if len(plan.nin_order) else x_w.shape[-1]
    out = np.zeros((plan.n_input_rows, plan.L, B), np.uint32)
    out[plan.win_order] = x_w
    u = x_n.view(np.uint32)
    out[plan.nin_order, 0] = u & 0xFFFF
    out[plan.nin_order, 1] = u >> 16
    return out


def _in(a, hi):
    return bool(np.all((a >= 0) & (a < hi)))


def _check_bounds(plan):
    """Every index the kernel and the gathers dereference lies inside its
    array: the CUDA kernels trust the tables as given."""
    r_s0, rstarts = plan.r_s0, plan.rstarts
    ok = (len(r_s0) == len(plan.r_op) + 1
          and r_s0[0] >= 0 and np.all(np.diff(r_s0) >= 0)
          and r_s0[-1] <= len(plan.table)
          and len(rstarts) == plan.n_chunks + 1
          and rstarts[0] >= 0 and np.all(np.diff(rstarts) >= 0)
          and rstarts[-1] <= len(plan.r_op))
    # the kernel dispatches on each run's opcode: the steps of a run must
    # carry the same one
    if not ok or not np.array_equal(
            np.repeat(plan.r_op, np.diff(r_s0)),
            plan.table[r_s0[0]:r_s0[-1], 0]):
        raise ValueError("interpreter plan has an index out of range")
    t = plan.table[:plan.n_steps]
    n_bank = len(plan.cbank)
    op = t[:, 0]
    size = {"w": plan.n_regs, "n": plan.n_nregs}
    for k, name in enumerate(OPCODES):
        rows = t[op == k]
        if not len(rows):
            continue
        files = _OPERAND_FILES.get(name, ("w", "w", "w"))
        narrow = name in _NARROW_RESULT
        ok = ok and all(_in(rows[:, 1 + j], size[files[j]])
                        for j in range(N_OPERANDS[name]))
        ok = ok and _in(rows[:, 4], size["n" if narrow else "w"])
        ok = ok and _in(rows[:, 5], (plan.KN if narrow else plan.K) + 1)
        if name in BANK_B:
            ok = ok and _in(rows[:, 2], n_bank)
        if name in ("dot2_c", "dot3_c"):
            ok = ok and _in(rows[:, 6], n_bank - N_OPERANDS[name])
        if name == "nband_w":
            ok = ok and _in(rows[:, 6], n_bank)
        if name in ("shl_kw", "shr_kw"):
            ok = ok and bool(np.all(rows[:, 6] >= 0))
    n_wide_src = plan.n_bank_rows + max(len(plan.win_order), 1) \
        + len(plan.consts)
    ok = (
        ok
        and len(plan.mont_tab) == plan.n_bank_rows
        and len(plan.win_order) <= plan.n_regs
        and len(plan.nin_order) <= plan.n_nregs
        and _in(plan.mat_regs, plan.n_regs)
        and _in(plan.nmat_regs, plan.n_nregs)
        and _in(plan.nw_src, plan.n_bank_n_rows + len(plan.nin_order))
        and _in(plan.wd_src, n_wide_src))
    if not ok:
        raise ValueError("interpreter plan has an index out of range")


def to_device(arr, device):
    """numpy array -> tensor on `device`; uint32 travels as an int32 view,
    the same bytes, since PyTorch implements few operators for uint32."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device) \
            .view(torch.uint32)
    return torch.from_numpy(arr).to(device)


def move(t, device):
    """A tensor on `device` (the same tensor when it is there already);
    uint32 travels as an int32 view."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(device).view(torch.uint32)
    return t.to(device)


def u32_on(x, device):
    """uint32 limbs, an array or a tensor on any device -> a uint32
    tensor on `device` (the same tensor when it is there already)."""
    if not isinstance(x, torch.Tensor):
        return to_device(np.asarray(x, np.uint32), device)
    return move(x, device)
