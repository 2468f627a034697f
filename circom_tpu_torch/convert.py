"""Carry an interpreter plan across: numpy tables -> the port's device plan.

`plan_from_arrays` takes the tables of an interpreter plan (the port's
`InterpreterPlan.plan_arrays()`, or the same attributes of the JAX
package's `InterpreterProgram`) and returns a `DevicePlan`: the tables in
the numbering of the CUDA interpreter kernel, as host arrays for the plain
executor and as tensors on the device for the kernel.  Feeding both
packages' plans through it is how the tests show that both execute one
identical plan.
"""

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .backend.interp_plan import _OPERAND_FILES, mixed_split
from .backend.plan import UnsupportedTapeOp
from .ops.limbs import int_to_limbs
from .utils.device import resolve_device

# the opcodes of the interpreter kernel, in its numbering (enum Op in
# ops/cuda/interp.cu): K1a's wide opcodes, then K1b's narrow ones
K1A_OPCODES = ("copyw", "mul", "mul_r2", "add_c", "dot2_c", "dot3_c")
K1B_OPCODES = ("ncopy", "nadd", "nmul", "nband", "nbor", "nbxor", "nshl",
               "nshr", "nshru", "nxbit", "nmshl", "nmshru", "nrotr")
OPCODES = K1A_OPCODES + K1B_OPCODES
# register operands each opcode reads (columns 1.. of the table); add_c's
# column 2 is a constant-bank row, the dots' bank rows start at column 6,
# and the shift counts of the narrow ops are column 6
N_OPERANDS = dict(zip(OPCODES, (1, 2, 1, 1, 2, 3,
                                1, 2, 2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 1)))


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

    @property
    def n_bank_rows(self):
        return self.n_chunks * (self.K + 1)

    @property
    def n_bank_n_rows(self):
        return self.n_chunks * (self.KN + 1)

    @property
    def n_witness(self):
        return len(self.nw_idx) + len(self.wd_idx)

    @cached_property
    def lanes(self):
        """The interpreter's lanes the steps run: "wide" (K1a's opcodes)
        and/or "narrow" (K1b's)."""
        run = set(self.table[:self.n_steps, 0].tolist())
        return tuple(lane for lane, ops in (("wide", K1A_OPCODES),
                                            ("narrow", K1B_OPCODES))
                     if run & {OPCODES.index(op) for op in ops})

    @property
    def n_steps(self):
        return int(self.r_s0[-1])

    def written_rows(self, narrow=False):
        """Bank rows the steps write (emission and dump rows) of the wide
        bank, or of the narrow bank."""
        ops = K1B_OPCODES if narrow else K1A_OPCODES
        codes = [OPCODES.index(op) for op in ops]
        per = (self.KN if narrow else self.K) + 1
        rows = set()
        for c in range(self.n_chunks):
            t = self.table[self.r_s0[self.rstarts[c]]:
                           self.r_s0[self.rstarts[c + 1]]]
            t = t[np.isin(t[:, 0], codes)]
            rows.update((c * per + t[:, 5]).tolist())
        return np.asarray(sorted(rows), np.int64)


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
            "opcodes outside the interpreter kernel (K1a wide, K1b "
            "narrow): " + ", ".join(bad))
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
    for name in ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
                 "mat_regs", "mat_limbs", "nmat_regs", "nmat_vals", "nw_src",
                 "nw_shift", "wd_src", "consts"):
        plan.dev[name] = to_device(getattr(plan, name), device)
    for name in ("win_order", "nin_order"):
        plan.dev[name] = to_device(np.asarray(getattr(plan, name), np.int64),
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
        narrow = name in K1B_OPCODES
        ok = ok and all(_in(rows[:, 1 + j], size[files[j]])
                        for j in range(N_OPERANDS[name]))
        ok = ok and _in(rows[:, 4], size["n" if narrow else "w"])
        ok = ok and _in(rows[:, 5], (plan.KN if narrow else plan.K) + 1)
        if name == "add_c":
            ok = ok and _in(rows[:, 2], n_bank)
        if name in ("dot2_c", "dot3_c"):
            ok = ok and _in(rows[:, 6], n_bank - N_OPERANDS[name])
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
