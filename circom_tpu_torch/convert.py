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

import numpy as np
import torch

from .backend.plan import UnsupportedTapeOp
from .utils.device import resolve_device

# the opcodes of kernel K1a, in the kernel's numbering
# (enum K1aOp in ops/cuda/interp.cu)
K1A_OPCODES = ("copyw", "mul", "mul_r2", "add_c", "dot2_c", "dot3_c")


@dataclass
class DevicePlan:
    L: int
    K: int
    n_regs: int
    n_chunks: int
    win_order: list        # input index of each wide input slot
    table: np.ndarray      # (n_steps, 7) int32, column 0 in K1A numbering
    r_op: np.ndarray       # (n_runs,) int32, K1A numbering
    r_s0: np.ndarray       # (n_runs + 1,) int32
    rstarts: np.ndarray    # (n_chunks + 1,) int32
    cbank: np.ndarray      # (n_bank, L) uint32
    mont_tab: np.ndarray   # (n_chunks * (K + 1),) int32
    mat_regs: np.ndarray   # (n_mat,) int32
    mat_limbs: np.ndarray  # (n_mat, L) uint32
    wit_rows: np.ndarray   # (n_witness,) int32: bank row of each witness
    device: torch.device
    dev: dict = field(default_factory=dict)  # the tables as device tensors

    @property
    def n_bank_rows(self):
        return self.n_chunks * (self.K + 1)

    def written_rows(self):
        """Bank rows the steps write (emission and dump rows)."""
        rows = set()
        for c in range(self.n_chunks):
            s0 = self.r_s0[self.rstarts[c]]
            s1 = self.r_s0[self.rstarts[c + 1]]
            rows.update((c * (self.K + 1) + self.table[s0:s1, 5]).tolist())
        return np.asarray(sorted(rows), np.int64)


def plan_from_arrays(arrays, device) -> DevicePlan:
    """arrays: dict with the keys of InterpreterPlan.plan_arrays()."""
    device = resolve_device(device)
    opnames = list(arrays["opset_n"]) + list(arrays["opset_w"])
    table = np.asarray(arrays["table"], np.int32)
    used = sorted({opnames[k] for k in table[:, 0]}) if opnames else []
    bad = [op for op in used if op not in K1A_OPCODES]
    if bad:
        raise UnsupportedTapeOp(
            "opcodes outside the interpreter kernel K1a: " + ", ".join(bad))
    if arrays["nin_of"] or arrays["nmat_loads"]:
        raise UnsupportedTapeOp("narrow inputs or constants (range-hinted "
                                "inputs) are not in K1a")
    kinds = sorted({src[0] for src in arrays["wit_src"]} - {"emit"})
    if kinds:
        raise UnsupportedTapeOp("witness rows outside the wide emission "
                                "bank: " + ", ".join(kinds))
    code = np.asarray([K1A_OPCODES.index(op) if op in K1A_OPCODES else -1
                       for op in opnames] or [0], np.int32)
    table = table.copy()
    table[:, 0] = code[table[:, 0]]
    K = int(arrays["K"])
    cbank = np.asarray(arrays["cbank"]).astype(np.uint32)
    L = cbank.shape[1]
    mat = list(arrays["mat_loads"])
    win_of = arrays["win_of"]
    plan = DevicePlan(
        L=L, K=K, n_regs=int(arrays["n_regs"]),
        n_chunks=int(arrays["n_chunks"]),
        win_order=sorted(win_of, key=win_of.get),
        table=table,
        r_op=code[np.asarray(arrays["r_op"], np.int64)],
        r_s0=np.asarray(arrays["r_s0"], np.int32),
        rstarts=np.asarray(arrays["rstarts"], np.int32),
        cbank=cbank,
        mont_tab=np.asarray(arrays["mont_tab"], np.int32),
        mat_regs=np.asarray([r for r, _ in mat], np.int32),
        mat_limbs=np.asarray([limbs for _, limbs in mat],
                             np.uint32).reshape(len(mat), L),
        wit_rows=np.asarray([c * (K + 1) + r for _, c, r
                             in arrays["wit_src"]], np.int32),
        device=device,
    )
    _check_bounds(plan)
    for name in ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
                 "mat_regs", "mat_limbs", "wit_rows"):
        plan.dev[name] = to_device(getattr(plan, name), device)
    return plan


def _check_bounds(plan):
    """Every index the kernel dereferences lies inside its array: the CUDA
    interpreter trusts the tables as given."""
    t, K = plan.table, plan.K
    n_steps, n_bank = len(t), len(plan.cbank)
    op = t[:, 0]
    n_reg_operands = np.choose(op, [1, 2, 1, 1, 2, 3])
    dots = (op == K1A_OPCODES.index("dot2_c")) | \
        (op == K1A_OPCODES.index("dot3_c"))
    ok = (
        np.all((t[:, 4] >= 0) & (t[:, 4] < plan.n_regs))
        and np.all((t[:, 5] >= 0) & (t[:, 5] <= K))
        and all(np.all((t[n_reg_operands > k, 1 + k] >= 0)
                       & (t[n_reg_operands > k, 1 + k] < plan.n_regs))
                for k in range(3))
        and np.all(t[op == K1A_OPCODES.index("add_c"), 2] < n_bank)
        and np.all(t[dots, 6] + n_reg_operands[dots] < n_bank)
        and len(plan.r_s0) == len(plan.r_op) + 1
        and plan.r_s0[0] >= 0 and np.all(np.diff(plan.r_s0) >= 0)
        and plan.r_s0[-1] <= n_steps
        and len(plan.rstarts) == plan.n_chunks + 1
        and plan.rstarts[0] >= 0 and np.all(np.diff(plan.rstarts) >= 0)
        and plan.rstarts[-1] <= len(plan.r_op)
        and len(plan.mont_tab) == plan.n_bank_rows
        and len(plan.win_order) <= plan.n_regs
        and np.all((plan.mat_regs >= 0) & (plan.mat_regs < plan.n_regs))
        and np.all((plan.wit_rows >= 0)
                   & (plan.wit_rows < plan.n_bank_rows)))
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
