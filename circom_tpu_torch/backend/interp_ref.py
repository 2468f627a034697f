"""Plain PyTorch executor of the interpreter plan.

The plain version of the interpreter kernel K1a (ops/cuda/interp.cu) and of
the witness gather K2: it walks the same tables in the same order, with the
register file and the emission bank as int64 tensors (rows, L, B) and the
field arithmetic of TorchField.  It is the CPU path of the port and the
reference the kernels are held against on the card.
"""

import torch

from ..convert import K1A_OPCODES, DevicePlan
from ..ops.field import TorchField


def run_plan(plan: DevicePlan, field: TorchField, x_w):
    """Wide inputs int64 (n_win, L, B) -> emission bank int64
    (n_chunks * (K + 1), L, B), Montgomery rows already reduced.  Rows no
    step writes stay zero."""
    L, K = plan.L, plan.K
    B = x_w.shape[-1]
    dev = x_w.device
    rf = torch.zeros((plan.n_regs, L, B), dtype=torch.int64, device=dev)
    rf[:x_w.shape[0]] = x_w
    if len(plan.mat_regs):
        rf[torch.as_tensor(plan.mat_regs, dtype=torch.int64, device=dev)] = \
            torch.as_tensor(plan.mat_limbs.astype("int64"),
                            device=dev)[:, :, None]
    bank = torch.zeros((plan.n_bank_rows, L, B), dtype=torch.int64,
                       device=dev)
    cb = torch.as_tensor(plan.cbank.astype("int64"), device=dev)[:, :, None]
    r2 = field.R2_limbs.to(dev)
    table = plan.table.tolist()
    r_op, r_s0, rstarts = (plan.r_op.tolist(), plan.r_s0.tolist(),
                           plan.rstarts.tolist())
    for c in range(plan.n_chunks):
        base = c * (K + 1)
        for rr in range(rstarts[c], rstarts[c + 1]):
            op = K1A_OPCODES[r_op[rr]]
            for t in range(r_s0[rr], r_s0[rr + 1]):
                _op, ia, ib, ic, dst, em, aux = table[t]
                if op == "copyw":
                    res = rf[ia]
                elif op == "mul":
                    res = field.mont_mul64(rf[ia], rf[ib])
                elif op == "mul_r2":
                    res = field.mont_mul64(rf[ia], r2)
                elif op == "add_c":
                    res = field.add64(rf[ia], cb[ib])
                else:
                    # dot2_c / dot3_c: coefficients in bank rows
                    # aux..aux+n-1, an additive constant in row aux+n;
                    # one reduction of the summed columns
                    n = 3 if op == "dot3_c" else 2
                    cols = sum(field.product_cols64(rf[x], cb[aux + k])
                               for k, x in enumerate((ia, ib, ic)[:n]))
                    cols[:L] += cb[aux + n]
                    res = field.mont_reduce64(cols)
                rf[dst] = res
                bank[base + em] = res
        # trailing REDC of this chunk's flagged Montgomery rows
        flagged = [base + r for r in range(K + 1)
                   if plan.mont_tab[base + r]]
        if flagged:
            rows = torch.as_tensor(flagged, dtype=torch.int64, device=dev)
            bank[rows] = field.mont_reduce64(bank[rows])
    return bank


def gather_rows(bank, idx):
    """out[w] = bank[idx[w]] (the plain version of K2).  uint32 banks are
    gathered through an int32 view: PyTorch's uint32 lacks index_select
    on some devices."""
    src = bank.view(torch.int32) if bank.dtype == torch.uint32 else bank
    return src.index_select(0, idx.to(torch.int64)).view(bank.dtype)
