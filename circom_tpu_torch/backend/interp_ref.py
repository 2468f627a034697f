"""Plain PyTorch executor of the interpreter plan.

The plain version of the interpreter kernel K1 (every opcode of K1a to
K1d, ops/cuda/interp.cu) and of the witness gathers K2 and K3
(ops/cuda/gather.cu): it walks the same tables in the same order, with the
wide register file and emission bank as int64 limb tensors (rows, L, B),
the field arithmetic of TorchField and ops/wide.py, the narrow register
file and bank as int64 tensors (rows, B) of signed 32-bit values, and the
narrow ops of ops/narrow.py.  It is the CPU path of the port and the
reference the kernels are held against on the card.
"""

import torch

from ..convert import BANK_B, N_OPERANDS, OPCODES, DevicePlan
from ..ops import wide
from ..ops.field import TorchField
from ..ops.narrow import NARROW_OPS, i32, nsel, unpack_bits
from .interp_plan import _NARROW_RESULT, _OPERAND_FILES


def run_plan(plan: DevicePlan, field: TorchField, x_w, x_n):
    """Wide inputs int64 (n_win, L, B) and narrow inputs (n_nin, B) ->
    (wide bank int64 (n_chunks * (K + 1), L, B), Montgomery rows already
    reduced; narrow bank int64 (n_chunks * (KN + 1), B)).  Rows no step
    writes stay zero."""
    L, K, KN = plan.L, plan.K, plan.KN
    B = x_w.shape[-1]
    dev = x_w.device
    rf = torch.zeros((plan.n_regs, L, B), dtype=torch.int64, device=dev)
    rf[:x_w.shape[0]] = x_w
    if len(plan.mat_regs):
        rf[torch.as_tensor(plan.mat_regs, dtype=torch.int64, device=dev)] = \
            torch.as_tensor(plan.mat_limbs.astype("int64"),
                            device=dev)[:, :, None]
    # narrow inputs in slots 0..n_nin-1, then the signed int32 constants
    rf_n = torch.zeros((plan.n_nregs, B), dtype=torch.int64, device=dev)
    rf_n[:x_n.shape[0]] = i32(x_n.to(torch.int64))
    if len(plan.nmat_regs):
        rf_n[torch.as_tensor(plan.nmat_regs, dtype=torch.int64,
                             device=dev)] = torch.as_tensor(
            plan.nmat_vals.astype("int64"), device=dev)[:, None]
    bank = torch.zeros((plan.n_bank_rows, L, B), dtype=torch.int64,
                       device=dev)
    bank_n = torch.zeros((plan.n_bank_n_rows, B), dtype=torch.int64,
                         device=dev)
    cb = torch.as_tensor(plan.cbank.astype("int64"), device=dev)[:, :, None]
    files = {"w": rf, "n": rf_n}
    table = plan.table.tolist()
    r_op, r_s0, rstarts = (plan.r_op.tolist(), plan.r_s0.tolist(),
                           plan.rstarts.tolist())
    for c in range(plan.n_chunks):
        base, base_n = c * (K + 1), c * (KN + 1)
        for rr in range(rstarts[c], rstarts[c + 1]):
            op = OPCODES[r_op[rr]]
            fl = _OPERAND_FILES.get(op, "www")
            narrow = op in _NARROW_RESULT
            for t in range(r_s0[rr], r_s0[rr + 1]):
                _op, ia, ib, ic, dst, em, aux = table[t]
                # the register operands, each from its file
                args = [files[f][r] for f, r in
                        zip(fl, (ia, ib, ic)[:N_OPERANDS[op]])]
                if narrow:
                    res = _narrow_step(op, field, args, cb, aux)
                    rf_n[dst] = res
                    bank_n[base_n + em] = res
                else:
                    res = _wide_step(op, field, args,
                                     cb[ib] if op in BANK_B else None, cb,
                                     aux)
                    rf[dst] = res
                    bank[base + em] = res
        # trailing REDC of this chunk's flagged Montgomery rows
        flagged = [base + r for r in range(K + 1)
                   if plan.mont_tab[base + r]]
        if flagged:
            rows = torch.as_tensor(flagged, dtype=torch.int64, device=dev)
            bank[rows] = field.mont_reduce64(bank[rows])
    return bank, bank_n


def _narrow_step(op, field, args, cb, aux):
    """One step of an opcode whose result is narrow (a signed 32-bit
    value, int64 (B,))."""
    if op in NARROW_OPS:
        return NARROW_OPS[op](args[0], args[1] if len(args) > 1 else None,
                              aux)
    if op == "nsel":
        return nsel(*args)
    if op == "nsel_w":
        return nsel(wide.nonzero(args[0]).to(torch.int64), args[1], args[2])
    if op == "nband_w":
        return wide.band_w(args[0], cb[aux])
    if op == "lnot_w":
        return (~wide.nonzero(args[0])).to(torch.int64)
    # the *_ww comparisons: limb 0 of the wide op's 0/1 result
    return wide.emit(field, op[:-3], *args)[0]


def _wide_step(op, field, args, crow, cb, aux):
    """One step of an opcode whose result is wide (limbs int64 (L, B));
    crow is the constant-bank row of the BANK_B opcodes."""
    x = args[0]
    if op == "copyw":
        return x
    if op == "mul":
        return field.mont_mul64(x, args[1])
    if op in ("mul_r2", "mul_one"):
        c = field.R2_limbs if op == "mul_r2" else field.one_limbs
        return field.mont_mul64(x, c.to(x.device))
    if op == "mul_c":
        return field.mont_mul64(x, crow)
    if op == "add_c":
        return field.add64(x, crow)
    if op == "sub_c":
        return field.sub64(x, crow)
    if op == "csub_c":
        return field.sub64(crow, x)
    if op == "gmul":
        return wide.gl_mul64(field, x, args[1])
    if op == "gmul_c":
        return wide.gl_mul64(field, x, crow)
    if op in ("shl_kw", "shr_kw"):
        return wide.shift_w(field, x, aux, op == "shl_kw")
    if op == "widen":
        return wide.widen64(field, x)
    if op == "idiv":
        return wide.idiv64(field, x, args[1])
    if op in ("dot2_c", "dot3_c"):
        # coefficients in bank rows aux..aux+n-1, an additive constant in
        # row aux+n; one reduction of the summed columns, then as many
        # subtracts of p as the field needs
        n = len(args)
        cols = sum(field.product_cols64(r, cb[aux + k])
                   for k, r in enumerate(args))
        cols[:field.L] += cb[aux + n]
        return field.mont_reduce_dot64(cols, n)
    return wide.emit(field, op, *args)


def gather_rows(bank, idx):
    """out[w] = bank[idx[w]] (the plain version of K2).  uint32 banks are
    gathered through an int32 view: PyTorch's uint32 lacks index_select
    on some devices."""
    src = bank.view(torch.int32) if bank.dtype == torch.uint32 else bank
    return src.index_select(0, idx.to(torch.int64)).view(bank.dtype)


def gather_n_rows(bank_n, x_n, src, shift):
    """The plain version of K3: row w of [bank_n; x_n] at src[w], with bit
    shift[w] unpacked where shift[w] >= 0.  int32 (R_n, B), (n_nin, B),
    (W,), (W,) -> int32 (W, B)."""
    rows = torch.cat([bank_n, x_n]).index_select(0, src.to(torch.int64))
    return unpack_bits(rows, shift)
