"""The witness interpreter on the card: kernel K1a, then the gather K2.

`TorchInterpreter(plan, field)._run(inputs)` maps uint32 inputs
(n_inputs, L, B) to the witness (n_witness, L, B).  On CUDA it launches the
interpreter kernel (ops/cuda/interp.cu), which also applies the trailing
REDC, and then the witness gather (ops/cuda/gather.cu).  On the CPU it runs
the plain executor of backend/interp_ref.py.

The layout is batch-minor throughout, (rows, L, B): bank row
chunk*(K+1) + em holds emission row em of a chunk.  The JAX package's
(8, bb) batch blocking and its paging of the tables over several kernel
calls answer the TPU's memory layout and do not exist here.
"""

import torch

from ..convert import DevicePlan, to_device
from ..ops.build import LAUNCHES, check_launch, library, stream_ptr, u32_array
from ..ops.field import TorchField, as_i64, as_u32
from .interp_ref import gather_rows, run_plan


def interp_k1a(plan: DevicePlan, field: TorchField, x_w):
    """Wide inputs uint32 (n_win, L, B) -> emission bank uint32
    (n_chunks * (K + 1), L, B), flagged rows reduced out of Montgomery
    form.  On CUDA, bank rows that no step writes are left unset."""
    if x_w.device.type == "cpu":
        return as_u32(run_plan(plan, field, as_i64(x_w)))
    if x_w.device != plan.device:
        raise ValueError(f"inputs on {x_w.device}, plan on {plan.device}")
    L = plan.L
    if x_w.dtype != torch.uint32 or x_w.dim() != 3 or x_w.shape[1] != L \
            or x_w.shape[0] != len(plan.win_order):
        raise ValueError(f"K1a takes uint32 ({len(plan.win_order)}, {L}, B)"
                         f", got {x_w.dtype} {tuple(x_w.shape)}")
    x_w = x_w.contiguous()
    B = x_w.shape[2]
    rf = torch.empty((plan.n_regs, L, B), dtype=torch.uint32,
                     device=x_w.device)
    bank = torch.empty((plan.n_bank_rows, L, B), dtype=torch.uint32,
                       device=x_w.device)
    d = plan.dev
    lib = library("interp")
    rc = lib.ctpu_interp_k1a(
        L, B, x_w.data_ptr(), x_w.shape[0], d["table"].data_ptr(),
        d["r_op"].data_ptr(), d["r_s0"].data_ptr(), d["rstarts"].data_ptr(),
        plan.n_chunks, d["cbank"].data_ptr(), d["mont_tab"].data_ptr(),
        d["mat_regs"].data_ptr(), d["mat_limbs"].data_ptr(),
        len(plan.mat_regs), rf.data_ptr(), bank.data_ptr(), plan.K,
        u32_array(field.p_list), u32_array(field.r2_list), field.n0inv,
        stream_ptr(x_w.device))
    LAUNCHES["interp_k1a"] += 1
    check_launch(rc, "interp_k1a")
    return bank


def gather_w(bank, idx):
    """Witness gather out[w] = bank[idx[w]]: uint32 (R, L, B), int32 (W,)
    -> (W, L, B)."""
    if bank.device.type == "cpu":
        return gather_rows(bank, idx)
    if bank.dtype != torch.uint32 or idx.dtype != torch.int32 \
            or idx.device != bank.device:
        raise ValueError("gather_w takes a uint32 bank and int32 indices "
                         "on one device")
    bank = bank.contiguous()
    idx = idx.contiguous()
    W = idx.shape[0]
    if W:
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= bank.shape[0]:
            raise IndexError(f"gather_w: index outside [0, {bank.shape[0]})")
    out = torch.empty((W,) + tuple(bank.shape[1:]), dtype=torch.uint32,
                      device=bank.device)
    row = bank[0].numel() if bank.shape[0] else 0
    lib = library("gather")
    rc = lib.ctpu_gather_rows(bank.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), row, W,
                              stream_ptr(bank.device))
    LAUNCHES["gather_w"] += 1
    check_launch(rc, "gather_w")
    return out


class TorchInterpreter:
    """Executable interpreter plan on one device."""

    def __init__(self, plan: DevicePlan, field: TorchField):
        if plan.L != field.L:
            raise ValueError(f"plan has {plan.L} limbs, field {field.L}")
        self.plan = plan
        self.field = field
        self.device = plan.device
        self.n_witness = len(plan.wit_rows)

    def _run(self, inputs):
        """uint32 (n_inputs, L, B) -> witness uint32 (n_witness, L, B)."""
        plan = self.plan
        if not isinstance(inputs, torch.Tensor):
            inputs = to_device(inputs, self.device)
        elif inputs.device != self.device:
            inputs = inputs.view(torch.int32).to(self.device) \
                .view(torch.uint32)
        order = torch.as_tensor(plan.win_order, dtype=torch.int64,
                                device=inputs.device)
        x_w = gather_rows(inputs, order)
        bank = interp_k1a(plan, self.field, x_w)
        return gather_w(bank, plan.dev["wit_rows"])
