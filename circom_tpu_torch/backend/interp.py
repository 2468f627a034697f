"""The witness interpreter on the card: kernel K1, then the witness's
assembly by KW (or the gather K2), and the mixed witness's gathers K2, K3.

`TorchInterpreter(plan, field)` runs a plan two ways:

- `_run(inputs)` maps uint32 inputs (n_inputs, L, B) to the full-limb
  witness (n_witness, L, B);
- `_run_mixed(inputs)` maps (n_inputs, L, B) inputs, or (n_inputs, 2, B)
  ones where no input is wide, to the mixed witness: narrow rows int32
  (n_nw, B) and wide rows uint32 (n_wd, L, B), in the row order of
  `mixed_layout()`.  A bit-class witness value stays one int32 (SHA256 at
  batch 65,536: 7.2 GB mixed, 115 GB in limbs).

On CUDA it launches the interpreter kernel K1 (ops/cuda/interp.cu: every
opcode of the planner, K1a to K1d, with the trailing REDC, in one
launch), then for the full-limb witness the assembly kernel KW
(ops/cuda/gather.cu: every witness row written once from its source, a
wide bank row, an input row, a constant or a narrow bank row unpacked and
widened), or K2 alone where the witness is the wide bank's rows in
witness order; for the mixed witness the narrow gather with bit unpack
K3 and the wide gather K2 (KW where the wide rows name inputs or
constants).  On the CPU it runs the plain versions: backend/interp_ref.py
for K1, K2 and K3, and for KW the parts route (`assemble_parts`: the
wide, narrow and narrow input rows gathered apart, the narrow ones
widened by ops/narrow.widen_narrow, each put into the witness), as the
JAX package assembles the witness in XLA.

The layout is batch-minor throughout: wide bank row chunk*(K+1) + em and
narrow bank row chunk*(KN+1) + em hold emission row em of a chunk.  The
JAX package's (8, bb) batch blocking and its paging of the tables over
several kernel calls answer the TPU's memory layout and do not exist here.
"""

import numpy as np
import torch

from ..convert import GOLDILOCKS_OPS, DevicePlan, to_device, u32_on
from ..ops.build import launch, library, stream_ptr, u32_array
from ..ops.field import GOLDILOCKS_P, TorchField, as_i64, as_u32
from ..ops.limbs import int_to_limbs
from ..ops.narrow import to_i32, widen_narrow
from .interp_ref import gather_n_rows, gather_rows, run_plan
from .plan import UnsupportedTapeOp


def interp_k1(plan: DevicePlan, field: TorchField, x_w, x_n):
    """Wide inputs uint32 (n_win, L, B) and narrow inputs int32 (n_nin, B)
    -> (wide bank uint32 (n_chunks * (K + 1), L, B), flagged rows reduced
    out of Montgomery form; narrow bank int32 (n_chunks * (KN + 1), B)).
    On CUDA, bank rows that no step writes, and each chunk's dump rows,
    are left unset: the rows of plan.emitted_rows() are the output."""
    check_field(plan, field)
    if x_w.device.type == "cpu":
        bank, bank_n = run_plan(plan, field, as_i64(x_w), as_i64(x_n))
        return as_u32(bank), to_i32(bank_n)
    if x_w.device != plan.device or x_n.device != plan.device:
        raise ValueError(f"inputs on {x_w.device}/{x_n.device}, plan on "
                         f"{plan.device}")
    L, B = plan.L, x_w.shape[-1]
    if x_w.dtype != torch.uint32 or x_w.dim() != 3 or x_w.shape[1] != L \
            or x_w.shape[0] != len(plan.win_order):
        raise ValueError(f"K1 takes uint32 ({len(plan.win_order)}, {L}, B) "
                         f"wide inputs, got {x_w.dtype} {tuple(x_w.shape)}")
    if x_n.dtype != torch.int32 or tuple(x_n.shape) != \
            (len(plan.nin_order), B):
        raise ValueError(f"K1 takes int32 ({len(plan.nin_order)}, {B}) "
                         f"narrow inputs, got {x_n.dtype} "
                         f"{tuple(x_n.shape)}")
    return launch_k1(plan, field, x_w.contiguous(), x_n.contiguous())


def launch_k1(plan: DevicePlan, field: TorchField, x_w, x_n):
    """Launch K1 without checks on contiguous inputs on the plan's card,
    of the shapes interp_k1 takes: returns its (bank, bank_n)."""
    L, B, dev = plan.L, x_w.shape[-1], x_w.device
    # the register files (each at least its trash row) and the banks
    rf = torch.empty(k1_file_shape(plan, B), dtype=torch.uint32, device=dev)
    rf_n = torch.empty((plan.n_nregs, B), dtype=torch.int32, device=dev)
    bank = torch.empty((plan.n_bank_rows, L, B), dtype=torch.uint32,
                       device=dev)
    bank_n = torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                         device=dev)
    # one launch runs every part; it counts for each part its plan runs
    # (interp_k1a .. interp_k1d, convert.PARTS)
    launch("interp_k1", library("interp").ctpu_interp_k1, dev,
           *k1_args(plan, field, x_w, x_n, rf, bank, rf_n, bank_n,
                    stream_ptr(dev)), parts=plan.parts or ("interp_k1a",))
    return bank, bank_n


def k1_file_shape(plan: DevicePlan, B):
    """K1's wide register file, uint32: L/2 32-bit words a register a
    lane, (n_regs, L/2, B), or for goldilocks (L = 4) a register's two
    words side by side, (n_regs, B, 2): one 64-bit word."""
    if plan.L == 4:
        return (plan.n_regs, B, 2)
    return (plan.n_regs, plan.L // 2, B)


def k1_args(plan: DevicePlan, field: TorchField, x_w, x_n, rf, bank, rf_n,
            bank_n, stream):
    """The arguments of ctpu_interp_k1 (ops/cuda/interp.cu), in order: the
    inputs, the plan's device tables, the register files (scratch, rf of
    k1_file_shape) and banks, the field's constants and the stream."""
    d = plan.dev
    return (
        plan.L, x_w.shape[-1], x_w.data_ptr(), x_w.shape[0], x_n.data_ptr(),
        x_n.shape[0], d["table"].data_ptr(), d["grp"].data_ptr(),
        d["r_op"].data_ptr(), d["r_s0"].data_ptr(),
        d["rstarts"].data_ptr(), plan.n_chunks, d["cbank_w"].data_ptr(),
        d["mont_tab"].data_ptr(), d["mat_regs"].data_ptr(),
        d["mat_limbs"].data_ptr(), len(plan.mat_regs),
        d["nmat_vals"].data_ptr(), d["nmat_regs"].data_ptr(),
        len(plan.nmat_regs), rf.data_ptr(), bank.data_ptr(), plan.K,
        rf_n.data_ptr(), bank_n.data_ptr(), plan.KN,
        u32_array(field.p_list), u32_array(field.r2_list), field.n0inv32,
        u32_array(field.half_list), u32_array(field.mask_list),
        u32_array(field.q_list), field.p.bit_length(),
        int(bool({"interp_k1c", "interp_k1d"} & set(plan.parts))), stream)


def check_field(plan: DevicePlan, field: TorchField):
    """The plan's limbs are the field's, and goldilocks' folded products
    run on goldilocks only."""
    if plan.L != field.L:
        raise ValueError(f"plan has {plan.L} limbs, field {field.L}")
    gl = sorted(plan.opcodes & GOLDILOCKS_OPS)
    if gl and field.p != GOLDILOCKS_P:
        raise UnsupportedTapeOp(
            f"{', '.join(gl)}: goldilocks' folded products, on the "
            f"{field.spec.name} field")


def gather_w(bank, idx):
    """Witness gather out[w] = bank[idx[w]]: uint32 (R, L, B), int32 (W,)
    -> (W, L, B).  On the card the indices are first held inside [0, R),
    a device-to-host sync."""
    if bank.device.type == "cpu":
        return gather_rows(bank, idx)
    if bank.dtype != torch.uint32 or idx.dtype != torch.int32 \
            or idx.device != bank.device:
        raise ValueError("gather_w takes a uint32 bank and int32 indices "
                         "on one device")
    bank = bank.contiguous()
    idx = idx.contiguous()
    _check_index(idx, bank.shape[0], "gather_w")
    out = torch.empty((idx.shape[0],) + tuple(bank.shape[1:]),
                      dtype=torch.uint32, device=bank.device)
    if out.numel():
        launch_gather_w(bank, idx, out)
    return out


def launch_gather_w(bank, idx, out):
    """Launch K2 without checks: contiguous uint32 bank (R, ...) and out
    (W, ...) on the card, int32 idx (W,) inside [0, R), W > 0."""
    launch("gather_w", library("gather").ctpu_gather_rows, bank.device,
           bank.data_ptr(), idx.data_ptr(), out.data_ptr(), bank[0].numel(),
           idx.shape[0], stream_ptr(bank.device))


def gather_n(bank_n, x_n, src, shift):
    """Narrow witness gather: row src[w] of [bank_n; x_n], with bit
    shift[w] unpacked where shift[w] >= 0.  int32 (R_n, B), (n_nin, B),
    (W,), (W,) -> int32 (W, B).  On the card src is first held inside
    the rows, a device-to-host sync."""
    if bank_n.device.type == "cpu":
        return gather_n_rows(bank_n, x_n, src, shift)
    dev = bank_n.device
    B = bank_n.shape[1]
    if any(t.dtype != torch.int32 or t.device != dev
           for t in (bank_n, x_n, src, shift)) or x_n.shape[1:] != (B,) \
            or src.shape != shift.shape:
        raise ValueError("gather_n takes int32 (R_n, B), (n_nin, B), (W,) "
                         "and (W,) tensors on one device")
    bank_n, x_n = bank_n.contiguous(), x_n.contiguous()
    src, shift = src.contiguous(), shift.contiguous()
    _check_index(src, bank_n.shape[0] + x_n.shape[0], "gather_n")
    out = torch.empty((src.shape[0], B), dtype=torch.int32, device=dev)
    if out.numel():
        launch_gather_n(bank_n, x_n, src, shift, out)
    return out


def launch_gather_n(bank_n, x_n, src, shift, out):
    """Launch K3 without checks: contiguous int32 bank_n (R_n, B), x_n
    (n_nin, B), src and shift (W,) and out (W, B) on the card, src inside
    [0, R_n + n_nin), W and B > 0."""
    W, B = out.shape
    launch("gather_n", library("gather").ctpu_gather_n, out.device,
           bank_n.data_ptr(), bank_n.shape[0], x_n.data_ptr(), src.data_ptr(),
           shift.data_ptr(), out.data_ptr(), W, B, stream_ptr(out.device))


# KW's row kinds, column 0 of its table (ops/cuda/gather.cu): a wide bank
# row, an input row (a wide input, or a narrow input's own limbs), a
# constant, a narrow bank row (bit `shift` unpacked, then widened)
KW_BANK, KW_INPUT, KW_CONST, KW_NARROW = range(4)


def _take(a, i):
    """a[i] where i lies inside a; 0 elsewhere (rows the caller drops)."""
    if not len(a):
        return np.zeros(len(i), np.int64)
    return a[np.clip(i, 0, len(a) - 1)]


def _kinds(n, cases):
    """(kind, source) of n rows from disjoint (kind, mask, source) cases;
    kind -1 where no mask holds."""
    kind, src = np.full(n, -1, np.int64), np.zeros(n, np.int64)
    for k, mask, v in cases:
        kind = np.where(mask, k, kind)
        src = np.where(mask, v, src)
    return kind, src


def kw_table(plan: DevicePlan):
    """KW's table of the plan's full-limb witness: int32 (n_witness, 4),
    row w (kind, source row, shift, 0) in witness order, a KW_INPUT source
    a row of the full-limb inputs.  Checked once, here, so that a run
    syncs nothing: raises ValueError if a witness row is written other
    than once or a source lies outside its tensor (the wide inputs' empty
    slot, which no plan names, included)."""
    n_w = plan.n_witness
    pos = np.concatenate([plan.wd_idx, plan.nw_idx]).astype(np.int64)
    if pos.size and (pos.min() < 0 or pos.max() >= n_w) or \
            (np.bincount(pos, minlength=n_w) != 1).any():
        raise ValueError("KW's table writes a witness row other than once")
    win = np.asarray(plan.win_order, np.int64)
    nin = np.asarray(plan.nin_order, np.int64)
    # wide rows read [wide bank; wide inputs (at least one slot); consts]
    s = plan.wd_src.astype(np.int64)
    slot = s - plan.n_bank_rows
    c = slot - max(len(win), 1)
    wk, ws = _kinds(len(s), [
        (KW_BANK, (s >= 0) & (slot < 0), s),
        (KW_INPUT, (slot >= 0) & (slot < len(win)), _take(win, slot)),
        (KW_CONST, (c >= 0) & (c < len(plan.consts)), c)])
    # narrow rows read [narrow bank; narrow inputs]
    s = plan.nw_src.astype(np.int64)
    slot = s - plan.n_bank_n_rows
    nk, ns = _kinds(len(s), [
        (KW_NARROW, (s >= 0) & (slot < 0), s),
        (KW_INPUT, (slot >= 0) & (slot < len(nin)), _take(nin, slot))])
    if (wk < 0).any() or (nk < 0).any():
        raise ValueError("KW's table names a source row outside its tensor")
    tab = np.zeros((n_w, 4), np.int32)
    tab[plan.wd_idx, 0], tab[plan.wd_idx, 1] = wk, ws
    tab[plan.nw_idx, 0], tab[plan.nw_idx, 1] = nk, ns
    tab[plan.nw_idx, 2] = np.where(nk == KW_NARROW, plan.nw_shift, 0)
    return tab


def kw_inputs(tab):
    """The input rows a KW table reads: 1 + its largest KW_INPUT source."""
    return int(tab[tab[:, 0] == KW_INPUT, 1].max(initial=-1)) + 1


def kw_q(field: TorchField):
    """p - 2^32 in the field's 16-bit limbs: the negative widening's
    addend."""
    return int_to_limbs(field.p - (1 << 32), field.L)


def kw_args(field: TorchField, tab, bank, bank_n, inputs, consts, out,
            stream):
    """ctpu_assemble's arguments (ops/build.py SIGNATURES["gather"]) for
    KW's table tab int32 (W, 4) over the wide bank uint32 (R, L, B), the
    narrow bank int32 (R_n, B), the full-limb inputs uint32 (n_inputs, L,
    B) and the constants uint32 (n_const, L), into out uint32 (W, L, B);
    all contiguous on one device."""
    return (field.L, out.shape[-1], tab.data_ptr(), tab.shape[0],
            bank.data_ptr(), bank_n.data_ptr(), inputs.data_ptr(),
            consts.data_ptr(), u32_array(kw_q(field)), out.data_ptr(),
            stream)


def _check_index(idx, n, what):
    if idx.shape[0]:
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"{what}: index outside [0, {n})")


class TorchInterpreter:
    """Executable interpreter plan on one device."""

    def __init__(self, plan: DevicePlan, field: TorchField):
        check_field(plan, field)
        self.plan = plan
        self.field = field
        self.device = plan.device
        self.n_witness = plan.n_witness
        # the full-limb witness in parts (the parts route, KW's plain
        # version), by where its rows come from: the wide rows, the narrow
        # emission rows (K3, then the widening) and the narrow input rows
        # (the input's own limbs).  Their index
        # tensors live on the device from here on, so that a run copies
        # nothing from the host after its launches (a copy from the host
        # would wait for them).
        emitted = plan.nw_src < plan.n_bank_n_rows
        narrow = self._as_index(np.flatnonzero(emitted))
        pos = (plan.wd_idx, plan.nw_idx[emitted], plan.nw_idx[~emitted])
        self._part_pos = [self._as_index(idx) for idx in pos]
        self._part_len = [len(idx) for idx in pos]
        self._nw_src = plan.dev["nw_src"][narrow]
        self._nw_shift = plan.dev["nw_shift"][narrow]
        self._nin_rows = plan.dev["nin_order"][self._as_index(
            plan.nw_src[~emitted] - plan.n_bank_n_rows)]
        # the part that is the witness: the only one, in witness order
        present = [k for k, idx in enumerate(pos) if len(idx)]
        self._whole = present[0] if len(present) == 1 and np.array_equal(
            pos[present[0]], np.arange(plan.n_witness)) else None
        # the wide rows name the wide bank alone (the planned circuits'
        # case), and on the card the witness is then K2's gather of them
        self._bank_only = not len(plan.wd_src) or \
            plan.wd_src.max() < plan.n_bank_rows
        self._k2_whole = self._whole == 0 and self._bank_only
        # KW's tables, checked here and then kept on the device: the
        # full-limb witness's and its wide rows' (run_mixed's)
        tab = kw_table(plan)
        host = {"full": tab, "wide": tab[plan.wd_idx]}
        self._kw_inputs = {k: kw_inputs(t) for k, t in host.items()}
        self._kw = {k: to_device(t, self.device) for k, t in host.items()}

    # The plan's gathers.  Their indices were held inside the rows when
    # the plan was built (convert.plan_from_arrays), so on the card they
    # launch K2 and K3 without the public wrappers' index check and its
    # device-to-host sync.
    def _gather_w(self, bank, idx):
        if self.device.type == "cpu":
            return gather_rows(bank, idx)
        out = torch.empty((idx.shape[0],) + tuple(bank.shape[1:]),
                          dtype=torch.uint32, device=self.device)
        if out.numel():
            launch_gather_w(bank, idx, out)
        return out

    def _gather_n(self, bank_n, x_n, src, shift):
        if self.device.type == "cpu":
            return gather_n_rows(bank_n, x_n, src, shift)
        out = torch.empty((src.shape[0], bank_n.shape[1]), dtype=torch.int32,
                          device=self.device)
        if out.numel():
            launch_gather_n(bank_n, x_n, src, shift, out)
        return out

    def mixed_layout(self):
        """(narrow witness indices, wide witness indices) in the row order
        of _run_mixed's two arrays."""
        return self.plan.nw_idx.tolist(), self.plan.wd_idx.tolist()

    def _inputs(self, inputs):
        """uint32 (n_inputs, Lin, B) -> (inputs on the device, wide inputs
        uint32 (n_win, L, B) in win_of order, narrow inputs int32
        (n_nin, B) in nin_of order: limb0 | limb1 << 16).  Lin may be 2
        (or 1) when no input is wide."""
        plan = self.plan
        inputs = u32_on(inputs, self.device)
        n, lin, B = inputs.shape
        if plan.win_order:
            if lin != plan.L:
                raise ValueError(f"wide inputs need full-limb input rows "
                                 f"({plan.L} limbs), got {lin}")
            x_w = gather_rows(inputs, plan.dev["win_order"])
        else:
            x_w = torch.empty((0, plan.L, B), dtype=torch.uint32,
                              device=self.device)
        if plan.nin_order:
            xs = as_i64(gather_rows(inputs, plan.dev["nin_order"]))
            v = xs[:, 0] | (xs[:, 1] << 16) if lin > 1 else xs[:, 0]
            x_n = to_i32(v)
        else:
            x_n = torch.empty((0, B), dtype=torch.int32, device=self.device)
        return inputs, x_w, x_n

    def _as_index(self, a):
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    @staticmethod
    def _put(out, pos, rows):
        """out[pos] = rows, pos an index tensor (through int32 views:
        PyTorch's uint32 has no index_put)."""
        out.view(torch.int32)[pos] = rows.view(torch.int32)

    def _wide_parts(self, bank, x_w, B):
        """The wide rows of the witness, uint32 (n_wd, L, B), by the parts
        route: rows of [wide bank; wide inputs (at least one slot);
        consts] at wd_src, gathered by K2.  Planned circuits emit every
        witness row, so the source is the bank alone unless a plan names
        inputs or consts."""
        plan = self.plan
        if self._bank_only:
            return self._gather_w(bank, plan.dev["wd_src"])
        slots = x_w if len(plan.win_order) else torch.zeros(
            (1, plan.L, B), dtype=torch.uint32, device=self.device)
        consts = plan.dev["consts"][:, :, None].expand(-1, -1, B)
        source = torch.cat([t.view(torch.int32) for t in (bank, slots,
                                                           consts)])
        return self._gather_w(source.view(torch.uint32), plan.dev["wd_src"])

    def assemble_parts(self, inputs, x_w, x_n, bank, bank_n):
        """KW's plain version, the parts route: the full-limb witness
        uint32 (n_witness, L, B) from K1's banks, the inputs on the device
        and _inputs' x_w, x_n.  The wide rows (_wide_parts), the narrow
        emission rows (K3, then ops/narrow.widen_narrow) and the narrow
        input rows (the input's own limbs) are made apart and each put
        into the witness; a part that is the witness, in witness order,
        is returned as it is.  The CPU's route, and KW's oracle on the
        card."""
        plan = self.plan
        B = inputs.shape[-1]
        parts = (
            lambda: self._wide_parts(bank, x_w, B),
            lambda: widen_narrow(self._gather_n(
                bank_n, x_n, self._nw_src, self._nw_shift), self.field.p,
                plan.L),
            lambda: gather_rows(inputs, self._nin_rows),
        )
        if self._whole is not None:
            return parts[self._whole]()
        out = torch.empty((plan.n_witness, plan.L, B), dtype=torch.uint32,
                          device=self.device)
        for pos, n, rows in zip(self._part_pos, self._part_len, parts):
            if n:
                self._put(out, pos, rows())
        return out

    def assemble_kw(self, inputs, bank, bank_n, rows="full", out=None):
        """KW on the card, one launch: the full-limb witness uint32
        (n_witness, L, B) (rows="full"), or its wide rows in wd_src's
        order (rows="wide"), from K1's banks, the full-limb inputs on the
        device and the plan's constants, into `out` where given (a
        contiguous tensor of that shape).  The table was checked when the
        interpreter was made; there is no other route."""
        tab = self._kw[rows]
        if inputs.shape[0] < self._kw_inputs[rows]:
            raise ValueError(f"KW reads {self._kw_inputs[rows]} input rows, "
                             f"got {inputs.shape[0]}")
        if out is None:
            out = torch.empty((tab.shape[0], self.plan.L, inputs.shape[-1]),
                              dtype=torch.uint32, device=self.device)
        if out.numel():
            launch("assemble", library("gather").ctpu_assemble, self.device,
                   *kw_args(self.field, tab, bank, bank_n,
                            inputs.contiguous(), self.plan.dev["consts"],
                            out, stream_ptr(self.device)))
        return out

    def _run_mixed(self, inputs):
        """inputs uint32 (n_inputs, L or 2, B) -> (narrow int32 (n_nw, B),
        wide uint32 (n_wd, L, B)) in the row order of mixed_layout()."""
        plan = self.plan
        inputs, x_w, x_n = self._inputs(inputs)
        B = x_w.shape[-1]
        bank, bank_n = interp_k1(plan, self.field, x_w, x_n)
        if len(plan.nw_src):
            narrow = self._gather_n(bank_n, x_n, plan.dev["nw_src"],
                                    plan.dev["nw_shift"])
        else:
            narrow = torch.empty((0, B), dtype=torch.int32,
                                 device=self.device)
        if self.device.type == "cpu" or self._bank_only:
            return narrow, self._wide_parts(bank, x_w, B)
        return narrow, self.assemble_kw(inputs, bank, bank_n, "wide")

    def _run(self, inputs):
        """uint32 (n_inputs, L, B) -> witness uint32 (n_witness, L, B): on
        the card K1, then KW (K2 alone where the witness is the wide
        bank's rows in witness order); on the CPU the plain versions."""
        plan = self.plan
        inputs, x_w, x_n = self._inputs(inputs)
        if inputs.shape[1] != plan.L:
            raise ValueError(f"the full-limb witness needs full-limb input "
                             f"rows ({plan.L} limbs), got {inputs.shape[1]}")
        bank, bank_n = interp_k1(plan, self.field, x_w, x_n)
        if self.device.type == "cpu":
            return self.assemble_parts(inputs, x_w, x_n, bank, bank_n)
        if self._k2_whole:
            return self._gather_w(bank, plan.dev["wd_src"])
        return self.assemble_kw(inputs, bank, bank_n)
