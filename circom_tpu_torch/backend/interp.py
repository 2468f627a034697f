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
launch), which reads its wide and narrow inputs where the caller's input
rows lie (no split of the inputs runs before it), then for the full-limb
witness the assembly kernel KW
(ops/cuda/gather.cu: every witness row written once from its source, a
wide bank row, an input row, a constant or a narrow bank row unpacked and
widened), or K2 alone where the witness is the wide bank's rows in
witness order; for the mixed witness the narrow gather with bit unpack
K3 and the wide gather K2 (KW where the wide rows name inputs or
constants), K3 also reading the narrow inputs in the input rows.  A run
on the card is `torch.empty` and those launches alone, each kernel with
its allocation and arguments in a span of its name (`ctpu.interp_k1`,
`ctpu.assemble`, `ctpu.gather_w`, `ctpu.gather_n`; utils/profiling.py).
On the CPU it runs the plain versions: the input split (split_inputs, the
JAX package's split in _run) and backend/interp_ref.py for K1, K2 and K3,
and for KW the parts route (`assemble_parts`: the
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
from ..utils.profiling import span
from .interp_ref import gather_n_rows, gather_rows, run_plan
from .plan import UnsupportedTapeOp


def interp_k1(plan: DevicePlan, field: TorchField, inputs):
    """The caller's input rows uint32 (n_inputs, Lin, B) -> (wide bank
    uint32 (n_chunks * (K + 1), L, B), flagged rows reduced out of
    Montgomery form; narrow bank int32 (n_chunks * (KN + 1), B)).  K1
    reads its inputs where they lie (check_inputs: the rows it takes).
    On CUDA, bank rows that no step writes, and each chunk's dump rows,
    are left unset: the rows of plan.emitted_rows() are the output.  On
    the CPU the plain version: split_inputs, then k1_plain."""
    check_field(plan, field)
    check_inputs(plan, inputs)
    if inputs.device.type == "cpu":
        return k1_plain(plan, field, *split_inputs(plan, inputs))
    if inputs.device != plan.device:
        raise ValueError(f"inputs on {inputs.device}, plan on {plan.device}")
    return launch_k1(plan, field, inputs.contiguous())


def check_inputs(plan: DevicePlan, inputs):
    """Raises ValueError unless `inputs` are input rows that K1 and K3
    take for the plan: uint32 (n_inputs, Lin, B) with a row for every row
    that win_order and nin_order name, Lin 1, 2 or L, and L where the plan
    has a wide input.  Shapes and the plan's host tables only: no
    device-to-host sync."""
    if inputs.dtype != torch.uint32 or inputs.dim() != 3:
        raise ValueError(f"K1 takes uint32 (n_inputs, Lin, B) input rows, "
                         f"got {inputs.dtype} {tuple(inputs.shape)}")
    n, lin, _ = inputs.shape
    if n < plan.n_input_rows:
        raise ValueError(f"the plan reads input row {plan.n_input_rows - 1},"
                         f" got {n} rows")
    if lin not in (1, 2, plan.L):
        raise ValueError(f"input rows of {lin} limbs: K1 takes 1, 2 or "
                         f"{plan.L}")
    if plan.win_order and lin != plan.L:
        raise ValueError(f"wide inputs need full-limb input rows "
                         f"({plan.L} limbs), got {lin}")


def split_inputs(plan: DevicePlan, inputs):
    """The plain version of K1's input loads, the JAX package's split
    (backend/interp.py _run): input rows uint32 (n_inputs, Lin, B) -> (wide
    inputs uint32 (n_win, L, B), the rows of win_order; narrow inputs int32
    (n_nin, B) of the rows of nin_order, narrow_inputs)."""
    if plan.win_order:
        x_w = gather_rows(inputs, plan.dev["win_order"])
    else:
        x_w = torch.empty((0, plan.L, inputs.shape[-1]), dtype=torch.uint32,
                          device=inputs.device)
    return x_w, narrow_inputs(inputs, plan.dev["nin_order"])


def narrow_inputs(inputs, order):
    """Narrow inputs int32 (len(order), B): limb0 | limb1 << 16 of the
    input rows `order` (limb0 alone where the rows have one limb; limbs 2
    and up are not read), in 32 bits.  The plain version of K1's and K3's
    narrow loads."""
    if not order.shape[0]:
        return torch.empty((0, inputs.shape[-1]), dtype=torch.int32,
                           device=inputs.device)
    xs = as_i64(gather_rows(inputs, order))
    return to_i32(xs[:, 0] | (xs[:, 1] << 16) if inputs.shape[1] > 1
                  else xs[:, 0])


def k1_plain(plan: DevicePlan, field: TorchField, x_w, x_n):
    """K1's plain version after the split: wide inputs uint32 (n_win, L,
    B) and narrow inputs int32 (n_nin, B) -> interp_k1's banks, by
    interp_ref.run_plan."""
    bank, bank_n = run_plan(plan, field, as_i64(x_w), as_i64(x_n))
    return as_u32(bank), to_i32(bank_n)


def launch_k1(plan: DevicePlan, field: TorchField, inputs):
    """Launch K1 without checks on contiguous input rows on the plan's
    card that check_inputs takes: returns its (bank, bank_n)."""
    L, B, dev = plan.L, inputs.shape[-1], inputs.device
    with span("ctpu.interp_k1"):
        # the register files (each at least its trash row) and the banks
        rf = torch.empty(k1_file_shape(plan, B), dtype=torch.uint32,
                         device=dev)
        rf_n = torch.empty((plan.n_nregs, B), dtype=torch.int32, device=dev)
        bank = torch.empty((plan.n_bank_rows, L, B), dtype=torch.uint32,
                           device=dev)
        bank_n = torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                             device=dev)
        # one launch runs every part; it counts for each part its plan
        # runs (interp_k1a .. interp_k1d, convert.PARTS)
        launch("interp_k1", library("interp").ctpu_interp_k1, dev,
               *k1_args(plan, field, inputs, rf, bank, rf_n, bank_n,
                        stream_ptr(dev)), parts=plan.parts or ("interp_k1a",))
        return bank, bank_n


def k1_file_shape(plan: DevicePlan, B):
    """K1's wide register file, uint32: L/2 32-bit words a register a
    lane, (n_regs, L/2, B), or for goldilocks (L = 4) a register's two
    words side by side, (n_regs, B, 2): one 64-bit word."""
    if plan.L == 4:
        return (plan.n_regs, B, 2)
    return (plan.n_regs, plan.L // 2, B)


def k1_args(plan: DevicePlan, field: TorchField, inputs, rf, bank, rf_n,
            bank_n, stream):
    """The arguments of ctpu_interp_k1 (ops/cuda/interp.cu), in order: the
    input rows (n_inputs, Lin, B) and the rows of the wide and narrow
    inputs, the plan's device tables, the register files (scratch, rf of
    k1_file_shape) and banks, the field's constants and the stream."""
    d = plan.dev
    return (
        plan.L, inputs.shape[-1], inputs.data_ptr(), inputs.shape[1],
        d["win_order"].data_ptr(), len(plan.win_order),
        d["nin_order"].data_ptr(), len(plan.nin_order),
        d["table"].data_ptr(), d["grp"].data_ptr(),
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


def gather_n(bank_n, inputs, nin_order, src, shift):
    """Narrow witness gather: row src[w] of [bank_n; the narrow inputs],
    with bit shift[w] unpacked where shift[w] >= 0; narrow input k is
    limb0 | limb1 << 16 of input row nin_order[k] (narrow_inputs), read
    where it lies.  int32 (R_n, B), uint32 (n_inputs, Lin, B), int32
    (n_nin,), (W,), (W,) -> int32 (W, B).  On the card src and nin_order
    are first held inside their rows, a device-to-host sync."""
    if bank_n.device.type == "cpu":
        return gather_n_rows(bank_n, narrow_inputs(inputs, nin_order), src,
                             shift)
    dev = bank_n.device
    B = bank_n.shape[1]
    if any(t.dtype != torch.int32 or t.device != dev
           for t in (bank_n, nin_order, src, shift)) \
            or inputs.dtype != torch.uint32 or inputs.device != dev \
            or inputs.dim() != 3 or inputs.shape[2] != B \
            or src.shape != shift.shape:
        raise ValueError("gather_n takes int32 (R_n, B), uint32 (n_inputs, "
                         "Lin, B) and int32 (n_nin,), (W,), (W,) tensors on "
                         "one device")
    bank_n, inputs = bank_n.contiguous(), inputs.contiguous()
    nin_order = nin_order.contiguous()
    src, shift = src.contiguous(), shift.contiguous()
    _check_index(src, bank_n.shape[0] + nin_order.shape[0], "gather_n")
    _check_index(nin_order, inputs.shape[0], "gather_n's input rows")
    out = torch.empty((src.shape[0], B), dtype=torch.int32, device=dev)
    if out.numel():
        launch_gather_n(bank_n, inputs, nin_order, src, shift, out)
    return out


def launch_gather_n(bank_n, inputs, nin_order, src, shift, out):
    """Launch K3 without checks: contiguous int32 bank_n (R_n, B), uint32
    input rows (n_inputs, Lin, B), int32 nin_order (n_nin,) inside
    [0, n_inputs), src and shift (W,) and out (W, B) on the card, src
    inside [0, R_n + n_nin), W and B > 0."""
    W, B = out.shape
    launch("gather_n", library("gather").ctpu_gather_n, out.device,
           bank_n.data_ptr(), bank_n.shape[0], inputs.data_ptr(),
           inputs.shape[1], nin_order.data_ptr(), src.data_ptr(),
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
        with span("ctpu.gather_w"):
            out = torch.empty((idx.shape[0],) + tuple(bank.shape[1:]),
                              dtype=torch.uint32, device=self.device)
            if out.numel():
                launch_gather_w(bank, idx, out)
            return out

    def _gather_n(self, bank_n, inputs, src, shift):
        """K3 over the narrow bank and the narrow inputs, read in the
        contiguous input rows; on the CPU its plain version, after the
        plain split of the narrow inputs."""
        order = self.plan.dev["nin_order"]
        if self.device.type == "cpu":
            return gather_n_rows(bank_n, narrow_inputs(inputs, order), src,
                                 shift)
        with span("ctpu.gather_n"):
            out = torch.empty((src.shape[0], bank_n.shape[1]),
                              dtype=torch.int32, device=self.device)
            if out.numel():
                launch_gather_n(bank_n, inputs, order, src, shift, out)
            return out

    def mixed_layout(self):
        """(narrow witness indices, wide witness indices) in the row order
        of _run_mixed's two arrays."""
        return self.plan.nw_idx.tolist(), self.plan.wd_idx.tolist()

    def _inputs(self, inputs):
        """uint32 (n_inputs, Lin, B) -> (the input rows on the device,
        checked (check_inputs); the plain split of them (split_inputs):
        wide inputs uint32 (n_win, L, B), narrow inputs int32 (n_nin,
        B)).  The CPU's route, and the oracle's on the card: a run on the
        card never splits its inputs."""
        inputs = u32_on(inputs, self.device).contiguous()
        check_inputs(self.plan, inputs)
        return (inputs,) + split_inputs(self.plan, inputs)

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

    def assemble_parts(self, inputs, x_w, bank, bank_n):
        """KW's plain version, the parts route: the full-limb witness
        uint32 (n_witness, L, B) from K1's banks, _inputs' contiguous input
        rows and its x_w.  The wide rows (_wide_parts), the narrow
        emission rows (_gather_n, then ops/narrow.widen_narrow) and the
        narrow input rows (the input's own limbs) are made apart and each
        put into the witness; a part that is the witness, in witness
        order, is returned as it is.  The CPU's route, and KW's oracle on
        the card."""
        plan = self.plan
        B = inputs.shape[-1]
        parts = (
            lambda: self._wide_parts(bank, x_w, B),
            lambda: widen_narrow(self._gather_n(
                bank_n, inputs, self._nw_src, self._nw_shift),
                self.field.p, plan.L),
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
        with span("ctpu.assemble"):
            if out is None:
                out = torch.empty((tab.shape[0], self.plan.L,
                                   inputs.shape[-1]), dtype=torch.uint32,
                                  device=self.device)
            if out.numel():
                launch("assemble", library("gather").ctpu_assemble,
                       self.device, *kw_args(self.field, tab, bank, bank_n,
                                             inputs.contiguous(),
                                             self.plan.dev["consts"], out,
                                             stream_ptr(self.device)))
            return out

    def _run_mixed(self, inputs):
        """inputs uint32 (n_inputs, L or 2 (or 1), B) -> (narrow int32
        (n_nw, B), wide uint32 (n_wd, L, B)) in the row order of
        mixed_layout(): on the card K1, K3, then K2 (KW where the wide
        rows name inputs or constants), each reading the input rows where
        they lie (made contiguous first: a copy only where the caller's
        rows are a strided view, such as x[:, :2]); on the CPU the plain
        versions after the split."""
        plan = self.plan
        src, shift = plan.dev["nw_src"], plan.dev["nw_shift"]
        if self.device.type == "cpu":
            inputs, x_w, x_n = self._inputs(inputs)
            bank, bank_n = k1_plain(plan, self.field, x_w, x_n)
            narrow = gather_n_rows(bank_n, x_n, src, shift)
            return narrow, self._wide_parts(bank, x_w, inputs.shape[-1])
        inputs = u32_on(inputs, self.device).contiguous()
        bank, bank_n = interp_k1(plan, self.field, inputs)
        narrow = self._gather_n(bank_n, inputs, src, shift)
        if self._bank_only:
            return narrow, self._gather_w(bank, plan.dev["wd_src"])
        return narrow, self.assemble_kw(inputs, bank, bank_n, "wide")

    def _run(self, inputs):
        """uint32 (n_inputs, L, B) -> witness uint32 (n_witness, L, B): on
        the card K1, then KW (K2 alone where the witness is the wide
        bank's rows in witness order), each reading the input rows where
        they lie (made contiguous first, as in _run_mixed); on the CPU the
        plain versions after the split."""
        plan = self.plan
        inputs = u32_on(inputs, self.device).contiguous()
        if inputs.dim() != 3 or inputs.shape[1] != plan.L:
            raise ValueError(f"the full-limb witness needs full-limb input "
                             f"rows ({plan.L} limbs), got "
                             f"{tuple(inputs.shape)}")
        if self.device.type == "cpu":
            inputs, x_w, x_n = self._inputs(inputs)
            bank, bank_n = k1_plain(plan, self.field, x_w, x_n)
            return self.assemble_parts(inputs, x_w, bank, bank_n)
        bank, bank_n = interp_k1(plan, self.field, inputs)
        if self._k2_whole:
            return self._gather_w(bank, plan.dev["wd_src"])
        return self.assemble_kw(inputs, bank, bank_n)
