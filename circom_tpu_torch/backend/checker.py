"""Batched R1CS satisfaction checker: Az ∘ Bz − Cz == 0 for every witness.

The port of the JAX package's backend/checker.py, which runs the check as
one jitted XLA program.  Each batch window gives the first violated row of
each lane (`first_violated`):

- on a card, one launch of kernel KC (ops/cuda/check.cu) over the three
  matrices, reading the window of z in place (its batch stride passed
  beside its lane count): a thread a lane sums each row's terms ±|c|·z
  exactly, by coefficient class, reduces each sum once, multiplies A's by
  B's and compares with C's;
- on the CPU, the plain route (`first_violated_plain`), the JAX
  program's steps in PyTorch (TorchField): the Montgomery form of z, for
  each matrix its COO list's products coeff·z[col] as one Montgomery
  multiply over all nonzeros, exact int64 `index_add_` row sums of the
  product limbs and one Montgomery reduction of the wide sums plus a
  multiply by R^2, then Az·Bz − Cz and a zero test.  KC is held against
  it bit for bit.

KC's matrices are built here once (`kc_matrix`): each row's nonzeros
classed by |c| = min(c, p − c) as units (|c| = 1), small (|c| < 2^32, one
coefficient word) or wide (N = L/2 words holding |c|·2^(32(N−1)) mod p),
wide first, with the sign of c − p/2 in the entry word.  Each row sum's
headroom is checked here too (`kc_headroom`): check.cu's header proves
the bound that this check enforces, so the kernel tests nothing at run
time.  A factor of one unit term enters the product as it is, and a row
with an empty C holds where A or B is zero: no product.

On a card the window is the whole batch unless the caller caps it with
`lanes=`; KC needs no temporaries.  On the CPU the window is cut by a byte
budget, the plain route's: a window of `lanes` witnesses holds, for the
largest matrix, the (nnz, L, lanes) uint32 gather, the uint32 product and
its int64 copy, 16 bytes a limb-lane.  So it is budget // (max_nnz · L ·
16) lanes, capped by `lanes=` (default 8,192): 8,192 lanes for Poseidon2
(2,345 nonzeros), about 260 for SHA256 (80,458), each copied contiguous.
"""

import copy

import numpy as np
import torch

from ..convert import move, to_device
from ..field.primes import LIMB_BITS, FieldSpec
from ..ops import build
from ..ops.field import TorchField, as_i64, as_u32
from ..ops.limbs import ints_to_limbs
from ..utils.device import resolve_device
from ..utils.profiling import span

# device bytes a CPU window of the check may take for its largest matrix
SLICE_BUDGET_BYTES = 5 << 30
# the CPU window's lanes where the caller names none
CPU_LANES = 8192

# KC's threads a block (one lane each; check.cu's KC_THREADS) and the
# blocks a launch aims for, row chunks times lane blocks: about eight
# waves of 128-thread blocks on an H100's 132 SMs
KC_THREADS = 128
KC_BLOCKS = 4096

# KC's coefficient classes and the least words of reduction of a row sum
# (check.cu's KC_UNIT, KC_SMALL, KC_WIDE and KC_J)
KC_UNIT, KC_SMALL, KC_WIDE = 0, 1, 2
KC_J = 2


def kc_rows_per_chunk(n_rows, b):
    """KC's rows a block: the rows cut into as many chunks as bring b
    lanes to about KC_BLOCKS blocks, at least one row each."""
    lane_blocks = -(-b // KC_THREADS)
    chunks = max(1, min(n_rows, KC_BLOCKS // lane_blocks))
    return -(-n_rows // chunks)


def kc_class(c, p):
    """(class, neg, |c|) of the coefficient c (canonical, mod p): |c| =
    min(c, p − c), neg when p − c < c (the term is −|c|·z); a unit when
    |c| = 1, small when |c| < 2^32 (0 included), else wide."""
    m = min(c, p - c)
    cls = KC_UNIT if m == 1 else KC_SMALL if m < 1 << 32 else KC_WIDE
    return cls, p - c < c, m


def kc_headroom(p, L, wide_sum, narrow_sum, wide):
    """Whether a row sum fits KC's one reduction (check.cu's header): |V|
    < (R − 1)·S below 2^(32 J)·p, with S the sum of the stored wide
    coefficients plus the small and unit |c| (2^(32(N−1)) times those
    where the row has wide terms) and J its least words of reduction,
    KC_J, or N − 1 + KC_J with wide terms."""
    N = L // 2
    J = KC_J + (N - 1 if wide else 0)
    scale = 1 << (32 * (N - 1)) if wide else 1
    R = 1 << (LIMB_BITS * L)
    return (R - 1) * (wide_sum + scale * narrow_sum) < (p << (32 * J))


def kc_matrix(rows, mi, p, L):
    """KC's form of matrix mi of `rows`: (ptr int32 (n_rows + 1), ent
    uint32), row r the words ent[ptr[r]:ptr[r + 1]]: its wide entries,
    then small, then units, each by column; an entry the word
    col << 3 | class << 1 | neg and its coefficient words (none, |c|, or
    |c|·2^(32(N−1)) mod p in N words).  Raises ValueError for a row sum
    beyond KC's headroom (`kc_headroom`) or a column of 2^29 or more."""
    N = L // 2
    shift = pow(2, 32 * (N - 1), p)
    ptr, ent = [0], []
    for r, row in enumerate(rows):
        terms = sorted((-cls, col, neg, m) for col, (cls, neg, m) in
                       ((col, kc_class(c, p)) for col, c in row[mi].items()))
        wide_sum = narrow_sum = 0
        for ncls, col, neg, m in terms:
            if col >= 1 << 29:
                raise ValueError(f"r1cs_check: column {col} beyond KC's "
                                 "2^29")
            ent.append(col << 3 | -ncls << 1 | int(neg))
            if -ncls == KC_WIDE:
                st = m * shift % p
                wide_sum += st
                ent.extend((st >> (32 * i)) & 0xFFFFFFFF for i in range(N))
            else:
                narrow_sum += m
                if -ncls == KC_SMALL:
                    ent.append(m)
        if not kc_headroom(p, L, wide_sum, narrow_sum,
                           bool(terms) and -terms[0][0] == KC_WIDE):
            raise ValueError(f"r1cs_check: row {r} of matrix {'ABC'[mi]} "
                             "is beyond KC's headroom")
        ptr.append(len(ent))
    if len(ent) >= 1 << 31:
        raise ValueError("r1cs_check: a matrix beyond int32 offsets")
    return np.asarray(ptr, np.int32), np.asarray(ent, np.uint32)


def kc_products(rows, p, L):
    """KC's 32x32->64-bit products a lane where every row holds (check.cu's
    bound): N a small term, N^2 a wide one, J·N a row sum's reduction (J
    its words: KC_J, 2·KC_J for C beside two reduced factors, N − 1 more
    with wide terms; none for a factor of one unit term, taken as it is),
    and 2·N^2 the product and its reduction where A, B and C are all
    non-empty; none a unit."""
    N = L // 2

    def unit(m):
        return len(m) == 1 and kc_class(next(iter(m.values())), p)[0] \
            == KC_UNIT

    total = 0
    for a, b, c in rows:
        if not (a and b):
            sums = [(c, KC_J)] if c else []
        elif not c:
            sums = [(a, KC_J), (b, KC_J)]
        else:
            a_raw = unit(a)
            b_raw = not a_raw and unit(b)
            sums = [(m, KC_J) for m, raw in ((a, a_raw), (b, b_raw))
                    if not raw]
            sums.append((c, KC_J if a_raw or b_raw else 2 * KC_J))
            total += 2 * N * N
        for m, J in sums:
            cls = [kc_class(v, p)[0] for v in m.values()]
            wide = cls.count(KC_WIDE)
            total += (cls.count(KC_SMALL) * N + wide * N * N
                      + (J + (N - 1 if wide else 0)) * N)
    return total


def kc_args(checker, zs, first, stream):
    """The arguments of ctpu_r1cs_check (ops/cuda/check.cu), in order: the
    window and its batch stride, the three matrices, the rows and their
    chunk, the field's constants, the output and the stream."""
    f, b = checker.field, zs.shape[-1]
    return (f.L, zs.data_ptr(), b, zs.stride(1),
            *[t.data_ptr() for m in checker.kc for t in m],
            checker.n_rows, kc_rows_per_chunk(checker.n_rows, b),
            build.u32_array(f.p_list), f.n0inv32, first.data_ptr(), stream)


def kc_window(z, L):
    """Whether z, uint32 (n_wires, L, b), is a window KC reads in place:
    lanes contiguous, limb and wire strides of a batch of stride(1)
    lanes."""
    return (z.dtype == torch.uint32 and z.dim() == 3 and z.shape[1] == L
            and z.stride(2) == 1 and z.stride(1) >= z.shape[2]
            and z.stride(0) == L * z.stride(1))


class R1CSChecker:
    def __init__(self, rows, n_wires: int, spec: FieldSpec, device="cuda",
                 lanes=None):
        """rows: list of (a, b, c) dicts wire->coeff (canonical ints).
        lanes: the most lanes a window (a launch of KC on a card; the
        plain route's cap, default CPU_LANES, on the CPU)."""
        self.spec = spec
        self.device = resolve_device(device)
        self.field = TorchField(spec, self.device)
        self.n_rows = len(rows)
        self.n_wires = n_wires
        L = self.field.L
        R = 1 << (LIMB_BITS * L)
        p = spec.p
        self.coo = []
        # the same nonzeros in KC's form: a (ptr, ent) pair a matrix
        self.kc = []
        self.max_col = -1
        for mi in range(3):
            rws, cols, coeffs = [], [], []
            for ri, row in enumerate(rows):
                for col, coef in sorted(row[mi].items()):
                    rws.append(ri)
                    cols.append(col)
                    coeffs.append((coef * R) % p)  # MONT form
            self.max_col = max([self.max_col, *cols])
            self.coo.append((
                torch.as_tensor(np.asarray(rws, np.int64),
                                device=self.device),
                torch.as_tensor(np.asarray(cols, np.int64),
                                device=self.device),
                to_device(ints_to_limbs(coeffs, L).reshape(-1, L, 1),
                          self.device),                 # (nnz, L, 1)
            ))
            self.kc.append(tuple(to_device(a, self.device)
                                 for a in kc_matrix(rows, mi, p, L)))
        self.R2 = as_u32(self.field.R2_limbs)  # (L, 1)
        max_nnz = max(len(rws) for rws, _, _ in self.coo)
        self.window = lanes
        self.lanes = max(1, min(lanes or CPU_LANES, SLICE_BUDGET_BYTES
                                // (max(max_nnz, 1) * L * 16)))
        # this checker on each device it was asked for, itself included
        self._copies = {self.device: self}

    def for_device(self, device):
        """This checker on `device`: the same COO and KC matrices, carried
        there.  One copy a device, kept."""
        device = resolve_device(device)
        twin = self._copies.get(device)
        if twin is None:
            twin = copy.copy(self)
            twin.device = device
            twin.field = TorchField(self.spec, device)
            twin.coo = [tuple(move(t, device) for t in m) for m in self.coo]
            twin.kc = [tuple(move(t, device) for t in m) for m in self.kc]
            twin.R2 = as_u32(twin.field.R2_limbs)
            self._copies[device] = twin
        return twin

    def _reduce_wide(self, sums):
        """int64 (..., L, B) row sums of MONT values (V < 2^16·p per row)
        -> canonical limbs mod p, keeping the summands' Montgomery scale:
        the reduction gives V·R^-1 mod p, the multiply by R^2 V mod p."""
        w = self.field.mont_reduce_cols(sums)
        return self.field.mont_mul(w, self.R2)

    def _matvec(self, mi, z_mont):
        """z_mont: uint32 (n_wires, L, B) MONT -> (n_rows, L, B) MONT."""
        L = self.field.L
        rws, cols, coeffs = self.coo[mi]
        B = z_mont.shape[-1]
        if len(rws) == 0:
            return torch.zeros((self.n_rows, L, B), dtype=torch.uint32,
                               device=z_mont.device)
        zc = z_mont.view(torch.int32).index_select(0, cols) \
            .view(torch.uint32)                            # (nnz, L, B)
        prod = self.field.mont_mul(zc, coeffs)             # < p
        sums = torch.zeros((self.n_rows, L, B), dtype=torch.int64,
                           device=z_mont.device)
        sums.index_add_(0, rws, as_i64(prod))
        return self._reduce_wide(sums)

    def _residual(self, z):
        """Az·Bz − Cz (times R) for one batch slice: (n_rows, L, B)."""
        f = self.field
        z_mont = f.to_mont(z)
        az = self._matvec(0, z_mont)   # Az·R
        bz = self._matvec(1, z_mont)   # Bz·R
        cz = self._matvec(2, z_mont)   # Cz·R
        # mont_mul(Az·R, Bz·R) = Az·Bz·R, the same R-scale as cz
        return f.sub(f.mont_mul(az, bz), cz)

    def first_violated_plain(self, zs):
        """KC's function in plain PyTorch: the first violated row of each
        lane of the slice zs, uint32 (n_wires, L, b), as int32 (b,);
        n_rows where the lane satisfies every row."""
        if self.n_rows == 0:
            return torch.zeros((zs.shape[-1],), dtype=torch.int32,
                               device=zs.device)
        bad = ~self.field.is_zero(self._residual(zs))  # (n_rows, b)
        first = bad.to(torch.uint8).argmax(dim=0)
        return torch.where(bad.any(dim=0), first, self.n_rows) \
            .to(torch.int32)

    def first_violated(self, zs):
        """first_violated_plain's result: kernel KC for a window on a card
        (it launches or raises), the plain route for one on the CPU.  On a
        card zs may be a window z[..., s:s + n] of a batch, read in
        place."""
        if zs.device.type == "cpu":
            return self.first_violated_plain(zs)
        L, b = self.field.L, zs.shape[-1]
        if not kc_window(zs, L):
            raise ValueError(f"r1cs_check: a uint32 (n_wires, {L}, b) window "
                             f"with lanes contiguous required, got "
                             f"{zs.dtype} {tuple(zs.shape)} strides "
                             f"{zs.stride()}")
        if zs.shape[0] <= self.max_col:
            raise ValueError(f"r1cs_check: {zs.shape[0]} wires, the "
                             f"matrices read wire {self.max_col}")
        if zs.device != self.kc[0][0].device:
            raise ValueError(f"r1cs_check: a window on {zs.device}, the "
                             f"checker on {self.kc[0][0].device}")
        with span("ctpu.r1cs_check"):
            first = torch.full((b,), self.n_rows, dtype=torch.int32,
                               device=zs.device)
            if b and self.n_rows:
                build.launch("r1cs_check",
                             build.library("check").ctpu_r1cs_check,
                             zs.device, *kc_args(self, zs, first,
                                                 build.stream_ptr(zs.device)))
            return first

    def _slices(self, z):
        """The batch's windows: on a card views of z (the whole batch
        unless `lanes=` capped it), on the CPU contiguous copies of
        self.lanes lanes."""
        if not isinstance(z, torch.Tensor):
            z = to_device(np.asarray(z, np.uint32), self.device)
        B = z.shape[-1]
        if z.device.type == "cpu":
            for s in range(0, B, self.lanes):
                yield z[..., s:s + self.lanes].contiguous()
            return
        if not kc_window(z, self.field.L):
            z = z.contiguous()
        width = self.window or max(B, 1)
        for s in range(0, B, width):
            yield z[..., s:s + width]

    def check(self, z):
        """z: uint32 (n_wires, L, B) canonical witnesses (wire 0 = 1), the
        layout WitnessProgram.run produces.  Returns bool (B,)."""
        return self.check_detailed(z)[0]

    def check_detailed(self, z):
        """Like check(), but also returns the first violated constraint
        index per witness (0 where satisfied)."""
        with span("ctpu.check"):
            oks, firsts = zip(*self.verdicts(z))
            if len(oks) == 1:          # one window: nothing to join
                return oks[0], firsts[0]
            return torch.cat(oks), torch.cat(firsts)

    def verdicts(self, z):
        """check_detailed's (ok, first) pairs, one a window in batch
        order (on a card one a batch unless `lanes=` capped it), each
        launched only when the previous pair is taken: the mesh takes the
        windows of several devices in turn."""
        if self.n_rows == 0:
            # fully-simplified systems (every constraint eliminated)
            # are vacuously satisfied
            B = z.shape[-1]
            yield (torch.ones((B,), dtype=torch.bool, device=self.device),
                   torch.zeros((B,), dtype=torch.int64, device=self.device))
            return
        for zs in self._slices(z):
            first = self.first_violated(zs)
            del zs
            ok = first == self.n_rows
            yield ok, torch.where(ok, 0, first).to(torch.int64)

    def check_witness_list(self, witnesses):
        """witnesses: list of lists of canonical ints -> bool per witness."""
        L = self.field.L
        arr = np.stack([ints_to_limbs(w, L) for w in witnesses], axis=0)
        arr = np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))
        return self.check(arr).cpu().numpy()
