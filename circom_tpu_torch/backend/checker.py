"""Batched R1CS satisfaction checker: Az ∘ Bz − Cz == 0 for every witness.

The port of the JAX package's backend/checker.py, which runs the check as
one jitted XLA program.  The batch is checked a slice at a time, and each
slice gives the first violated row of each lane (`first_violated`):

- on a card, one launch of kernel KC (ops/cuda/check.cu) over the three
  matrices in CSR form: a thread a lane sums each row's products
  coeff·z[col] mod p, multiplies A's sum by B's and compares with C's;
- on the CPU, the plain route (`first_violated_plain`), the JAX
  program's steps in PyTorch (TorchField): the Montgomery form of z, for
  each matrix its COO list's products coeff·z[col] as one Montgomery
  multiply over all nonzeros, exact int64 `index_add_` row sums of the
  product limbs and one Montgomery reduction of the wide sums plus a
  multiply by R^2, then Az·Bz − Cz and a zero test.  KC is held against
  it bit for bit.

The slice width comes from a byte budget, the plain route's: a slice of
`lanes` witnesses holds, for the largest matrix, the (nnz, L, lanes)
uint32 gather, the uint32 product and its int64 copy, 16 bytes a
limb-lane.  So the slice is budget // (max_nnz · L · 16) lanes, capped by
`lanes=`: 8,192 lanes for Poseidon2 (2,345 nonzeros), about 260 for
SHA256 (80,458).  KC keeps the same slices; it splits each slice's rows
across blocks, so that a narrow slice still fills the card.
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

# device bytes a slice of the check may take for its largest matrix
SLICE_BUDGET_BYTES = 5 << 30

# KC's threads a block (one lane each; check.cu's KC_THREADS) and the
# blocks a launch aims for, row chunks times lane blocks: about eight
# waves of 128-thread blocks on an H100's 132 SMs
KC_THREADS = 128
KC_BLOCKS = 4096


def kc_rows_per_chunk(n_rows, b):
    """KC's rows a block: the rows cut into as many chunks as bring a
    slice of b lanes to about KC_BLOCKS blocks, at least one row each."""
    lane_blocks = -(-b // KC_THREADS)
    chunks = max(1, min(n_rows, KC_BLOCKS // lane_blocks))
    return -(-n_rows // chunks)


def kc_args(checker, zs, first, stream):
    """The arguments of ctpu_r1cs_check (ops/cuda/check.cu), in order: the
    slice, the three CSR matrices, the rows and their chunk, the field's
    constants, the output and the stream."""
    f, b = checker.field, zs.shape[-1]
    return (f.L, zs.data_ptr(), b,
            *[t.data_ptr() for m in checker.csr for t in m],
            checker.n_rows, kc_rows_per_chunk(checker.n_rows, b),
            build.u32_array(f.p_list), f.n0inv32, first.data_ptr(), stream)


class R1CSChecker:
    def __init__(self, rows, n_wires: int, spec: FieldSpec, device="cuda",
                 lanes=8192):
        """rows: list of (a, b, c) dicts wire->coeff (canonical ints)."""
        self.spec = spec
        self.device = resolve_device(device)
        self.field = TorchField(spec, self.device)
        self.n_rows = len(rows)
        self.n_wires = n_wires
        L = self.field.L
        R = 1 << (LIMB_BITS * L)
        p = spec.p
        self.coo = []
        # the same nonzeros in CSR form for KC: row pointers, columns and
        # coeff·R^2 mod p in L/2 32-bit words
        self.csr = []
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
            ptr = np.zeros(self.n_rows + 1, np.int32)
            np.cumsum(np.bincount(np.asarray(rws, np.int64),
                                  minlength=self.n_rows), out=ptr[1:])
            limbs = ints_to_limbs([c * R % p for c in coeffs], L)
            words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
            self.csr.append((to_device(ptr, self.device),
                             to_device(np.asarray(cols, np.int32),
                                       self.device),
                             to_device(words, self.device)))  # (nnz, L/2)
        self.R2 = as_u32(self.field.R2_limbs)  # (L, 1)
        max_nnz = max(len(rws) for rws, _, _ in self.coo)
        self.lanes = max(1, min(lanes, SLICE_BUDGET_BYTES
                                // (max(max_nnz, 1) * L * 16)))
        # this checker on each device it was asked for, itself included
        self._copies = {self.device: self}

    def for_device(self, device):
        """This checker on `device`: the same COO and CSR, carried there.
        One copy a device, kept."""
        device = resolve_device(device)
        twin = self._copies.get(device)
        if twin is None:
            twin = copy.copy(self)
            twin.device = device
            twin.field = TorchField(self.spec, device)
            twin.coo = [tuple(move(t, device) for t in m) for m in self.coo]
            twin.csr = [tuple(move(t, device) for t in m) for m in self.csr]
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
        """first_violated_plain's result: kernel KC for a slice on a card
        (it launches or raises), the plain route for one on the CPU."""
        if zs.device.type == "cpu":
            return self.first_violated_plain(zs)
        L, b = self.field.L, zs.shape[-1]
        if zs.dtype != torch.uint32 or zs.dim() != 3 or zs.shape[1] != L \
                or not zs.is_contiguous():
            raise ValueError(f"r1cs_check: a contiguous uint32 (n_wires, "
                             f"{L}, b) slice required, got {zs.dtype} "
                             f"{tuple(zs.shape)}")
        if zs.shape[0] <= self.max_col:
            raise ValueError(f"r1cs_check: {zs.shape[0]} wires, the "
                             f"matrices read wire {self.max_col}")
        if zs.device != self.csr[0][0].device:
            raise ValueError(f"r1cs_check: a slice on {zs.device}, the "
                             f"checker on {self.csr[0][0].device}")
        first = torch.full((b,), self.n_rows, dtype=torch.int32,
                           device=zs.device)
        if b and self.n_rows:
            build.launch("r1cs_check",
                         build.library("check").ctpu_r1cs_check, zs.device,
                         *kc_args(self, zs, first,
                                  build.stream_ptr(zs.device)))
        return first

    def _slices(self, z):
        if not isinstance(z, torch.Tensor):
            z = to_device(np.asarray(z, np.uint32), self.device)
        B = z.shape[-1]
        for s in range(0, B, self.lanes):
            yield z[..., s:s + self.lanes].contiguous()

    def check(self, z):
        """z: uint32 (n_wires, L, B) canonical witnesses (wire 0 = 1), the
        layout WitnessProgram.run produces.  Returns bool (B,)."""
        return self.check_detailed(z)[0]

    def check_detailed(self, z):
        """Like check(), but also returns the first violated constraint
        index per witness (0 where satisfied)."""
        oks, firsts = zip(*self.verdicts(z))
        return torch.cat(oks), torch.cat(firsts)

    def verdicts(self, z):
        """check_detailed's (ok, first) pairs, one a batch slice in batch
        order, each slice launched only when the previous pair is taken:
        the mesh takes the slices of several devices in turn."""
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
