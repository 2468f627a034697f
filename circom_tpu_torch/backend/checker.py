"""Batched R1CS satisfaction checker: Az ∘ Bz − Cz == 0 for every witness.

The port of the JAX package's backend/checker.py.  Each matrix is a COO
list (row, col, coeff); the products coeff·z[col] run as one Montgomery
multiply over all nonzeros (kernel K5 on CUDA), the row sums are exact
int64 `index_add_` sums of the product limbs, and one Montgomery reduction
of the wide sums plus a multiply by R^2 brings them back into the field.
The final Az·Bz − Cz uses K5 and the subtract kernel K6.

The batch is checked in slices whose width comes from a byte budget: a
slice of `lanes` witnesses holds, for the largest matrix, the
(nnz, L, lanes) uint32 gather, the uint32 product and its int64 copy, 16
bytes a limb-lane.  So the slice is budget // (max_nnz · L · 16) lanes,
capped by `lanes=`: 8,192 lanes for Poseidon2 (2,345 nonzeros), about 260
for SHA256 (80,458).
"""

import copy

import numpy as np
import torch

from ..convert import move, to_device
from ..field.primes import LIMB_BITS, FieldSpec
from ..ops import field_kernels as fk
from ..ops.field import TorchField, as_i64, as_u32
from ..ops.limbs import ints_to_limbs
from ..utils.device import resolve_device

# device bytes a slice of the check may take for its largest matrix
SLICE_BUDGET_BYTES = 5 << 30


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
        for mi in range(3):
            rws, cols, coeffs = [], [], []
            for ri, row in enumerate(rows):
                for col, coef in sorted(row[mi].items()):
                    rws.append(ri)
                    cols.append(col)
                    coeffs.append((coef * R) % p)  # MONT form
            self.coo.append((
                torch.as_tensor(np.asarray(rws, np.int64),
                                device=self.device),
                torch.as_tensor(np.asarray(cols, np.int64),
                                device=self.device),
                to_device(ints_to_limbs(coeffs, L).reshape(-1, L, 1),
                          self.device),                 # (nnz, L, 1)
            ))
        self.R2 = as_u32(self.field.R2_limbs)  # (L, 1)
        max_nnz = max(len(rws) for rws, _, _ in self.coo)
        self.lanes = max(1, min(lanes, SLICE_BUDGET_BYTES
                                // (max(max_nnz, 1) * L * 16)))
        # this checker on each device it was asked for, itself included
        self._copies = {self.device: self}

    def for_device(self, device):
        """This checker on `device`: the same COO, carried there.  One
        copy a device, kept."""
        device = resolve_device(device)
        twin = self._copies.get(device)
        if twin is None:
            twin = copy.copy(self)
            twin.device = device
            twin.field = TorchField(self.spec, device)
            twin.coo = [tuple(move(t, device) for t in m) for m in self.coo]
            twin.R2 = as_u32(twin.field.R2_limbs)
            self._copies[device] = twin
        return twin

    def _reduce_wide(self, sums):
        """int64 (..., L, B) row sums of MONT values (V < 2^16·p per row)
        -> canonical limbs mod p, keeping the summands' Montgomery scale:
        the reduction gives V·R^-1 mod p, the multiply by R^2 V mod p."""
        w = self.field.mont_reduce_cols(sums)
        return fk.mont_mul(self.field, w, self.R2)

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
        prod = fk.mont_mul(self.field, zc, coeffs)         # < p
        sums = torch.zeros((self.n_rows, L, B), dtype=torch.int64,
                           device=z_mont.device)
        sums.index_add_(0, rws, as_i64(prod))
        return self._reduce_wide(sums)

    def _residual(self, z):
        """Az·Bz − Cz (times R) for one batch slice: (n_rows, L, B)."""
        z_mont = fk.to_mont(self.field, z)
        az = self._matvec(0, z_mont)   # Az·R
        bz = self._matvec(1, z_mont)   # Bz·R
        cz = self._matvec(2, z_mont)   # Cz·R
        # mont_mul(Az·R, Bz·R) = Az·Bz·R, the same R-scale as cz
        return fk.sub(self.field, fk.mont_mul(self.field, az, bz), cz)

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
            bad = ~self.field.is_zero(self._residual(zs))  # (n_rows, b)
            del zs
            ok, first = ~bad.any(dim=0), bad.to(torch.uint8).argmax(dim=0)
            del bad
            yield ok, first

    def check_witness_list(self, witnesses):
        """witnesses: list of lists of canonical ints -> bool per witness."""
        L = self.field.L
        arr = np.stack([ints_to_limbs(w, L) for w in witnesses], axis=0)
        arr = np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))
        return self.check(arr).cpu().numpy()
