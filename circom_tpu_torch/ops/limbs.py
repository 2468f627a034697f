"""Limb-plane codec: Python ints <-> base-2^16 uint32 limb arrays.

The TPU backend stores a batch of field elements as a ``uint32[..., L]``
array of little-endian base-2^16 limbs (L = ceil(p.bit_length()/16)).
16-bit limbs in 32-bit lanes leave headroom so that products of two limbs
(< 2^32) and column sums during multiplication (< 2^22) stay exact in
uint32 — the TPU VPU has no 64-bit integer path worth using.
"""

import numpy as np

from ..field.primes import LIMB_BITS, FieldSpec

LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """One Python int -> (n_limbs,) uint32 little-endian base-2^16."""
    out = np.empty(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in limb count")
    return out


def ints_to_limbs(xs, n_limbs: int) -> np.ndarray:
    """Iterable of ints -> (N, n_limbs) uint32."""
    xs = list(xs)
    out = np.empty((len(xs), n_limbs), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[j] = int_to_limbs(x, n_limbs)
    return out


def limbs_to_int(arr) -> int:
    """(n_limbs,) array -> Python int."""
    arr = np.asarray(arr, dtype=np.uint64)
    x = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[i])
    return x


def limbs_to_ints(arr):
    """(..., n_limbs) array -> nested lists of Python ints (flattened to 1D)."""
    arr = np.asarray(arr, dtype=np.uint64).reshape(-1, np.asarray(arr).shape[-1])
    return [limbs_to_int(row) for row in arr]


def spec_constants(spec: FieldSpec) -> dict:
    """Precomputed numpy constants for one field (used by the JAX ops)."""
    L = spec.n_limbs
    p = spec.p
    R = 1 << (LIMB_BITS * L)
    return {
        "L": L,
        "p": p,
        "p_limbs": int_to_limbs(p, L),
        "R": R % p,
        "R2_limbs": int_to_limbs((R * R) % p, L),
        "one_mont_limbs": int_to_limbs(R % p, L),
        "n0inv": (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS),
        "mask_limbs": int_to_limbs(spec.mask, L),
        "half_limbs": int_to_limbs(spec.half, L),
    }
