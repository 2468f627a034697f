"""Inputs and outputs of the SHA256 circuit (circuits/sha256.circom).

`Sha256Block` takes one padded 512-bit block as 512 input bits and outputs
the 256 digest bits as witness indices 1..256.  Within each 32-bit word
both are LSB first; the words are big-endian as in FIPS 180-4.  The two
batch encoders are copies of those of the JAX package's benchmark
(bench.py), which the port does not import.
"""

import hashlib

import numpy as np


def msgs_to_bits_batch(msgs):
    """Vectorized msg_to_bits over a batch: (512, B) uint8 in the
    circuit's LSB-first-within-word layout."""
    B = len(msgs)
    blocks = np.zeros((B, 64), np.uint8)
    for j, m in enumerate(msgs):
        blocks[j, :len(m)] = np.frombuffer(m, np.uint8)
        blocks[j, len(m)] = 0x80
        blocks[j, 56:] = np.frombuffer(
            (8 * len(m)).to_bytes(8, "big"), np.uint8)
    words = blocks.reshape(B, 16, 4)
    w32 = (words[..., 0].astype(np.uint32) << 24) \
        | (words[..., 1].astype(np.uint32) << 16) \
        | (words[..., 2].astype(np.uint32) << 8) \
        | words[..., 3].astype(np.uint32)          # (B, 16) big-endian
    k = np.arange(32, dtype=np.uint32)
    bits = (w32[:, :, None] >> k[None, None, :]) & 1   # (B, 16, 32)
    return bits.reshape(B, 512).T.astype(np.uint8)


def digest_bits_batch(msgs):
    """Expected digest bits (256, B) int32, LSB-first per output word."""
    B = len(msgs)
    dig = np.zeros((B, 32), np.uint8)
    for j, m in enumerate(msgs):
        dig[j] = np.frombuffer(hashlib.sha256(m).digest(), np.uint8)
    words = dig.reshape(B, 8, 4)
    w32 = (words[..., 0].astype(np.uint32) << 24) \
        | (words[..., 1].astype(np.uint32) << 16) \
        | (words[..., 2].astype(np.uint32) << 8) \
        | words[..., 3].astype(np.uint32)
    k = np.arange(32, dtype=np.uint32)
    bits = (w32[:, :, None] >> k[None, None, :]) & 1
    return bits.reshape(B, 256).T.astype(np.int32)


def input_rows(msgs, limbs=2):
    """The messages as input rows of `limbs` 16-bit limbs, the bit in limb
    0: uint32 (512, limbs, B).  run_mixed takes rows of 2 (or 1) limbs,
    every input being a bit; run takes full-limb rows, limbs = L of the
    field (16, or 4 at goldilocks)."""
    bits = msgs_to_bits_batch(msgs)
    rows = np.zeros((512, limbs, len(msgs)), np.uint32)
    rows[:, 0, :] = bits
    return rows


def digest_bits_from_witness(narrow, layout):
    """The digest bits (256, B) out of run_mixed's narrow rows: witness
    indices 1..256.  narrow: (n_nw, B) tensor or array; layout:
    mixed_layout()."""
    row_of = {wi: r for r, wi in enumerate(layout[0])}
    rows = [row_of[1 + k] for k in range(256)]
    return narrow[rows]
