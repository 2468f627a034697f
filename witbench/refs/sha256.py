"""Plain reference of circomlib's Sha256(512) (Sha256Msg512): SHA-256 of a
64-byte message, padded into two blocks as FIPS 180-4 pads it.

A lane's input is the message's 512 bits.  The reference reads the
message back out of them and hashes it with `hashlib`; beside that it
runs both compressions itself, in NumPy over the lanes, to know every
signal the circuit (witbench/circuits/sha256.circom) defines: the
message schedule's words and its SmallSigma, Xor3W and AddModW signals,
every round's working words and its BigSigma, ChW, MajW and AddModW
signals, and the final additions.  The plain compression must give
hashlib's digest.

`signals` gives each signal under its name with the indices taken out
(`main.c[].t1a[].bits[]`), an array whose leading axes are those indices
and whose last axis is the lane; the harness places them in wire order
by the circuit's symbol table (witbench/wires.py) and holds the witness
to them row by row.

Bit layout: in[32 j + i] is bit i of the message's big-endian word j;
out[32 j + i] bit i of digest word j; a word's signals LSB first.
"""

import hashlib
from pathlib import Path

import numpy as np
import torch

CIRCUITS = Path(__file__).resolve().parents[1] / "circuits"
MASK = 0xFFFFFFFF
K = (0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
     0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
     0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
     0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
     0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
     0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
     0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
     0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
     0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
     0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
     0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c,
      0x1f83d9ab, 0x5be0cd19)
MSG_BYTES = 64
OUTPUT_KEYS = ("main.out[]",)


def source(params):
    """The circuit's text: sha256.circom with Sha256Msg512 as main."""
    return (CIRCUITS / "sha256.circom").read_text() \
        + "\ncomponent main = Sha256Msg512();\n"


def padded(msg):
    """The two blocks FIPS 180-4 makes of a 64-byte message."""
    return msg + b"\x80" + bytes(55) + (8 * len(msg)).to_bytes(8, "big")


def message_of(inputs):
    """The 64-byte message of a lane's 512 input bits."""
    words = [sum(int(inputs[32 * j + i]) << i for i in range(32))
             for j in range(16)]
    return b"".join(w.to_bytes(4, "big") for w in words)


def rotr(x, n):
    return (x >> n | x << (32 - n)) & MASK


def compress(state, block, add=lambda *xs: sum(xs) & MASK):
    """One compression of a 64-byte block from `state` (eight words):
    the next state.  `add` sums words mod 2^32."""
    w = [int.from_bytes(block[4 * t:4 * t + 4], "big") for t in range(16)]
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ w[t - 15] >> 3
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ w[t - 2] >> 10
        w.append(add(w[t - 16], s0, w[t - 7], s1))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = e & f ^ ~e & g & MASK
        t1 = add(h, s1, ch, K[t], w[t])
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = a & b ^ a & c ^ b & c
        h, g, f, e, d, c, b, a = g, f, e, add(d, t1), c, b, a, add(t1, s0,
                                                                   maj)
    return [add(x, y) for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def digest(msg, add=lambda *xs: sum(xs) & MASK):
    """SHA-256 of `msg` by the plain compressions, as eight words."""
    blocks = padded(msg)
    state = list(IV)
    for k in range(0, len(blocks), 64):
        state = compress(state, blocks[k:k + 64], add)
    return state


def bits_of(words):
    """Words -> their bits, each word LSB first."""
    return [(x >> i) & 1 for x in words for i in range(32)]


# -- every signal of the circuit, over the lanes --------------------------

KBITS = np.array([[(k >> i) & 1 for i in range(32)] for k in K], np.uint8)
IDX = np.arange(32)


def _word(bits):
    """(32, lanes) bits -> (lanes,) uint64 words."""
    return (bits.astype(np.uint64) << IDX.astype(np.uint64)[:, None]).sum(0)


def _bits(words, n=32):
    """(lanes,) words -> (n, lanes) bits, LSB first."""
    return ((words[None, :] >> np.arange(n, dtype=np.uint64)[:, None])
            & 1).astype(np.uint8)


def _xor3(sig, name, src, r1, r2, r3, shift=False):
    """SmallSigma / BigSigma over the bits `src`: its Xor3W's a, b, c
    (c = src shifted right by r3 when `shift`, else rotated), mid, out."""
    a, b = src[(IDX + r1) % 32], src[(IDX + r2) % 32]
    if shift:
        c = np.where((IDX + r3 < 32)[:, None], src[np.minimum(IDX + r3, 31)],
                     0).astype(np.uint8)
    else:
        c = src[(IDX + r3) % 32]
    out = a ^ b ^ c
    for k, v in (("in[]", src), ("out[]", out), ("x.a[]", a), ("x.b[]", b),
                 ("x.c[]", c), ("x.mid[]", b & c), ("x.out[]", out)):
        sig[f"{name}[].{k}"].append(v)
    return out


def _add(sig, name, words, nbits):
    """AddModW(n, nbits) of the (n, 32, lanes) bit words: its words,
    bits and out."""
    lc = sum(_word(w) for w in words)
    bits = _bits(lc, nbits)
    for k, v in (("words[][]", words), ("bits[]", bits), ("out[]", bits[:32])):
        sig[f"{name}[].{k}"].append(v)
    return bits[:32]


def _compress(hin, msg):
    """Every signal of Sha256Compress on the (256, lanes) state bits `hin`
    and the (512, lanes) block bits `msg`: {key: array}."""
    sig = {}
    for name, keys in (("s0", "in out x.a x.b x.c x.mid x.out"),
                       ("s1", "in out x.a x.b x.c x.mid x.out"),
                       ("bs0", "in out x.a x.b x.c x.mid x.out"),
                       ("bs1", "in out x.a x.b x.c x.mid x.out"),
                       ("wadd", "words[] bits out"),
                       ("t1a", "words[] bits out"),
                       ("t2a", "words[] bits out"),
                       ("fin", "words[] bits out"),
                       ("ch", "e f g out"), ("mj", "a b c mid out")):
        for k in keys.split():
            sig[f"{name}[].{k}[]"] = []
    w = [msg[32 * t:32 * t + 32] for t in range(16)]
    for t in range(16, 64):
        s0 = _xor3(sig, "s0", w[t - 15], 7, 18, 3, shift=True)
        s1 = _xor3(sig, "s1", w[t - 2], 17, 19, 10, shift=True)
        w.append(_add(sig, "wadd", np.stack([s1, w[t - 7], s0, w[t - 16]]),
                      34))
    st = [[hin[32 * j:32 * j + 32]] for j in range(8)]   # a..h, by round
    for t in range(64):
        a, b, c, d, e, f, g, h = (x[t] for x in st)
        S1 = _xor3(sig, "bs1", e, 6, 11, 25)
        ch = np.where(e == 1, f, g).astype(np.uint8)
        for k, v in (("e[]", e), ("f[]", f), ("g[]", g), ("out[]", ch)):
            sig[f"ch[].{k}"].append(v)
        S0 = _xor3(sig, "bs0", a, 2, 13, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        for k, v in (("a[]", a), ("b[]", b), ("c[]", c), ("mid[]", b & c),
                     ("out[]", maj)):
            sig[f"mj[].{k}"].append(v)
        kb = np.broadcast_to(KBITS[t][:, None], e.shape)
        e1 = _add(sig, "t1a", np.stack([d, h, S1, ch, kb, w[t]]), 35)
        a1 = _add(sig, "t2a", np.stack([h, S1, ch, kb, w[t], S0, maj]), 35)
        for x, v in zip(st, (a1, a, b, c, e1, e, f, g)):
            x.append(v)
    out = [_add(sig, "fin", np.stack([x[64], hin[32 * j:32 * j + 32]]), 33)
           for j, x in enumerate(st)]
    got = {k: np.stack(v) for k, v in sig.items()}
    got.update({f"{n}[][]": np.stack(x) for n, x in zip("abcdefgh", st)})
    got["w[][]"] = np.stack(w)
    got.update({"hin[]": hin, "in[]": msg, "out[]": np.concatenate(out)})
    return got


def signals(inputs, params, p):
    """{key: array (indices..., lanes)} of every signal of the circuit,
    for the lanes whose inputs are `inputs` (a list of each lane's), and
    each lane's digest from hashlib, which the circuit's outputs must
    equal (and the plain compressions too)."""
    msg = np.array(inputs, dtype=np.uint8).T          # (512, lanes)
    lanes = msg.shape[1]
    iv = np.array(bits_of(IV), np.uint8)[:, None].repeat(lanes, 1)
    pad = np.array(bits_of([int.from_bytes(padded(bytes(64))[64 + 4 * j:
                                                            68 + 4 * j],
                                           "big") for j in range(16)]),
                   np.uint8)[:, None].repeat(lanes, 1)
    first = _compress(iv, msg)
    second = _compress(first["out[]"], pad)
    got = {f"main.c[].{k}": np.stack([first[k], second[k]]) for k in first}
    want = np.array([bits_of([int.from_bytes(d[4 * j:4 * j + 4], "big")
                              for j in range(8)])
                     for d in (hashlib.sha256(message_of(x)).digest()
                               for x in inputs)], np.uint8).T
    if not np.array_equal(second["out[]"], want):
        raise AssertionError("the plain compressions differ from hashlib")
    got.update({"main.in[]": msg, "main.out[]": want})
    return got


def outputs(inputs, params, p):
    """Each lane's output rows: the digest's bits, from hashlib."""
    return [bits_of([int.from_bytes(d[4 * j:4 * j + 4], "big")
                     for j in range(8)])
            for d in (hashlib.sha256(message_of(x)).digest()
                      for x in inputs)]


def control(inputs, params, p):
    """The control: both compressions with every word sum taken mod
    2^31, one bit narrower than FIPS 180-4's 32-bit words."""
    return [bits_of(digest(message_of(x),
                           add=lambda *xs: sum(xs) & (MASK >> 1)))
            for x in inputs]


def make_batch(gen, n_lanes, limbs, params, p, device):
    """One batch of inputs, made on `device` from the generator `gen`:
    uint32 rows (512, limbs, n_lanes), each lane's 64 random message
    bytes as bits in limb 0 (bit i of big-endian word j in row 32 j + i)."""
    msg = torch.randint(0, 256, (MSG_BYTES, n_lanes), generator=gen,
                        device=device)
    # bit i of big-endian word j: byte 4 j + 3 - i // 8, bit i % 8
    i = torch.arange(32, device=device)
    byte = (4 * torch.arange(16, device=device)[:, None] + 3 - i // 8)
    bits = (msg[byte.reshape(-1)] >> (i % 8).repeat(16)[:, None]) & 1
    x = torch.zeros((512, limbs, n_lanes), dtype=torch.int32, device=device)
    x[:, 0] = bits.to(torch.int32)
    return x.view(torch.uint32)
