"""Plain reference of MerkleInclusion(depth) over circomlib's Poseidon(2).

Works out, in Python integers and from the lanes' inputs alone, every
signal the circuit (witbench/circuits/merkle.circom over poseidon.circom)
defines: each level's Switcher (s, a, b, aux, outL, outR), each
Poseidon(2) (its inputs, every Sigma's in, x2, x4 and out, its output),
the path of hashes (cur) and the root.  The Poseidon constants are
circomlib's, made again here by the Grain LFSR procedure (grain.py), not
read from the circuit; nothing here comes from the program under test.

`signals` gives each signal under its name with the indices taken out
(`main.h[].sigma[].x2`), an array whose leading axes are those indices
and whose last axis is the lane; the harness places them in wire order
by the circuit's symbol table (witbench/wires.py) and holds the witness
to them row by row.

Inputs, in the circuit's declaration order: leaf, pathElements[depth],
pathIndex[depth] (bits, LSB first).
"""

from pathlib import Path

import numpy as np
import torch

from witbench.refs import grain

CIRCUITS = Path(__file__).resolve().parents[1] / "circuits"
T = 3               # Poseidon(2): a state of three
ROUNDS_F = 8        # full rounds, half before and half after the partial
ROUNDS_P = 57       # circomlib's N_ROUNDS_P[t - 2] for t = 3
OUTPUT_KEYS = ("main.root",)


def source(params):
    """The circuit's text: poseidon.circom, merkle.circom and the main
    component, composed as the port's merkle_source(depth) composes it."""
    return ((CIRCUITS / "poseidon.circom").read_text()
            + (CIRCUITS / "merkle.circom").read_text()
            .replace("pragma circom 2.0.0;", "")
            + f"\ncomponent main = MerkleInclusion({params['depth']});\n")


def constants(p):
    """(round constants, MDS rows) of circomlib's Poseidon(2) over p."""
    return grain.poseidon_params(p, T, ROUNDS_F, ROUNDS_P)


def poseidon2(a, b, p, sig=None):
    """Poseidon(2) of (a, b) mod p, elementwise over arrays of Python
    ints (or on two ints).  With `sig`, a dict, each Sigma's in, x2, x4
    and out are appended to its lists under those names."""
    c, mds = constants(p)
    s = [0 * a, a, b]
    for r in range(ROUNDS_F + ROUNDS_P):
        s = [(s[i] + c[r * T + i]) % p for i in range(T)]
        full = r < ROUNDS_F // 2 or r >= ROUNDS_F // 2 + ROUNDS_P
        for i in range(T if full else 1):
            x2 = s[i] * s[i] % p
            x4 = x2 * x2 % p
            x5 = x4 * s[i] % p
            if sig is not None:
                for k, v in (("in", s[i]), ("x2", x2), ("x4", x4),
                             ("out", x5)):
                    sig[k].append(v)
            s[i] = x5
        s = [sum(mds[i][j] * s[j] for j in range(T)) % p for i in range(T)]
    return s[0]


def _lanes(inputs):
    """Per-lane input lists -> an object array (inputs, lanes)."""
    x = np.empty((len(inputs[0]), len(inputs)), dtype=object)
    for j, ins in enumerate(inputs):
        x[:, j] = ins
    return x


def signals(inputs, params, p):
    """{key: array (indices..., lanes)} of every signal of the circuit,
    for the lanes whose inputs are `inputs` (a list of each lane's)."""
    depth = params["depth"]
    x = _lanes(inputs)
    leaf, elems, bits = x[0], x[1:1 + depth], x[1 + depth:1 + 2 * depth]
    cur = [leaf]
    sw = {k: [] for k in ("s", "a", "b", "aux", "outL", "outR")}
    h = {k: [] for k in ("inputs", "out")}
    sig = {k: [] for k in ("in", "x2", "x4", "out")}
    for i in range(depth):
        s, a, b = bits[i], cur[i], elems[i]
        aux = (b - a) * s % p
        left, right = (aux + a) % p, (b - aux) % p
        for k, v in zip(sw, (s, a, b, aux, left, right)):
            sw[k].append(v)
        one = {k: [] for k in sig}
        out = poseidon2(left, right, p, one)
        for k in sig:
            sig[k].append(np.stack(one[k]))
        h["inputs"].append(np.stack([left, right]))
        h["out"].append(out)
        cur.append(out)
    got = {"main.leaf": leaf, "main.pathElements[]": elems,
           "main.pathIndex[]": bits, "main.root": cur[depth],
           "main.cur[]": np.stack(cur)}
    got.update({f"main.sw[].{k}": np.stack(v) for k, v in sw.items()})
    got["main.h[].inputs[]"] = np.stack(h["inputs"])
    got["main.h[].out"] = np.stack(h["out"])
    got.update({f"main.h[].sigma[].{k}": np.stack(v)
                for k, v in sig.items()})
    return got


def outputs(inputs, params, p):
    """Each lane's output rows: [root]."""
    return [[int(v)] for v in signals(inputs, params, p)["main.root"]]


def control(inputs, params, p):
    """The control: the reference with the canonical-form guarantee
    broken, the root left as root + p (a final reduction skipped, as a
    lazy reduction would leave it; it fits the 256 bits of a row)."""
    return [[r + p] for (r,) in outputs(inputs, params, p)]


def make_batch(gen, n_lanes, limbs, params, p, device):
    """One batch of inputs, made on `device` from the generator `gen`:
    uint32 rows (1 + 2 depth, limbs, n_lanes) of 16-bit limbs.  leaf and
    pathElements are field elements below p (every limb random, the top
    limb below p's, so that every value is canonical); pathIndex rows hold
    one random bit in limb 0.  Needs limbs * 16 >= p's bits."""
    depth = params["depth"]
    n = 1 + 2 * depth
    top = p >> (16 * (limbs - 1))
    if top == 0 or top >= 1 << 16:
        raise ValueError(f"{limbs} limbs do not hold p")
    x = torch.randint(0, 1 << 16, (n, limbs, n_lanes), generator=gen,
                      device=device, dtype=torch.int32)
    x[:, limbs - 1] = torch.randint(0, top, (n, n_lanes), generator=gen,
                                    device=device, dtype=torch.int32)
    x[1 + depth:, 1:] = 0
    x[1 + depth:, 0] = torch.randint(0, 2, (depth, n_lanes), generator=gen,
                                     device=device, dtype=torch.int32)
    return x.view(torch.uint32)
