"""The plain references against fixed vectors, on the CPU.

Poseidon(2)'s vectors are circomlib's: Poseidon([1, 2]) as circomlibjs's
tests hold it, and Poseidon([0, 0]), the first zero hash of the Merkle
trees built on it.  The SHA-256 ones are hashlib's.  Every signal the
references work out is held, row by row in wire order through the
compiler's symbol table, to the port's host calculator (`witness_host`)
on the same inputs: the references cover every row of the witness, and a
swapped or altered row shows.
"""

import hashlib
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from witbench import wires
from witbench.refs import PRIMES, grain, merkle, sha256

ROOT = Path(__file__).resolve().parents[2]
P = PRIMES["bn128"]


def frozen(fn):
    text = (ROOT / "witbench" / "circuits" / "poseidon.circom").read_text()
    m = re.search(r"function %s\([^)]*\)\s*\{\s*var \w+\[(\d+)\] = \[([^\]]*)\]"
                  % fn, text)
    vals = [int(v) for v in m.group(2).split(",")]
    assert len(vals) == int(m.group(1))
    return vals


def test_poseidon_constants_are_circomlibs_grain_ones():
    c, mds = merkle.constants(P)
    assert len(c) == 3 * (8 + 57)
    # circomlib's poseidon_constants: C[t=3][0] and M[t=3][0][0]
    assert c[0] == 0x0ee9a592ba9a9518d05986d656f40c2114c4993c11bb29938d21d47304cd8e6e
    assert mds[0][0] == 0x109b7f411ba0e4c9b2b70caf5c36a7b194be7c11ad24378bfedb68592ba8118b
    # the frozen circuit computes with the same numbers
    assert frozen("POS_C3") == list(c)
    assert frozen("POS_M3") == [x for row in mds for x in row]
    assert "var nRoundsP = 57;" in merkle.source({"depth": 1})


@pytest.mark.parametrize("a,b,want", [
    (1, 2, 0x115cc0f5e7d690413df64c6b9662e9cf2a3617f2743245519e19607a4417189a),
    (0, 0, 14744269619966411208579211824598458697587494354926760081771325075741142829156),
])
def test_poseidon2_circomlib_vectors(a, b, want):
    assert merkle.poseidon2(a, b, P) == want


def test_grain_depends_on_every_parameter():
    base = grain.poseidon_params(P, 3, 8, 57)
    for args in ((P, 3, 8, 56), (P, 3, 6, 57), (P, 4, 8, 57)):
        assert grain.poseidon_params(*args)[0][:3] != base[0][:3]


@pytest.fixture(scope="module")
def mk2():
    from circom_tpu_torch.compiler.pipeline import compile_source

    cc = compile_source(merkle.source({"depth": 2}))
    return cc, wires.wire_names(cc.sym_lines(), cc.counts()["n_wires"])


MK_LANES = [[5, 7, 11, 1, 0], [0, P - 1, 3, 0, 1], [P - 2, 1, 2, 1, 1]]


def host_rows(cc, lanes, named):
    cols = [cc.witness_host(named(x)) for x in lanes]
    return np.array(cols, dtype=object).T


def test_merkle_every_row_is_the_host_calculators(mk2):
    cc, names = mk2
    params = {"depth": 2}
    want = wires.expected_rows(merkle.signals(MK_LANES, params, P), names,
                               len(MK_LANES))
    have = host_rows(cc, MK_LANES, lambda x: {
        "leaf": x[0], "pathElements": x[1:3], "pathIndex": x[3:5]})
    assert want.shape == have.shape == (len(names), 3)
    assert (want == have).all()
    assert [r[0] for r in merkle.outputs(MK_LANES, params, P)] == \
        list(want[wires.rows_of(merkle.OUTPUT_KEYS, names)[0]])
    # two internal rows swapped: both wrong in every lane
    i, j = len(names) // 3, 2 * len(names) // 3
    have[[i, j]] = have[[j, i]]
    assert int(np.not_equal(want, have).astype(bool).sum()) == 6


def test_merkle_control_is_root_plus_p():
    params = {"depth": 2}
    roots = merkle.outputs(MK_LANES, params, P)
    assert merkle.control(MK_LANES, params, P) == [[r + P] for (r,) in roots]


def msg_bits(msg):
    return [(int.from_bytes(msg[4 * j:4 * j + 4], "big") >> i) & 1
            for j in range(16) for i in range(32)]


def digest_bits(msg):
    d = hashlib.sha256(msg).digest()
    return [(int.from_bytes(d[4 * j:4 * j + 4], "big") >> i) & 1
            for j in range(8) for i in range(32)]


def test_sha256_plain_digest_is_hashlib():
    rng = random.Random(5)
    for _ in range(8):
        msg = bytes(rng.randrange(256) for _ in range(64))
        words = sha256.digest(msg)
        assert b"".join(w.to_bytes(4, "big") for w in words) == \
            hashlib.sha256(msg).digest()
        assert sha256.message_of(msg_bits(msg)) == msg
        assert sha256.outputs([msg_bits(msg)], {}, P) == [digest_bits(msg)]


def test_sha256_control_differs():
    msgs = [bytes(range(64)), bytes(64), b"\xff" * 64]
    lanes = [msg_bits(m) for m in msgs]
    ctl = sha256.control(lanes, {}, P)
    assert all(c != w for c, w in zip(ctl, sha256.outputs(lanes, {}, P)))


@pytest.fixture(scope="module")
def sha():
    from circom_tpu_torch.compiler.pipeline import compile_source

    cc = compile_source(sha256.source({}))
    return cc, wires.wire_names(cc.sym_lines(), cc.counts()["n_wires"])


def test_sha256_every_row_is_the_host_calculators(sha):
    cc, names = sha
    msgs = [bytes(range(64)), bytes(random.Random(9).randrange(256)
                                    for _ in range(64))]
    lanes = [msg_bits(m) for m in msgs]
    sig = sha256.signals(lanes, {}, P)
    want = wires.expected_rows(sig, names, 2)
    have = host_rows(cc, lanes, lambda x: {"in": x})
    assert want.shape == have.shape == (54225, 2)
    assert (want == have).all()
    outs = wires.rows_of(sha256.OUTPUT_KEYS, names)
    assert outs == list(range(1, 257))
    assert [list(want[outs, j]) for j in range(2)] == \
        [digest_bits(m) for m in msgs]
    # a round's word of the first block moved a word along: many rows of
    # it wrong, where a search for the word anywhere would find it
    rows = [w for w, n in enumerate(names)
            if n and n.startswith("main.c[0].a[")]
    bad = have.copy()
    bad[rows[:32]], bad[rows[32:64]] = have[rows[32:64]], have[rows[:32]]
    assert int(np.not_equal(want, bad).astype(bool).sum()) > 16


def test_expected_rows_needs_every_signal(mk2):
    _, names = mk2
    sig = merkle.signals(MK_LANES[:1], {"depth": 2}, P)
    del sig["main.sw[].aux"]
    with pytest.raises(KeyError):
        wires.expected_rows(sig, names, 1)


def test_wire_names_refuses_gaps():
    with pytest.raises(ValueError):
        wires.wire_names(["1,1,0,main.a", "2,3,0,main.b"], 4)
    assert wires.wire_names(["1,1,0,main.a", "2,-1,0,main.b",
                             "3,2,0,main.c[4]"], 3) == \
        [None, "main.a", "main.c[4]"]
    assert wires.key_of("main.h[3].sigma[17].x2") == \
        ("main.h[].sigma[].x2", (3, 17))


def test_make_batch_inputs_are_valid():
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    x = merkle.make_batch(gen, 64, 16, {"depth": 3}, P, "cpu")
    v = x.view(torch.int32).numpy()
    assert v.shape == (7, 16, 64) and v.max() < 1 << 16 and v.min() >= 0
    vals = [sum(int(v[r, i, j]) << (16 * i) for i in range(16))
            for r in range(7) for j in range(64)]
    assert max(vals) < P
    assert set(v[4:, 0].ravel()) <= {0, 1} and not v[4:, 1:].any()
    x = sha256.make_batch(gen, 64, 2, {}, P, "cpu")
    v = x.view(torch.int32).numpy()
    assert v.shape == (512, 2, 64) and not v[:, 1].any()
    assert set(v[:, 0].ravel()) == {0, 1}
    msgs = {sha256.message_of(v[:, 0, j].tolist()) for j in range(64)}
    assert len(msgs) == 64 and all(len(m) == 64 for m in msgs)


def test_make_batch_repeats_from_the_seed():
    a = sha256.make_batch(torch.Generator().manual_seed(11), 8, 2, {}, P,
                          "cpu")
    b = sha256.make_batch(torch.Generator().manual_seed(11), 8, 2, {}, P,
                          "cpu")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import witbench.refs.merkle, witbench.refs.sha256, "
            "witbench.wires; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('circom_tpu_torch', 'circom_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
