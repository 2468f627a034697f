"""The port's R1CS checker against the JAX package's.

Verdicts and first-bad constraint indices must equal those of
circom_tpu.backend.checker.R1CSChecker.check_detailed (on the CPU), on good
Poseidon2 witnesses and on witnesses with one corrupted wire.
"""

import jax
import numpy as np
import pytest
import torch

from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend import checker as checker_mod
from circom_tpu_torch.backend.checker import SLICE_BUDGET_BYTES, R1CSChecker
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec

BAD_HINT = """
pragma circom 2.0.0;
template T() {
    signal input in;
    signal output o;
    o <-- in + 1;
    o * 1 === in + 2;
}
component main = T();
"""


def witnesses(src, prime, batch, seed):
    cc = compile_source(src, prime=prime)
    spec = field_spec(prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu")
    rng = np.random.default_rng(seed)
    cols = [[int.from_bytes(rng.bytes(32), "little") % spec.p
             for _ in range(batch)] for _ in range(prog.n_inputs)]
    wit = prog.run(prog.encode_inputs(cols))
    return cc, wit.view(torch.int32).numpy().view(np.uint32).copy()


def both_verdicts(cc, prime, z, lanes=8192):
    rows, n_wires = cc.r1cs_rows(), cc.counts()["n_wires"]
    ok_j, fb_j = jax.jit(JaxChecker(rows, n_wires,
                                    jax_field_spec(prime)).check_detailed)(z)
    port = R1CSChecker(rows, n_wires, field_spec(prime), device="cpu",
                       lanes=lanes)
    ok_t, fb_t = port.check_detailed(torch.from_numpy(z.view(np.int32))
                                     .view(torch.uint32))
    return (np.asarray(ok_j), np.asarray(fb_j)), (ok_t.numpy(), fb_t.numpy())


def test_poseidon2_good_and_corrupted_lanes():
    cc, z = witnesses(generate((2,)) + "\ncomponent main = Poseidon2();\n",
                      "bn128", 6, seed=21)
    # lanes 0-1 good; lanes 2-5 each with one wire's low limb flipped
    for lane, wire in zip(range(2, 6), (3, 40, 150, 322)):
        z[wire, 0, lane] ^= 1
    (ok_j, fb_j), (ok_t, fb_t) = both_verdicts(cc, "bn128", z, lanes=4)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(fb_t, fb_j)
    assert ok_t.tolist() == [True, True, False, False, False, False]


@pytest.mark.parametrize("prime", ["bn128", "goldilocks"])
def test_violated_hint_is_caught(prime):
    """A <-- hint that breaks its === constraint fails every lane."""
    cc = compile_source(BAD_HINT, prime=prime)
    spec = field_spec(prime)
    # witness [1, o, in] with o = in + 1 (what the hint computes)
    ins = np.random.default_rng(3).integers(0, 1 << 30, size=4)
    z = np.zeros((3, spec.n_limbs, 4), np.uint32)
    z[0, 0] = 1
    for b, v in enumerate(ins.tolist()):
        for w, val in ((1, v + 1), (2, v)):
            z[w, 0, b], z[w, 1, b] = val & 0xFFFF, val >> 16
    (ok_j, fb_j), (ok_t, fb_t) = both_verdicts(cc, prime, z)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(fb_t, fb_j)
    assert not ok_t.any()


def test_check_witness_list():
    cc = compile_source(BAD_HINT)
    port = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"],
                       field_spec("bn128"), device="cpu")
    assert port.check_witness_list([[1, 6, 5], [1, 7, 5]]).tolist() == \
        [False, True]


@pytest.fixture(scope="module")
def corrupted_poseidon2():
    """Four Poseidon2 witnesses, lanes 1 and 3 corrupted, and the JAX
    checker's verdict on them."""
    cc, z = witnesses(generate((2,)) + "\ncomponent main = Poseidon2();\n",
                      "bn128", 4, seed=22)
    z[7, 0, 1] ^= 1
    z[200, 3, 3] ^= 1
    ok_j, fb_j = jax.jit(JaxChecker(cc.r1cs_rows(), cc.counts()["n_wires"],
                                    jax_field_spec("bn128"))
                         .check_detailed)(z)
    return cc, z, np.asarray(ok_j), np.asarray(fb_j)


@pytest.mark.parametrize("budget, want_lanes", [(SLICE_BUDGET_BYTES, 8192),
                                                (1, 1)])
def test_slice_from_budget_keeps_verdicts(monkeypatch, corrupted_poseidon2,
                                          budget, want_lanes):
    """Poseidon2 (2,345 nonzeros in C) keeps its 8,192-lane slices under
    the default budget; a budget too small for one lane checks lane by
    lane.  The verdicts and first-bad indices stay the reference's."""
    monkeypatch.setattr(checker_mod, "SLICE_BUDGET_BYTES", budget)
    cc, z, ok_j, fb_j = corrupted_poseidon2
    port = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"],
                       field_spec("bn128"), device="cpu")
    assert port.lanes == want_lanes
    ok_t, fb_t = port.check_detailed(torch.from_numpy(z.view(np.int32))
                                     .view(torch.uint32))
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(fb_t.numpy(), fb_j)
    assert ok_t.tolist() == [True, False, True, False]


def test_slice_rule_at_sha256_nnz():
    """SHA256's C matrix has 80,458 nonzeros: its slice is the most lanes
    whose gather, product and int64 copy fit the budget (260)."""
    nnz, L = 80458, 16
    rows = [({0: 1}, {0: 1}, {w: 1 for w in range(1, nnz + 1)})]
    port = R1CSChecker(rows, nnz + 1, field_spec("bn128"), device="cpu")
    assert port.lanes == 260
    assert port.lanes * nnz * L * 16 <= SLICE_BUDGET_BYTES \
        < (port.lanes + 1) * nnz * L * 16
