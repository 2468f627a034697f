"""The mixed path away from bn128, on the CPU: WitnessProgram.run_mixed
(kernels K1, K3, and K2 or KW's wide rows, here their plain versions)
against the JAX package.

SHA256 at goldilocks, batch 4 (every input a bit, so the whole plan is
narrow and K1b alone computes): the port's plan equals the JAX planner's;
run_mixed's digests equal hashlib's from input rows of 2, 1 and 4 limbs,
and lane 0's narrow rows the host witness mod p; the full-limb run's
witness equals the narrow rows widened (ops/narrow.widen_narrow) and
passes the port's R1CS checker and the JAX package's; a corrupted bit row
fails both at the same first constraint.

MerkleInclusion(2) at each of the eight `--prime` fields, batch 8 (wide
inputs, and the pathIndex bits narrow): the mixed layout equals the JAX
package's, and the wide rows and the narrow rows widened equal the JAX
scan path's witness (WitnessProgram(..., unroll_threshold=0,
mode="scan"), plain jnp) in that layout; at goldilocks both parts also
equal the JAX interpreter's run_mixed in Pallas interpret mode.

Every comparison is exact (tolerance 0): field elements are integers.
"""

import random

import jax
import numpy as np
import pytest
import torch

from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.circuits.sources import merkle_source
from circom_tpu_torch.field.primes import PRIMES
from circom_tpu_torch.ops.limbs import limbs_to_int
from circom_tpu_torch.ops.narrow import widen_narrow
from test_torch_copies import PLAN_KEYS, _same
from test_torch_dot_primes import limb_rows
from test_torch_merkle_primes import merkle2_columns
import test_torch_shared as shared

GL = "goldilocks"
SHA_B = 4


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def jax_program(cc_tape, prime, mode):
    cc, tape = cc_tape
    return JaxProgram(tape, jax_field_spec(prime), unroll_threshold=0,
                      mode=mode, input_ranges=cc.input_range_hints())


# -- SHA256 at goldilocks -----------------------------------------------------

@pytest.fixture(scope="module")
def sha256():
    """The port's SHA256 at goldilocks (compile and program, once a run),
    SHA_B random 32-byte messages, the host witness of the first and
    run_mixed's output from 2-limb rows."""
    cc, _tape, prog = shared.program(shared.sha256_source(), GL)
    rng = random.Random(4021)
    msgs = [bytes(rng.randrange(256) for _ in range(32))
            for _ in range(SHA_B)]
    bits = sha256_io.msgs_to_bits_batch(msgs)
    host = list(cc.witness_host({"in": [int(b) for b in bits[:, 0]]}))
    return cc, prog, msgs, host, prog.run_mixed(sha256_io.input_rows(msgs))


@pytest.fixture(scope="module")
def sha256_full(sha256):
    """The full-limb witness of the messages, the port's checker and the
    JAX package's (jitted once)."""
    cc, prog, msgs, _host, _mixed = sha256
    z = prog.run(sha256_io.input_rows(msgs, prog.spec.n_limbs))
    rows, n_wires = cc.r1cs_rows(), cc.counts()["n_wires"]
    checker = R1CSChecker(rows, n_wires, prog.spec, device="cpu")
    jax_check = jax.jit(JaxChecker(rows, n_wires, jax_field_spec(GL))
                        .check_detailed)
    return z, checker, jax_check


def test_sha256_plan_matches_jax_planner(sha256):
    """The plan arrays, as tests/test_torch_copies.py holds them at
    bn128, and the mixed layout: the whole plan narrow at goldilocks
    too."""
    _cc, prog, _msgs, _host, _mixed = sha256
    jp = jax_program(shared.circuit(shared.sha256_source("circom_tpu"), GL,
                                    package="jax"), GL, "interp").fused
    arrays = prog.plan.plan_arrays()
    assert set(arrays) == set(PLAN_KEYS)
    for key in PLAN_KEYS:
        assert _same(arrays[key], getattr(jp, key)), key
    assert prog.plan.mixed_layout() == jp.mixed_layout()
    n_idx, w_idx = prog.mixed_layout()
    assert w_idx == [] and n_idx == list(range(prog.n_witness))
    assert prog.interp.plan.L == 4 and not prog.interp.plan.win_order


def test_sha256_run_mixed_digests_and_host_rows(sha256):
    cc, prog, msgs, host, (narrow, wide) = sha256
    assert narrow.dtype == torch.int32
    assert narrow.shape == (prog.n_witness, SHA_B)
    assert wide.shape == (0, 4, SHA_B)
    layout = prog.mixed_layout()
    np.testing.assert_array_equal(
        sha256_io.digest_bits_from_witness(narrow, layout).numpy(),
        sha256_io.digest_bits_batch(msgs))
    lane0 = narrow[:, 0].tolist()
    assert [v % cc.p for v in lane0] == [host[w] for w in layout[0]]
    # the narrow inputs read from rows of 1 limb and of all 4
    for limbs in (1, 4):
        n, w = prog.run_mixed(sha256_io.input_rows(msgs, limbs))
        assert torch.equal(n, narrow) and w.shape == wide.shape


def test_sha256_run_is_run_mixed_widened_and_passes_both_checkers(
        sha256, sha256_full):
    _cc, prog, _msgs, host, (narrow, _wide) = sha256
    z, checker, jax_check = sha256_full
    assert z.shape == (prog.n_witness, 4, SHA_B)
    n_idx, _ = prog.mixed_layout()
    np.testing.assert_array_equal(
        u32(widen_narrow(narrow, prog.spec.p, 4)), u32(z)[n_idx])
    zz = u32(z)
    assert [limbs_to_int(zz[i, :, 0]) for i in range(len(host))] == host
    ok, first = checker.check_detailed(z)
    assert ok.tolist() == [True] * SHA_B and first.tolist() == [0] * SHA_B
    ok_j, first_j = jax_check(zz)
    assert np.asarray(ok_j).tolist() == [True] * SHA_B
    assert np.asarray(first_j).tolist() == [0] * SHA_B


def test_sha256_corrupted_bit_row_fails_like_jax(sha256_full):
    z, checker, jax_check = sha256_full
    bad = z.view(torch.int32).numpy().copy()
    bad[300, 0, 1] ^= 1                      # a bit row of lane 1
    ok_t, fb_t = checker.check_detailed(
        torch.from_numpy(bad).view(torch.uint32))
    ok_j, fb_j = jax_check(bad.view(np.uint32))
    assert ok_t.tolist() == [True, False, True, True]
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_j))


# -- MerkleInclusion(2) at every field ----------------------------------------

def merkle2(prime):
    """(port program, JAX compile and tape, input rows (n_inputs, L, 8))
    of MerkleInclusion(2) at a field, the lanes of
    test_torch_merkle_primes."""
    src = merkle_source(2)
    _cc, _tape, prog = shared.program(src, prime, mode="interp")
    cols = merkle2_columns(prime, prog.spec.p)
    return (prog, shared.circuit(src, prime, package="jax"),
            limb_rows(cols, prog.spec.n_limbs))


@pytest.mark.parametrize("prime", list(PRIMES))
def test_merkle2_run_mixed_matches_jax_scan(prime):
    prog, jax_cc, x = merkle2(prime)
    interp = prog.interp
    assert interp.plan.win_order and interp.plan.nin_order
    n_idx, w_idx = prog.mixed_layout()
    assert n_idx and w_idx
    assert (n_idx, w_idx) == tuple(
        jax_program(jax_cc, prime, "interp").fused.mixed_layout())
    narrow, wide = prog.run_mixed(x)
    want = np.asarray(jax_program(jax_cc, prime, "scan").run(x))
    assert want.shape[1:] == x.shape[1:]
    np.testing.assert_array_equal(u32(wide), want[w_idx])
    np.testing.assert_array_equal(
        u32(widen_narrow(narrow, prog.spec.p, prog.spec.n_limbs)),
        want[n_idx])


def test_merkle2_run_mixed_matches_jax_interpret_at_goldilocks():
    """The JAX interpreter's run_mixed, eagerly in Pallas interpret mode
    (as tests/test_torch_narrow.py runs it), on the same rows."""
    prog, jax_cc, x = merkle2(GL)
    want_n, want_w = (np.asarray(a) for a in
                      jax_program(jax_cc, GL, "interp").fused._run_mixed(x))
    narrow, wide = prog.run_mixed(x)
    np.testing.assert_array_equal(narrow.numpy(), want_n)
    np.testing.assert_array_equal(u32(wide), want_w)
