"""SHA256 over bn128 through the port on the CPU.

The port compiles circuits/sha256.circom, plans it with the inputs'
range hints (every input is a bit, so the whole plan is narrow) and runs
it on the plain versions of kernels K1b and K3.  The digests must equal
hashlib's, the witness rows the host calculator's (`cc.witness_host`, about
4 s a lane, so one lane is checked), and the R1CS checker must pass the
full-limb witness and fail a corrupted bit row at the same first
constraint as the JAX package's checker.  Every comparison is exact.
"""

import random

import jax
import numpy as np
import pytest
import torch

from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.limbs import limbs_to_int
import test_torch_shared as shared

SPEC = field_spec("bn128")


@pytest.fixture(scope="module")
def sha256():
    """The compiled circuit, its program, 4 random 32-byte messages and
    the host witness of the first."""
    cc, _tape, prog = shared.program(shared.sha256_source())
    rng = random.Random(2024)
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(4)]
    bits = sha256_io.msgs_to_bits_batch(msgs)
    host = list(cc.witness_host({"in": [int(b) for b in bits[:, 0]]}))
    return cc, prog, msgs, host


def test_plan_is_narrow(sha256):
    _cc, prog, _msgs, _host = sha256
    plan = prog.interp.plan
    assert plan.n_regs == 1 and len(plan.win_order) == 0
    assert len(plan.nin_order) == 512 and plan.K == 0 and plan.KN == 256
    assert prog.plan.opset_w == [] and len(prog.plan.opset_n) == 13
    n_idx, w_idx = prog.mixed_layout()
    assert w_idx == [] and n_idx == list(range(prog.n_witness))


def test_run_mixed_digests_and_host_rows(sha256):
    cc, prog, msgs, host = sha256
    narrow, wide = prog.run_mixed(sha256_io.input_rows(msgs))
    assert narrow.dtype == torch.int32
    assert narrow.shape == (prog.n_witness, 4) and wide.shape == (0, 16, 4)
    digest = sha256_io.digest_bits_from_witness(narrow, prog.mixed_layout())
    np.testing.assert_array_equal(digest.numpy(),
                                  sha256_io.digest_bits_batch(msgs))
    n_idx, _ = prog.mixed_layout()
    lane0 = narrow[:, 0].tolist()
    assert [lane0[r] % SPEC.p for r in range(len(n_idx))] == \
        [host[w] for w in n_idx]


@pytest.fixture(scope="module")
def full_limb(sha256):
    """The full-limb witness of the first two messages, and a checker."""
    cc, prog, msgs, _host = sha256
    z = prog.run(sha256_io.input_rows(msgs[:2], SPEC.n_limbs))
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], SPEC,
                          device="cpu")
    return z, checker


def test_run_rows_equal_host_and_pass_the_check(sha256, full_limb):
    _cc, prog, _msgs, host = sha256
    z, checker = full_limb
    assert z.shape == (prog.n_witness, SPEC.n_limbs, 2)
    zz = z.view(torch.int32).numpy().view(np.uint32)
    assert [limbs_to_int(zz[i, :, 0]) for i in range(len(host))] == host
    assert checker.lanes == 260    # the slice rule at 80,458 nonzeros
    ok, first_bad = checker.check_detailed(z)
    assert ok.tolist() == [True, True] and first_bad.tolist() == [0, 0]


def test_corrupted_bit_row_fails_like_jax(sha256, full_limb):
    cc, _prog, _msgs, _host = sha256
    z, checker = full_limb
    bad = z.view(torch.int32).numpy().copy()
    bad[300, 0, 1] ^= 1                      # a bit row of lane 1
    ok_t, fb_t = checker.check_detailed(
        torch.from_numpy(bad).view(torch.uint32))
    ok_j, fb_j = jax.jit(JaxChecker(cc.r1cs_rows(), cc.counts()["n_wires"],
                                    jax_field_spec("bn128"))
                         .check_detailed)(bad.view(np.uint32))
    assert ok_t.tolist() == [True, False]
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_j))
