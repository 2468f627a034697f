"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card.  The file
imports neither JAX nor circom_tpu, so it runs on the card's machine, where
JAX is not installed, with the JAX-forcing conftest left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Comparisons are exact (tolerance 0): field elements are integers.
"""

import numpy as np
import pytest
import torch

from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend.interp import gather_w, interp_k1a
from circom_tpu_torch.backend.interp_ref import gather_rows, run_plan
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import to_device
from circom_tpu_torch.field.primes import LIMB_BITS, field_spec
from circom_tpu_torch.ops import field_kernels as fk
from circom_tpu_torch.ops.field import TorchField, as_i64
from circom_tpu_torch.ops.limbs import limbs_to_int

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def canonical(rng, prime, shape):
    spec = field_spec(prime)
    L = spec.n_limbs
    top = spec.p >> (LIMB_BITS * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return x


@pytest.fixture(scope="module")
def poseidon2():
    return compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")


@pytest.mark.parametrize("prime", ["bn128", "goldilocks", "bls12381"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_field_kernels_match_plain(card, prime, op):
    rng = np.random.default_rng(5)
    L = field_spec(prime).n_limbs
    tf = TorchField(field_spec(prime), card)
    a = to_device(canonical(rng, prime, (7, L, 1000)), card)
    b = to_device(canonical(rng, prime, (7, L, 1000)), card)
    c = to_device(canonical(rng, prime, (7, L, 1)), card)
    for y in (b, c):          # full and broadcast second operand
        got = getattr(fk, op)(tf, a, y)
        want = getattr(tf, op)(a, y)
        torch.cuda.synchronize()
        assert torch.equal(as_i64(got), as_i64(want))


def test_k1a_and_k2_match_plain(card, poseidon2):
    prog = WitnessProgram(poseidon2.build_tape()[0], field_spec("bn128"),
                          device=card)
    plan = prog.interp.plan
    rng = np.random.default_rng(12)
    x_w = to_device(canonical(rng, "bn128",
                              (len(plan.win_order), plan.L, 4096)), card)
    got = interp_k1a(plan, prog.field, x_w)
    want = run_plan(plan, prog.field, as_i64(x_w))
    rows = torch.as_tensor(plan.written_rows(), device=card)
    assert torch.equal(as_i64(got)[rows], want[rows])
    idx = plan.dev["wit_rows"]
    assert torch.equal(as_i64(gather_w(got, idx)),
                       as_i64(gather_rows(got, idx)))


def test_witness_program_and_checker(card, poseidon2):
    spec = field_spec("bn128")
    prog = WitnessProgram(poseidon2.build_tape()[0], spec, device=card)
    rng = np.random.default_rng(13)
    x = canonical(rng, "bn128", (prog.n_inputs, spec.n_limbs, 300))
    wit = prog.run(x)
    checker = R1CSChecker(poseidon2.r1cs_rows(),
                          poseidon2.counts()["n_wires"], spec, device=card,
                          lanes=128)
    ok, first_bad = checker.check_detailed(wit)
    assert bool(ok.all())
    bad = wit.clone()
    bad.view(torch.int32)[40, 0, 7] ^= 1
    ok_bad, _ = checker.check_detailed(bad)
    assert ok_bad.cpu().tolist() == [b != 7 for b in range(300)]
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 150, 299):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        host = list(poseidon2.witness_host({"inputs": ins}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] == host
