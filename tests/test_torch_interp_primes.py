"""The interpreter at each of the eight fields that `--prime` takes.

Two circuits that the interpreter planner takes, compiled by the port at
bn128, bls12381, goldilocks, grumpkin, pallas, vesta, secq256r1 and
bls12377, run through WitnessProgram.run with the interpreter chosen
(mode="interp"; the plain K1 and the parts route on the CPU), batch 8:

- the stdlib comparators (C's LessThan(64), LessEqThan(64), IsEqual() and
  Num2Bits(64) of a + b), on lanes that put 0, 1, p - 1 and p // 2 on
  both inputs in pairs whose sum and differences the gadgets can hold,
  then random a, b below 2^63;
- MiMC7 (circuits/gen_mimc.py: 91 rounds of x^7, its round constants
  reduced into each field by the compiler), the same edges on x_in and k.

Every lane equals the host calculator and passes the R1CS check (the
plain route).  At every field the JAX package compiles the same source
(its own front end and reduction of constants into the field), and its
host calculator (`witness_host`, no jit) gives every lane's witness too:
so a fault of the port's compiler at a field is not held only against
the port's own calculator.  The JAX package's scan path is held against the port at
batch 4 where its jit takes seconds: at goldilocks on both circuits (1-3
s), and on MiMC at bls12381 and secq256r1 (about 5 s each: the field
nearest 2^256 and a second 255-bit one; tests/test_torch_circuits.py
holds MiMC at bn128).  The comparators take it 11-13 s a 256-bit field
(tests/test_torch_fused.py holds them at bn128).  Comparisons are exact.
"""

import random

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend.interp import TorchInterpreter
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits import gen_mimc
from circom_tpu_torch.circuits.sources import comparators_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import PRIMES, field_spec
from circom_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int

B = 8
JAX_LANES = 4
# (circuit, field) held against the JAX scan path
JAX_CASES = {("comparators", "goldilocks"), ("mimc", "goldilocks"),
             ("mimc", "bls12381"), ("mimc", "secq256r1")}
CIRCUITS = {
    "comparators": (comparators_source(), ("a", "b")),
    "mimc": (gen_mimc.generate() + "\ncomponent main = MiMC7();\n",
             ("x_in", "k")),
}


def columns(name, p):
    """Input columns (2, B) of a circuit: edge pairs of 0, 1, p - 1 and
    p // 2, then random values.  The comparators' pairs keep a + b mod p
    and a - b + 2^64 mod p inside the gadgets' bits (p - 1 with 1, p // 2
    with p // 2 + 1, which sum to 0 mod p); their random a, b lie below
    2^63."""
    rng = random.Random(p % 1000003)
    if name == "comparators":
        pairs = [(0, 0), (1, p - 1), (p - 1, 1), (p // 2, p // 2 + 1),
                 (p // 2 + 1, p // 2), (1, 0)]
        top = min(p, 2 ** 63)
    else:
        pairs = [(0, 0), (1, p - 1), (p - 1, 1), (p // 2, p // 2), (1, 0),
                 (p - 1, p // 2)]
        top = p
    pairs += [(rng.randrange(top), rng.randrange(top))
              for _ in range(B - len(pairs))]
    return [[a for a, _ in pairs], [b for _, b in pairs]]


@pytest.mark.parametrize("prime", list(PRIMES))
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_interpreter_at_every_prime(name, prime):
    src, inputs = CIRCUITS[name]
    spec = field_spec(prime)
    p, L = spec.p, spec.n_limbs
    cc = compile_source(src, prime=prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu",
                          mode="interp", input_ranges=cc.input_range_hints())
    assert isinstance(prog.interp, TorchInterpreter)
    cols = columns(name, p)
    x = np.stack([ints_to_limbs(c, L).T.copy() for c in cols])
    wit = prog.run(x)
    got = wit.view(torch.int32).numpy().view(np.uint32)
    cc_j = jax_compile(src, prime=prime)
    for lane in range(B):
        ins = dict(zip(inputs, (c[lane] for c in cols)))
        host = list(cc.witness_host(ins))
        assert [limbs_to_int(got[i, :, lane]) for i in range(len(host))] \
            == host, f"lane {lane}"
        assert list(cc_j.witness_host(ins)) == host, f"JAX, lane {lane}"
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device="cpu")
    assert bool(checker.check(wit).all())
    if (name, prime) not in JAX_CASES:
        return
    scan = JaxProgram(cc_j.build_tape()[0], jax_field_spec(prime),
                      unroll_threshold=0, mode="scan",
                      input_ranges=cc_j.input_range_hints())
    want = np.asarray(scan.run(x[..., :JAX_LANES].copy()))
    np.testing.assert_array_equal(got[..., :JAX_LANES], want)
