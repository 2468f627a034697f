"""MerkleInclusion(2) through the interpreter at each of the eight
fields that `--prime` takes.

circuits/sources.merkle_source(2): a Poseidon2 hash a level (its lazy
dots dot2_c and dot3_c, which subtract p up to three times at secq256r1)
and a Switcher on each path bit, so its plan runs K1a-K1d in one plan and
its witness is KW's assembly.  Through WitnessProgram(..., device="cpu",
mode="interp"), batch 8: leaf and path elements 0, 1, p - 1 and p // 2,
then random; every pair of path bits.  Every lane equals the port's host
calculator and the JAX package's (`compile_source(...).witness_host`, its
own compile at the field) and passes the R1CS check.  The helpers and the
dot rows' worst case are tests/test_torch_dot_primes.py's.

Comparisons are exact: field elements are integers.
"""

import random

import pytest

from circom_tpu_torch.field.primes import PRIMES
from test_torch_dot_primes import B, check_lanes, compiled


def merkle2_columns(prime, p):
    """The input columns of B lanes: leaf, pathElements[2] (0, 1, p - 1
    and p // 2, then random), pathIndex[2] (every pair of bits)."""
    rng = random.Random(PRIMES[prime] % 1000003 + 1)
    edge = [0, 1, p - 1, p // 2]
    cols = [edge + [rng.randrange(p) for _ in range(B - 4)]
            for _ in range(3)]
    cols[1] = cols[1][1:] + cols[1][:1]
    return cols + [[lane >> k & 1 for lane in range(B)] for k in range(2)]


@pytest.mark.parametrize("prime", list(PRIMES))
def test_merkle2_at_every_prime(prime):
    cc, prog, cc_j = compiled("merkle2", prime)
    assert set(prog.interp.plan.parts) == {
        "interp_k1a", "interp_k1b", "interp_k1c", "interp_k1d"}
    cols = merkle2_columns(prime, prog.spec.p)
    check_lanes(cc, cc_j, prog, cols, lambda v: {
        "leaf": v[0], "pathElements": v[1:3], "pathIndex": v[3:5]})
