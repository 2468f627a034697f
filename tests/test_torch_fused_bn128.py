"""The fused-backend circuits of test_torch_fused.py at bn128.

Each case's witness from the port's compiler, planner and plain executor
must equal, bit for bit, the JAX WitnessProgram's scan path on the CPU and
the host calculator, and its plan must hold exactly the case's K1c/K1d
opcodes.  (A separate file from the goldilocks cases, so that a run with
one worker a file takes the two halves in parallel: the scan path's XLA
compile at 16 limbs takes about 5 s a circuit.)
"""

import pytest

from test_torch_fused import CASES, check_witness, runs  # noqa: F401


@pytest.mark.parametrize("name", list(CASES))
def test_bn128_witness_matches_jax_scan_and_host(runs, name):  # noqa: F811
    check_witness(runs(name, "bn128"), name, "bn128")
