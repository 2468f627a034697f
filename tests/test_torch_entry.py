"""The port's entry points (circom_tpu_torch/entry.py) against the
JAX package's root __graft_entry__.py, on the CPU.

entry(device="cpu") gives the flagship's run and its inputs (Poseidon2/
bn128, batch 64, from random.Random(7)): every lane equals the host
calculator, and lanes 0-3 equal the JAX package's WitnessProgram
(unroll_threshold=0) on the same inputs, limb for limb.
dryrun_multichip(8, device="cpu") runs its three phases over eight CPU
shards.  Without a card, the default device raises.
"""

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.circuits.sources import poseidon2_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.entry import dryrun_multichip, entry
from circom_tpu_torch.ops.limbs import limbs_to_int


def to_np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def test_entry_matches_host_and_jax():
    run, (inputs,) = entry(device="cpu")
    assert inputs.device.type == "cpu" and tuple(inputs.shape) == (2, 16, 64)
    out = to_np(run(inputs))
    x = to_np(inputs)
    cc = compile_source(poseidon2_source())
    for j in range(64):
        ins = [limbs_to_int(x[i, :, j]) for i in range(2)]
        assert [limbs_to_int(out[i, :, j]) for i in range(out.shape[0])] \
            == list(cc.witness_host({"inputs": ins}))
    jcc = jax_compile(poseidon2_source())
    jprog = JaxProgram(jcc.build_tape()[0], jax_field_spec("bn128"),
                       unroll_threshold=0)
    want = np.asarray(jprog.jittable()(x[..., :4]))
    assert np.array_equal(out[..., :4], want)


def test_dryrun_multichip_on_eight_cpu_shards(capsys):
    dryrun_multichip(8, device="cpu")
    assert capsys.readouterr().out == ""   # no repeated card to report


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
