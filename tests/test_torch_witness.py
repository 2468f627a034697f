"""The port's witness entry point against the JAX package's.

`python -m circom_tpu_torch.witness --device cpu` must write the same
.wtns bytes as `python -m circom_tpu.witness` on the same artifact; the
sanity checker must fail a violated hint (T3012); and without --device cpu
and without a card it must refuse to run.
"""

import json

import pytest
import torch

from circom_tpu.backend.artifacts import save_program
from circom_tpu.circuits.gen_poseidon import generate
from circom_tpu.compiler.pipeline import compile_source
from circom_tpu.witness import main as jax_witness
from circom_tpu_torch.witness import main as torch_witness

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


# a bit-constrained input: its range hint puts it on the narrow int32
# lane (kernel K1b on the card)
BIT_INPUT = """
pragma circom 2.0.0;
template T() {
    signal input b;
    signal output o;
    b * (b - 1) === 0;
    o <== b + 1;
}
component main = T();
"""


def _artifact(tmp_path, src, name):
    path = tmp_path / f"{name}.tpu.json"
    save_program(compile_source(src), str(path))
    return str(path)


def _inputs(tmp_path, rows):
    p = tmp_path / "inputs.json"
    p.write_text(json.dumps(rows))
    return str(p)


def test_wtns_bytes_match_jax_entry_point(tmp_path):
    art = _artifact(tmp_path, generate((2,)) + "\ncomponent main = "
                    "Poseidon2();\n", "pos")
    inp = _inputs(tmp_path, [{"inputs": [123, 456]},
                             {"inputs": ["789", "0x1f2e"]}])
    # the reference run skips its own R1CS check (its CPU compile takes
    # ~15 s); the port's run checks every witness at the default level
    assert jax_witness([art, inp, "-o", str(tmp_path / "jax"),
                        "--sanity_check", "0"]) == 0
    assert torch_witness([art, inp, "-o", str(tmp_path / "torch"),
                          "--device", "cpu"]) == 0
    for bi in range(2):
        ref = (tmp_path / "jax" / f"pos.{bi}.wtns").read_bytes()
        got = (tmp_path / "torch" / f"pos.{bi}.wtns").read_bytes()
        assert got == ref


def test_sanity_check_catches_bad_hint(tmp_path, capsys):
    art = _artifact(tmp_path, BAD_HINT, "bad")
    inp = _inputs(tmp_path, [{"in": 3}, {"in": 5}])
    assert torch_witness([art, inp, "-o", str(tmp_path), "--device",
                          "cpu"]) == 1
    err = capsys.readouterr().err
    assert "T3012" in err and "witness 0" in err and "witness 1" in err
    assert not (tmp_path / "bad.0.wtns").exists()
    # level 0 skips the check and writes the (unchecked) witnesses
    assert torch_witness([art, inp, "-o", str(tmp_path), "--device", "cpu",
                          "--sanity_check", "0"]) == 0
    assert (tmp_path / "bad.1.wtns").exists()


def test_default_device_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    art = _artifact(tmp_path, BAD_HINT, "bad")
    inp = _inputs(tmp_path, [{"in": 3}])
    assert torch_witness([art, inp, "-o", str(tmp_path)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "bad.0.wtns").exists()


def test_input_errors_are_reported(tmp_path, capsys):
    """Inputs are checked before the program is built: a missing input
    (T3011) and a value outside its range hint (T3015) fail loudly."""
    art = _artifact(tmp_path, BIT_INPUT, "bit")
    assert torch_witness([art, _inputs(tmp_path, [{"x": 1}]), "-o",
                          str(tmp_path), "--device", "cpu"]) == 1
    assert "T3011" in capsys.readouterr().err
    assert torch_witness([art, _inputs(tmp_path, [{"b": 1}, {"b": 2}]),
                          "-o", str(tmp_path), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "T3015" in err and "witness 1" in err
    assert not (tmp_path / "bit.0.wtns").exists()


def test_bit_input_tape_matches_jax_entry_point(tmp_path):
    """A narrow-lane tape (range-hinted input, narrow witness rows) runs
    through the port's entry point, R1CS check included, and writes the
    reference's .wtns bytes."""
    art = _artifact(tmp_path, BIT_INPUT, "bit")
    inp = _inputs(tmp_path, [{"b": 1}, {"b": 0}])
    assert jax_witness([art, inp, "-o", str(tmp_path / "jax")]) == 0
    assert torch_witness([art, inp, "-o", str(tmp_path / "torch"),
                          "--device", "cpu"]) == 0
    for bi in range(2):
        ref = (tmp_path / "jax" / f"bit.{bi}.wtns").read_bytes()
        got = (tmp_path / "torch" / f"bit.{bi}.wtns").read_bytes()
        assert got == ref
