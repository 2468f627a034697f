"""The port's compile CLI against the JAX package's.

`python -m circom_tpu_torch.cli` must write the same host artifacts as
`circom_tpu.cli` (the compiler is a verbatim copy), its `--witness-gpu
--device cpu` the same .wtns bytes as the JAX CLI's `--witness-tpu`, and
its error paths must be those of tests/test_cli.py.  The JAX CLI on the
CPU runs its scan path (plain jnp); its own R1CS check is left off at
bn128 (a jit of the checker), the port's runs at the default level.
"""

import json
import os
from pathlib import Path

import pytest
import torch

from circom_tpu.cli import main as jax_main
from circom_tpu_torch.cli import main
from circom_tpu_torch.emit.binfmt import read_wtns

ROOT = Path(__file__).resolve().parents[1]

GOOD = """
pragma circom 2.0.0;
template T() {
    signal input in;
    signal output o;
    o <== in * in + 1;
}
component main = T();
"""

# the <-- hint violates the === constraint: every witness must fail the
# sanity check
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

# a bit-constrained input: input_range_hints proves {0, 1}, so the
# narrow int32 lane is used; an out-of-range input must be rejected
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

MIMC = """
pragma circom 2.0.0;
include "mimc.circom";
component main = MiMC7();
"""

MERKLE = """
pragma circom 2.0.0;
include "poseidon.circom";
include "merkle.circom";
component main = MerkleInclusion(2);
"""

# name -> (source, prime, flags, batch of input maps); the name is the
# circuit file's, so it must not be one of the files it includes
CIRCUITS = {
    "good": (GOOD, "goldilocks", ["--O2"],
             [{"in": 3}, {"in": 5}, {"in": "0x1f"}]),
    "mimc7": (MIMC, "bn128", [],
              [{"x_in": 1, "k": 2}, {"x_in": "123456789", "k": 0},
               {"x_in": 0, "k": 0}]),
    "merkle2": (MERKLE, "bn128", ["--O2"],
                [{"leaf": 41, "pathElements": [100, 101],
                  "pathIndex": [1, 0]},
                 {"leaf": 7, "pathElements": [5, 6], "pathIndex": [0, 1]},
                 {"leaf": 0, "pathElements": [0, 0], "pathIndex": [1, 1]},
                 {"leaf": 9, "pathElements": [8, 7], "pathIndex": [0, 0]}]),
}

HOST_FLAGS = ["--r1cs", "--sym", "--json", "--simplification_substitution",
              "--tpu", "--inputs", "--irout"]
HOST_FILES = ["{}.r1cs", "{}.sym", "{}_constraints.json",
              "{}_substitutions.json", "{}.tpu.json", "log_inputs.txt",
              "{}.ir.txt"]


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    return str(p)


def _inputs(tmp_path, rows, name="inputs.json"):
    p = tmp_path / name
    p.write_text(json.dumps(rows))
    return str(p)


def _args(tmp_path, name, package):
    """The circuit file, the prime and the flags of CIRCUITS[name], with
    the include directory of `package`'s circuits."""
    src, prime, flags, _ = CIRCUITS[name]
    circ = _write(tmp_path, f"{name}.circom", src)
    lib = str(ROOT / package / "circuits")
    return [circ, "--prime", prime, "-l", lib, *flags]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_host_artifacts_match_jax_cli(tmp_path, name):
    assert jax_main(_args(tmp_path, name, "circom_tpu")
                    + ["-o", str(tmp_path / "jax"), *HOST_FLAGS]) == 0
    assert main(_args(tmp_path, name, "circom_tpu_torch")
                + ["-o", str(tmp_path / "torch"), *HOST_FLAGS]) == 0
    for f in HOST_FILES:
        ref = (tmp_path / "jax" / f.format(name)).read_bytes()
        assert (tmp_path / "torch" / f.format(name)).read_bytes() == ref, f


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_wtns_match_jax_cli(tmp_path, name):
    batch = CIRCUITS[name][3]
    inp = _inputs(tmp_path, batch)
    check = "2" if CIRCUITS[name][1] == "goldilocks" else "0"
    assert jax_main(_args(tmp_path, name, "circom_tpu")
                    + ["-o", str(tmp_path / "jax"), "--witness-tpu", inp,
                       "--sanity_check", check]) == 0
    # the first name of the flag here, the second (the JAX CLI's) below
    assert main(_args(tmp_path, name, "circom_tpu_torch")
                + ["-o", str(tmp_path / "torch"), "--witness-gpu", inp,
                   "--device", "cpu"]) == 0
    assert main(_args(tmp_path, name, "circom_tpu_torch")
                + ["-o", str(tmp_path / "tpu_flag"), "--witness-tpu", inp,
                   "--device", "cpu", "--sanity_check", "1"]) == 0
    for bi in range(len(batch)):
        ref = (tmp_path / "jax" / f"{name}.{bi}.wtns").read_bytes()
        assert (tmp_path / "torch" / f"{name}.{bi}.wtns").read_bytes() == ref
        assert (tmp_path / "tpu_flag" / f"{name}.{bi}.wtns").read_bytes() \
            == ref


def test_sanity_check_catches_bad_hint(tmp_path, capsys):
    circ = _write(tmp_path, "bad.circom", BAD_HINT)
    inp = _inputs(tmp_path, [{"in": 3}, {"in": 4}])
    rc = main([circ, "--prime", "goldilocks", "-o", str(tmp_path),
               "--witness-gpu", inp, "--sanity_check", "1", "--device",
               "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "T3012" in err and "constraint" in err
    assert "witness 0" in err and "witness 1" in err
    assert not os.path.exists(tmp_path / "bad.0.wtns")


def test_sanity_check_off(tmp_path):
    """--sanity_check 0 skips the checker and writes the witnesses."""
    circ = _write(tmp_path, "bad.circom", BAD_HINT)
    inp = _inputs(tmp_path, [{"in": 3}])
    rc = main([circ, "--prime", "goldilocks", "-o", str(tmp_path),
               "--witness-gpu", inp, "--sanity_check", "0", "--device",
               "cpu"])
    assert rc == 0
    assert read_wtns(str(tmp_path / "bad.0.wtns"))["values"][1] == 4


def test_hinted_input_out_of_range(tmp_path, capsys):
    """Range-hinted inputs are validated host-side unconditionally: with
    --sanity_check 0 a value violating its bit constraint fails (T3015)."""
    circ = _write(tmp_path, "bit.circom", BIT_INPUT)
    inp = _inputs(tmp_path, [{"b": 1}, {"b": 2}])
    rc = main([circ, "--prime", "goldilocks", "-o", str(tmp_path),
               "--witness-gpu", inp, "--sanity_check", "0", "--device",
               "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "T3015" in err and "'b'" in err and "witness 1" in err
    assert not os.path.exists(tmp_path / "bit.0.wtns")


def test_hinted_input_in_range(tmp_path):
    circ = _write(tmp_path, "bit.circom", BIT_INPUT)
    inp = _inputs(tmp_path, [{"b": 1}, {"b": 0}])
    rc = main([circ, "--prime", "goldilocks", "-o", str(tmp_path),
               "--witness-gpu", inp, "--sanity_check", "0", "--device",
               "cpu"])
    assert rc == 0
    assert read_wtns(str(tmp_path / "bit.0.wtns"))["values"][1] == 2
    assert read_wtns(str(tmp_path / "bit.1.wtns"))["values"][1] == 1


def test_missing_input_reports_its_span(tmp_path, capsys):
    """T3011 names the input and points at the main component's call,
    rendered as the JAX CLI renders it."""
    circ = _write(tmp_path, "g.circom", GOOD)
    inp = _inputs(tmp_path, [{"in": 1}, {"x": 2}])
    common = [circ, "--prime", "goldilocks", "-o", str(tmp_path),
              "--witness-tpu", inp]
    assert jax_main(common) == 1
    ref = capsys.readouterr().err
    assert main(common + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "T3011" in err and "missing input 'in'" in err
    assert "component main = T();" in err
    assert err == ref
    assert not os.path.exists(tmp_path / "g.0.wtns")


def test_compat_flags(tmp_path):
    """Reference compat flags (--wat/--inputs/--irout/--no_asm,
    input_user.rs:397-585) are honored, as in the JAX CLI."""
    circ = _write(tmp_path, "g.circom", GOOD)
    rc = main([circ, "--prime", "goldilocks", "-o", str(tmp_path),
               "--wat", "--inputs", "--irout", "--no_asm"])
    assert rc == 0
    assert (tmp_path / "g.tpu.json").exists()
    assert "in dims=[] offset=0" in (tmp_path / "log_inputs.txt").read_text()
    ir = (tmp_path / "g.ir.txt").read_text()
    assert "%0 = input" in ir and "outputs:" in ir


def test_witness_rejects_batch_list(tmp_path, capsys):
    """A multi-entry batch list handed to --witness reports T3010 and
    points at the batched flag; a singleton list is accepted."""
    circ = _write(tmp_path, "t.circom", GOOD)
    bad = _inputs(tmp_path, [{"in": 1}, {"in": 2}])
    code = main([circ, "-o", str(tmp_path / "o1"), "--witness", bad,
                 "--prime", "goldilocks"])
    assert code == 1
    cap = capsys.readouterr()
    assert "batch files go to --witness-tpu" in cap.out + cap.err
    good = _inputs(tmp_path, [{"in": 3}], "one.json")
    code = main([circ, "-o", str(tmp_path / "o2"), "--witness", good,
                 "--prime", "goldilocks"])
    assert code == 0
    assert read_wtns(str(tmp_path / "o2" / "t.wtns"))["values"][1] == 10


def test_default_device_needs_a_card(tmp_path, capsys):
    """--witness-gpu without --device cpu and without a card exits 1 with
    resolve_device's message and writes nothing, not even the output
    directory."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    circ = _write(tmp_path, "g.circom", GOOD)
    inp = _inputs(tmp_path, [{"in": 3}])
    out = tmp_path / "out"
    assert main([circ, "--prime", "goldilocks", "-o", str(out), "--r1cs",
                 "--witness-gpu", inp]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()
