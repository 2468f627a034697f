"""The MiMC and Merkle circuits on the port, against the JAX package.

MultiMiMC7(2) and MerkleInclusion(4) over bn128 run through the port's
WitnessProgram on the CPU (the plain version of K1 and the gathers): the
full-limb witness must equal the JAX package's scan path (plain jnp), the
host calculator and the port's native calculator, bit for bit; Merkle's
mixed witness must equal the host calculator; a pathIndex of 2 must be
rejected (T3015).  The utilities of this slice (utils/cache.py,
utils/profiling.py) are held to the JAX modules' rules and output.
"""

import json
import random

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.utils import profiling as jax_profiling
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import merkle_source, mimc_source
from circom_tpu_torch.cli import main as cli_main
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.native import NativeCalculator
from circom_tpu_torch.ops.limbs import limbs_to_int
from circom_tpu_torch.utils import cache, profiling

BATCH = 4
SOURCES = {"mimc2": mimc_source(2), "merkle4": merkle_source(4)}


def _columns(cc, layout, seed):
    """Random input columns [input][batch]: field elements, and bits for
    the range-hinted inputs (Merkle's pathIndex)."""
    rng = random.Random(seed)
    hints = cc.input_range_hints()
    n = sum(int(np.prod(dims)) for (_n, dims, _o) in layout)
    return [[rng.randrange(2) if i in hints else rng.randrange(cc.p)
             for _ in range(BATCH)] for i in range(n)]


def _input_map(layout, cols, lane):
    out = {}
    for (name, dims, off) in layout:
        n = int(np.prod(dims))
        vals = [cols[off + k][lane] for k in range(n)]
        out[name] = vals if dims else vals[0]
    return out


@pytest.fixture(scope="module", params=list(SOURCES))
def circuit(request):
    src = SOURCES[request.param]
    cc = compile_source(src)
    tape, layout = cc.build_tape()
    prog = WitnessProgram(tape, field_spec("bn128"), device="cpu",
                          input_ranges=cc.input_range_hints())
    cols = _columns(cc, layout, seed=len(request.param))
    return request.param, cc, tape, layout, prog, cols


def to_np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def test_witness_matches_jax_scan_host_and_native(circuit):
    name, cc, tape, layout, prog, cols = circuit
    assert prog.interp is not None, "planned for the interpreter"
    got = to_np(prog.run(prog.encode_inputs(cols)))
    ref_cc = jax_compile(SOURCES[name])
    ref_tape, _ = ref_cc.build_tape()
    jp = JaxProgram(ref_tape, jax_field_spec("bn128"), unroll_threshold=0,
                    mode="scan", input_ranges=ref_cc.input_range_hints())
    want = np.asarray(jp.run(jp.encode_inputs(cols)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    native = NativeCalculator(tape, field_spec("bn128"),
                              input_ranges=cc.input_range_hints())
    rows = native.run([[c[lane] for c in cols] for lane in range(BATCH)])
    for lane in range(BATCH):
        host = list(cc.witness_host(_input_map(layout, cols, lane)))
        assert [limbs_to_int(got[i, :, lane])
                for i in range(got.shape[0])] == host
        assert rows[lane][:len(host)] == host


def test_merkle_plan_runs_k1a_and_k1b():
    """MerkleInclusion(4)'s plan holds wide and narrow opcodes, so K1 runs
    K1a and K1b in one launch; its pathIndex inputs are narrow witness
    rows that the plan copies into the narrow bank (`ncopy`, wit_src
    "emitn"), so `run` gathers them through K3."""
    cc = compile_source(merkle_source(4))
    tape, layout = cc.build_tape()
    prog = WitnessProgram(tape, field_spec("bn128"), device="cpu",
                          input_ranges=cc.input_range_hints())
    plan = prog.interp.plan
    assert {"interp_k1a", "interp_k1b"} <= set(plan.parts)
    # witness rows: the constant 1, root, leaf, pathElements[4], then
    # pathIndex[4] (input offset 5, after the root)
    assert ("pathIndex", (4,), 5) in layout
    assert sorted(prog.mixed_layout()[0]) == [7, 8, 9, 10]
    assert (plan.nw_src < plan.n_bank_n_rows).all()
    assert (plan.nw_shift == -1).all()


def test_merkle_mixed_witness_matches_host():
    """run_mixed on Merkle: narrow rows (the pathIndex inputs among them)
    and wide rows at mixed_layout's indices equal the host calculator."""
    cc = compile_source(merkle_source(4))
    tape, layout = cc.build_tape()
    prog = WitnessProgram(tape, field_spec("bn128"), device="cpu",
                          input_ranges=cc.input_range_hints())
    cols = _columns(cc, layout, seed=3)
    narrow, wide = prog.run_mixed(prog.encode_inputs(cols))
    n_idx, w_idx = prog.mixed_layout()
    assert len(n_idx) >= 4
    wide = to_np(wide)
    for lane in range(BATCH):
        host = list(cc.witness_host(_input_map(layout, cols, lane)))
        assert [int(narrow[r, lane]) % cc.p for r in range(len(n_idx))] \
            == [host[i] for i in n_idx]
        assert [limbs_to_int(wide[r, :, lane]) for r in range(len(w_idx))] \
            == [host[i] for i in w_idx]


def test_merkle_mixed_split_matches_the_reference():
    """The port's narrow witness rows and shifts are the JAX planner's.
    The reference appends no shift for a narrow input witness row
    (interp.py:2346-2352); Merkle has none, as its pathIndex rows are
    emitted by the plan, so both splits agree here."""
    src = merkle_source(4)
    ref_cc = jax_compile(src)
    jp = JaxProgram(ref_cc.build_tape()[0], jax_field_spec("bn128"),
                    unroll_threshold=0, mode="interp",
                    input_ranges=ref_cc.input_range_hints()).fused
    (ref_src, ref_shift, ref_wd), ref_layout = jp._mixed_split()
    cc = compile_source(src)
    prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", input_ranges=cc.input_range_hints())
    plan = prog.interp.plan
    assert prog.mixed_layout() == ref_layout
    assert plan.nw_src.tolist() == list(ref_src)
    assert plan.nw_shift.tolist() == list(ref_shift)
    assert plan.wd_src.tolist() == list(ref_wd)


def test_path_index_of_two_is_rejected(tmp_path, capsys):
    circ = tmp_path / "inclusion.circom"
    circ.write_text(merkle_source(2))
    inp = tmp_path / "inputs.json"
    inp.write_text(json.dumps([
        {"leaf": 1, "pathElements": [2, 3], "pathIndex": [0, 1]},
        {"leaf": 1, "pathElements": [2, 3], "pathIndex": [0, 2]}]))
    rc = cli_main([str(circ), "-o", str(tmp_path), "--witness-gpu",
                   str(inp), "--device", "cpu", "--sanity_check", "0"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "T3015" in err and "pathIndex[1]" in err and "witness 1" in err
    assert not (tmp_path / "inclusion.0.wtns").exists()


def test_build_dir_falls_back(tmp_path, capsys):
    """An unwritable default (a path under a regular file) falls back to
    the per-user directory, and that to a fresh temporary one, each with
    one line on stderr."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    good = tmp_path / "user"
    assert cache.choose_dir(tmp_path / "build", good) == tmp_path / "build"
    assert capsys.readouterr().err == ""
    assert cache.choose_dir(blocker / "build", good) == good
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "NotADirectoryError" in err[0]
    chosen = cache.choose_dir(blocker / "build", blocker / "user")
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and "temporary" in err[1]
    assert chosen.is_dir() and chosen.name.startswith(
        "circom_tpu_torch_build_")
    chosen.rmdir()


def test_statistics_match_jax_module(tmp_path):
    """circuit_statistics and write_statistics give the JAX module's
    output on the same compiled circuit."""
    cc = compile_source(merkle_source(4))
    assert profiling.circuit_statistics(cc) == \
        jax_profiling.circuit_statistics(cc)
    profiling.write_statistics(cc, tmp_path / "port.json")
    jax_profiling.write_statistics(cc, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_device_trace_writes_a_trace(tmp_path):
    x = torch.arange(16)
    with profiling.device_trace(str(tmp_path / "trace")):
        (x * x).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
