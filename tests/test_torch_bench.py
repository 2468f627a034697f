"""bench_gpu.py, the port's benchmark, against bench.py and the JAX package.

bench.py is read with ast, never imported (importing it would set up JAX
for the TPU): its seeds, batches, CPU baseline rows and record keys.  On
the CPU each workload runs at a tiny batch through the kernels' plain
versions; its gate must hold, its witness must equal the JAX
WitnessProgram's (unroll_threshold=0, the scan path: the plain jnp
reference of the Pallas kernels), and nothing may be written under a
device key.  The CPU baseline runs at a few rows.  Without a card the
program exits 1 and prints no record; --rehearse exits 3 and prints none.
"""

import ast
import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_gpu
from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch import native
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.utils.roofline import k1_ops
import test_torch_shared as shared

ROOT = Path(__file__).resolve().parents[1]
BENCH_PY = ROOT / "bench.py"
TINY = dataclasses.replace(bench_gpu.REHEARSE, poseidon2=4, sha256=2,
                           poseidon2_gl=4, bigint_div=4)
# bench.py's functions and the workloads of bench_gpu.py they map to
FUNCTIONS = {"bench_poseidon": "poseidon2", "bench_sha256": "sha256",
             "bench_poseidon_goldilocks": "poseidon2_gl",
             "bench_bigint_div": "bigint_div"}
DROPPED = {"tpu_fallback_cpu", "canary_ms", "relay_rtt_ms", "device_state"}


def _tree():
    return ast.parse(BENCH_PY.read_text())


def _snippet_tree():
    """The CPU baseline snippet of bench.py, parsed."""
    for n in _tree().body:
        if isinstance(n, ast.Assign) and getattr(
                n.targets[0], "id", "") == "_CPU_BASELINE_SNIPPET":
            return ast.parse(ast.literal_eval(n.value))
    raise AssertionError("bench.py has no _CPU_BASELINE_SNIPPET")


def _random_seeds(node):
    return [c.args[0].value for c in ast.walk(node)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == "Random"]


def _calls(node, name):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and getattr(c.func, "id", None) == name]


def _batch(fn):
    """The batch a bench.py function runs on the TPU: `batch = N` or the
    TPU branch of `batches = (N,) ...`."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and getattr(
                n.targets[0], "id", "") in ("batch", "batches"):
            v = n.value.body if isinstance(n.value, ast.IfExp) else n.value
            return [c.value for c in ast.walk(v)
                    if isinstance(c, ast.Constant)][0]
    raise AssertionError(f"no batch in {fn.name}")


def test_seeds_and_batches_are_bench_py_s():
    fns = {n.name: n for n in _tree().body if isinstance(n, ast.FunctionDef)}
    seeds = {w: _random_seeds(fns[f]) for f, w in FUNCTIONS.items()}
    seeds["cpu_baseline"] = _random_seeds(_snippet_tree())
    assert seeds == {w: [s] for w, s in bench_gpu.SEEDS.items()}
    for f, w in FUNCTIONS.items():
        assert getattr(bench_gpu.FULL, w) == _batch(fns[f]), w
    snippet = _snippet_tree()
    rows = [c.args[0].value for c in _calls(snippet, "range")
            if isinstance(c.args[0], ast.Constant)]
    reps = [c.args[2].value for c in _calls(snippet, "measure")]
    assert tuple(rows) == bench_gpu.FULL.cpu_rows
    # Poseidon2 at 1 thread and all cores, goldilocks, SHA256 at both
    assert reps == [bench_gpu.FULL.cpu_reps[k] for k in (0, 0, 1, 2, 2)]


def test_draws_equal_bench_py_s():
    """Each workload's inputs and the CPU baseline's rows, drawn in
    bench.py's loop order from its seeds."""
    bn, gl = field_spec("bn128").p, field_spec("goldilocks").p
    B = 5
    for name, p in (("poseidon2", bn), ("poseidon2_gl", gl)):
        rng = random.Random(bench_gpu.SEEDS[name])
        cols = [[rng.randrange(p) for _ in range(B)] for _ in range(2)]
        assert bench_gpu.field_columns(bench_gpu.SEEDS[name], p, 2, B) \
            == cols
    rng = random.Random(99)
    assert bench_gpu.sha256_messages(B) == [
        bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    rng = random.Random(5)
    assert bench_gpu.bigint_div_columns(bn, B) == [
        [rng.randrange(bn) for _ in range(B)],
        [rng.randrange(1, bn) for _ in range(B)]]
    rng = random.Random(1)
    want = [[[rng.randrange(bn) for _ in range(2)] for _ in range(6)],
            [[rng.randrange(gl) for _ in range(2)] for _ in range(6)],
            [[rng.randrange(2) for _ in range(512)] for _ in range(3)]]
    sizes = dataclasses.replace(TINY, cpu_rows=(6, 6, 3))
    assert bench_gpu.cpu_baseline_rows((2, 2, 512), sizes) == want


def _bench_py_record_keys():
    """Every key bench.py writes into its record: the extras' and the
    result's stores and the keys of emit's result dict."""
    keys = set()
    for n in ast.walk(_tree()):
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store) \
                and getattr(n.value, "id", "") in ("extras", "result"):
            keys.add(n.slice.value)
        if isinstance(n, ast.Assign) and getattr(
                n.targets[0], "id", "") == "result" \
                and isinstance(n.value, ast.Dict):
            keys.update(k.value for k in n.value.keys)
    return keys


def test_record_keys_are_bench_py_s_mapped():
    ref = _bench_py_record_keys()
    assert DROPPED <= ref and "poseidon2_vpu_util" in ref
    mapped = {k.replace("_tpu_", "_gpu_").replace("_vpu_", "_int_")
              for k in ref - DROPPED}
    assert set(bench_gpu.record({}, {}, "card", partial=True)) == mapped
    final = bench_gpu.record({}, {}, "card", partial=False)
    assert set(final) == mapped - {"partial"} == set(bench_gpu.RECORD_KEYS)
    rec = bench_gpu.record(
        {"poseidon2_gpu_wit_s": 100.0, "sha256_gpu_wit_s": 30.0,
         "poseidon2_gl_gpu_wit_s": 50.0},
        {"poseidon2_cpu_1t": 4.0, "poseidon2_cpu_mt": 20.0,
         "sha256_cpu_1t": 3.0, "poseidon2_gl_cpu_1t": 5.0}, "card", False)
    assert (rec["value"], rec["vs_baseline"], rec["vs_baseline_allcore"],
            rec["sha256_vs_baseline"], rec["sha256_vs_baseline_allcore"],
            rec["poseidon2_gl_vs_baseline"]) == (100.0, 25.0, 5.0, 10.0,
                                                 None, 10.0)


@pytest.fixture(scope="module")
def bench():
    """One CPU bench at tiny batches, its circuits compiled once; SHA256's
    compile is the run's (test_torch_shared), planned as bench_gpu plans
    it."""
    source, prime, mode = bench_gpu.CIRCUITS["sha256"]
    cc, _tape, prog = shared.program(source(), prime, mode=mode,
                                     unroll_threshold=0)
    return bench_gpu.Bench("cpu", TINY, compiled={"sha256": (cc, prog)})


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def _jax_witness(name, x):
    """The JAX WitnessProgram's witness (unroll_threshold=0, the scan path)
    on the same circuit and inputs, as numpy."""
    source, prime, _mode = bench_gpu.CIRCUITS[name]
    tape, _ = jax_compile(source(), prime=prime).build_tape()
    jp = JaxProgram(tape, jax_field_spec(prime), unroll_threshold=0,
                    mode="scan")
    return np.asarray(jp.run(x))


def _columns(name, prog, B):
    if name == "bigint_div":
        return bench_gpu.bigint_div_columns(prog.spec.p, B)
    return bench_gpu.field_columns(bench_gpu.SEEDS[name], prog.spec.p,
                                   prog.n_inputs, B)


@pytest.mark.parametrize("name", ["poseidon2", "poseidon2_gl", "bigint_div"])
def test_workload_gate_and_witness_match_jax(bench, name):
    getattr(bench, name)()
    assert bench.gates[name] == "lane 0 equals the host calculator"
    assert bench.extras == {}      # no CPU number under a device key
    _cc, prog = bench.compiled[name]
    B = getattr(TINY, name)
    x = prog.encode_inputs(_columns(name, prog, B))
    np.testing.assert_array_equal(_u32(prog.run(x)), _jax_witness(name, x))


def test_sha256_workload_digests(bench):
    bench.sha256()
    assert bench.gates["sha256"] == "all 2 digests equal hashlib's"
    assert bench.extras == {}


def test_lane0_gate_refuses_a_wrong_witness():
    out = torch.zeros((3, 4, 2), dtype=torch.int32).view(torch.uint32)
    bench_gpu.lane0_gate("ok", out, np.zeros((3, 4), np.uint32))
    with pytest.raises(bench_gpu.GateError):
        bench_gpu.lane0_gate("bad", out, np.ones((3, 4), np.uint32))
    with pytest.raises(bench_gpu.GateError):
        bench_gpu.lane0_gate("short", out, np.zeros((2, 4), np.uint32))


def test_k1_ops_pinned(bench):
    """utils/roofline.k1_ops on the bench's four plans: the values
    chip_smoke.py's own copy gave before the count moved there."""
    want = {"poseidon2": 198464, "sha256": 11675, "poseidon2_gl": 7960,
            "bigint_div": 9312}
    for name, ops in want.items():
        _cc, prog = bench.program(name)
        assert k1_ops(prog.interp.plan, prog.spec.p.bit_length()) == ops


def test_cpu_baseline_at_a_few_rows(bench, tmp_path):
    bench.baseline_cache = tmp_path / "cpu_baseline.json"
    assert not bench.load_cached_baseline()
    bench.cpu_baseline()
    rates = ("poseidon2_cpu_1t", "poseidon2_cpu_mt", "poseidon2_gl_cpu_1t",
             "sha256_cpu_1t", "sha256_cpu_mt")
    assert all(bench.cpu[k] > 0 for k in rates)
    assert bench.cpu["cpu_cores"] == len(os.sched_getaffinity(0))
    assert bench.cpu["from_cache"] is False
    again = bench_gpu.Bench("cpu", TINY)
    again.baseline_cache = bench.baseline_cache
    assert again.load_cached_baseline()
    assert again.cpu == dict(bench.cpu, from_cache=True)


def test_cpu_baseline_cache_key(monkeypatch, tmp_path):
    """The key changes with the CPU model, tapeval.cpp's bytes, the thread
    count and the sizes; a cache file with another key is not read."""
    key = bench_gpu.cpu_baseline_key(TINY)
    assert bench_gpu.cpu_baseline_key(TINY) == key
    assert bench_gpu.cpu_baseline_key(bench_gpu.FULL) != key
    with monkeypatch.context() as m:
        m.setattr(native, "cpu_model", lambda: "another CPU")
        assert bench_gpu.cpu_baseline_key(TINY) != key
    with monkeypatch.context() as m:
        src = tmp_path / "tapeval.cpp"
        src.write_bytes(native.SRC.read_bytes() + b"\n")
        m.setattr(native, "SRC", src)
        assert bench_gpu.cpu_baseline_key(TINY) != key
    with monkeypatch.context() as m:
        m.setattr(bench_gpu, "cpu_cores", lambda: 1000)
        assert bench_gpu.cpu_baseline_key(TINY) != key
    path = tmp_path / "cache.json"
    bench_gpu.write_cpu_baseline_cache("0" * 16, path,
                                       {"poseidon2_cpu_1t": 1.0})
    assert bench_gpu.read_cpu_baseline_cache(key, path) is None
    assert bench_gpu.read_cpu_baseline_cache("0" * 16, path) == {
        "poseidon2_cpu_1t": 1.0}
    path.write_text("not json")
    assert bench_gpu.read_cpu_baseline_cache(key, path) is None


def test_failed_workload_prints_partial_record(monkeypatch, capsys):
    """A workload that misses its gate: the partial record printed last,
    no later workload run, exit code 1."""
    b = bench_gpu.Bench("cpu", TINY)
    ran = []
    monkeypatch.setattr(b, "load_cached_baseline", lambda: True)
    monkeypatch.setattr(b, "poseidon2", lambda: b.extras.update(
        poseidon2_gpu_wit_s=5.0))

    def miss():
        raise bench_gpu.GateError("sha256: 1 of 2 digests differ")

    monkeypatch.setattr(b, "sha256", miss)
    monkeypatch.setattr(b, "poseidon2_gl", lambda: ran.append("gl"))
    rc = bench_gpu.run(b, lambda partial: bench_gpu.print_record(b, partial))
    out = capsys.readouterr()
    records = [json.loads(line) for line in out.out.splitlines()]
    assert rc == 1 and not ran
    assert len(records) == 2 and all(r["partial"] for r in records)
    assert records[-1]["value"] == 5.0
    assert "GateError" in out.err


def _records(stdout):
    """The lines of stdout that are JSON objects."""
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_without_a_card_exits_1_without_a_record():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "bench_gpu.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "no CUDA device" in r.stderr
    assert _records(r.stdout) == []


def test_rehearsal_exits_3_without_a_record():
    r = subprocess.run([sys.executable, "bench_gpu.py", "--rehearse"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3, r.stderr[-3000:]
    assert "every gate held" in r.stderr
    assert _records(r.stdout) == []
