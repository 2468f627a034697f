"""The metric arithmetic on a synthetic trace and synthetic batches, and
the check for JAX by whole top-level module names."""

import statistics
from types import SimpleNamespace

import pytest

from witbench import guard, manifest, stats
from witbench.trace import Trace, union


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def synthetic():
    """A window [0, 100] us: batch 1 launches k1 and kw (run) and kc
    (check); batch 2 launches k1 only; card 1 runs one kernel that
    overlaps card 0's; a kernel starts before the window."""
    e = [ev("user_annotation", "wb.window", 0, 100),
         ev("user_annotation", "wb.run", 1, 4),
         ev("user_annotation", "wb.check", 6, 2),
         ev("user_annotation", "wb.sync", 8, 40),
         ev("user_annotation", "wb.run", 50, 5)]
    for corr, t in ((1, 2), (2, 3), (3, 7), (4, 51), (5, 52), (6, -20)):
        e.append(ev("cuda_runtime", "cudaLaunchKernel", t, 0.5,
                    correlation=corr))
    e += [ev("kernel", "k1", 5, 20, device=0, correlation=1),
          ev("kernel", "kw", 25, 10, device=0, correlation=2),
          ev("kernel", "kc", 35, 10, device=0, correlation=3),
          ev("kernel", "k1", 60, 20, device=0, correlation=4),
          ev("kernel", "k1", 70, 20, device=1, correlation=5),
          ev("kernel", "early", -10, 15, device=0, correlation=6)]
    return Trace(e)


def test_union_merges_and_clips():
    assert union([(5, 10), (0, 3), (2, 6), (20, 30)], 1, 25) == \
        [[1, 10], [20, 25]]


def test_busy_is_the_union_not_the_sum():
    t = synthetic()
    assert t.window_s == pytest.approx(100e-6)
    busy = t.busy_s()
    # card 0: [0, 5) of "early", [5, 45) and [60, 80): 65 us
    assert busy[0] == pytest.approx(65e-6)
    assert busy[1] == pytest.approx(20e-6)


def test_layer_spans_follow_the_launching_span():
    t = synthetic()
    assert t.layer_spans_ms("wb.run") == pytest.approx([0.030, 0.030])
    assert t.layer_spans_ms("wb.check") == pytest.approx([0.010])


def test_ops_by_name_and_idle_gaps():
    t = synthetic()
    ops = dict(t.ops_by_name())
    assert ops["k1"] == pytest.approx(60e-6)
    assert ops["early"] == pytest.approx(5e-6)
    gaps = dict(t.idle_gaps())
    # card 0 idle [45, 60) inside wb.sync (8-48) at 52.5? no: wb.run
    # (50-55) holds 52.5; [80, 100) between spans
    assert gaps["cuda:0 wb.run"] == pytest.approx(15e-6)
    assert gaps["cuda:0 between spans"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(200e-6 - 85e-6)


def test_readers_on_the_synthetic_trace():
    t = synthetic()
    ctx = SimpleNamespace(trace=t, chips=2, n_batches=3, lanes=10,
                          window_s=2.0, latencies_s=[0.1] * 19 + [1.0],
                          setup_s=4.5, peak=3 * 2 ** 30)
    read = {n: manifest.reader(n).read for n in
            ("idle_share", "mesh_overlap", "run_ms", "check_ms", "wit_s",
             "batch_p95_ms", "setup_s", "peak_gib")}
    assert read["idle_share"](ctx) == pytest.approx(100 * (1 - 42.5 / 100))
    assert read["mesh_overlap"](ctx) == pytest.approx(0.85)
    assert read["run_ms"](ctx) == pytest.approx(0.030)
    assert read["check_ms"](ctx) == pytest.approx(0.010)
    assert read["wit_s"](ctx) == pytest.approx(15.0)
    assert read["batch_p95_ms"](ctx) == pytest.approx(
        statistics.quantiles(ctx.latencies_s, n=100,
                             method="inclusive")[94] * 1e3)
    assert read["setup_s"](ctx) == 4.5
    assert read["peak_gib"](ctx) == 3.0
    one = SimpleNamespace(trace=t, chips=1)
    assert read["mesh_overlap"](one) is None


def test_rate_and_percentile_take_every_value():
    lat = [float(i) for i in range(1, 101)]
    assert stats.p95(lat) == pytest.approx(95.05)
    assert stats.rate(300, 1.5) == 200.0


def test_no_trace_reads_nothing():
    ctx = SimpleNamespace(trace=None, chips=1)
    for n in ("idle_share", "run_ms", "check_ms", "mesh_overlap"):
        assert manifest.reader(n).read(ctx) is None


def test_guard_compares_whole_top_level_names():
    mods = ["circom_tpu_torch", "circom_tpu_torch.backend.interp",
            "jaxtyping", "torch", "flaxen", "circom_tpu_x"]
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(mods + ["circom_tpu.backend", "jax",
                                          "jaxlib.xla_client", "flax"]) \
        == ["circom_tpu.backend", "flax", "jax", "jaxlib.xla_client"]


def test_a_rehearsal_loads_no_jax(tmp_path):
    """The program's compile, plan and run, as the harness drives them,
    load neither JAX nor the JAX package (the check a run makes after its
    window)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from witbench import guard, harness, manifest\n"
        "c = manifest.Cell('t', 1, {'reference': 'merkle', 'params': "
        "{'depth': 1}, 'prime': 'bn128', 'program': {}}, {'entry': 'run', "
        "'check': True, 'lanes': 2, 'pool': 1, 'judged': 1}, (), ())\n"
        "r = harness.run(c, 1, 0.0, 0, t_start=time.perf_counter(), "
        "device='cpu', batches=1, log=lambda *a: None)\n"
        "print(guard.forbidden_loaded(sys.modules), r['correct'])\n"
        % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.stdout.split("\n")[-2] == "[] True", out.stdout + out.stderr
