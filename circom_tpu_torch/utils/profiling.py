"""Tracing / profiling / statistics (SURVEY.md §5 aux subsystems).

The port of the JAX package's `circom_tpu/utils/profiling.py`.  The
reference has only vestigial timing prints
(constraint_simplification.rs:469-479) and a statistics exporter
(dag/src/statistics_porting.rs:25).  Here: the program's spans (`span`),
circuit statistics JSON, a torch.profiler trace of the card's witness path
(`device_trace`, in place of the JAX package's jax.profiler trace), and
`profile_breakdown`, which prints where a warm run's device time goes.

The program's spans, all named `ctpu.*` (SPAN_PREFIX):

- `ctpu.run`, `ctpu.run_mixed`: a call of WitnessProgram.run / .run_mixed,
  whatever backend runs it (backend/torch_backend.py);
- `ctpu.check`: a call of R1CSChecker.check_detailed (backend/checker.py);
- `ctpu.interp_k1`, `ctpu.assemble`, `ctpu.gather_w`, `ctpu.gather_n`,
  `ctpu.r1cs_check`: on a card, K1, KW, K2, K3 and KC each with its
  allocations, its arguments and its launch (backend/interp.py,
  backend/checker.py), named as ops/build.LAUNCHES counts them;
- `ctpu.launch`: the C call of every kernel launch (ops/build.launch).
  Its wrapper's span less this one is allocation and argument marshalling.

A span is torch.profiler.record_function while a profiler is active, so
it lands in the profiler's trace on the clock of the card's operations,
each launch tied to its kernel by correlation id.  With no profiler
active it costs one test of the profiler's flag: record_function itself
costs some 13 us even then.  Capture them with `device_trace`.
"""

import contextlib
import json
import os
import time

import torch

SPAN_PREFIX = "ctpu."
_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name):
    """A context manager: the span `name` (a `ctpu.` name) in the active
    profiler's trace, or nothing where no profiler is active."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(logdir):
    """torch.profiler trace of the enclosed work: the host's operators and
    the program's spans and, when a card is present, its kernels and
    copies.  The trace is written
    to `logdir`/trace.json in Chrome's trace format (chrome://tracing,
    Perfetto, TensorBoard's profiler plugin).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def circuit_statistics(cc):
    """Statistics export (dag/src/statistics_porting.rs analog)."""
    rows = cc.r1cs_rows()
    counts = cc.counts()
    n_linear = sum(1 for (a, b, _c) in rows if not a and not b)
    per_template = {}
    for node in cc.dag.nodes:
        st = per_template.setdefault(node.template_name, {
            "instances": 0, "constraints": 0, "signals": 0,
        })
        st["instances"] += 1
        st["constraints"] += len(node.constraints)
        st["signals"] += len(node.locals)
    return {
        "prime": cc.archive.prime,
        "constraints": len(rows),
        "non_linear_constraints": len(rows) - n_linear,
        "linear_constraints": n_linear,
        "wires": counts["n_wires"],
        "labels": counts["n_labels"],
        "public_outputs": counts["n_pub_out"],
        "public_inputs": counts["n_pub_in"],
        "private_inputs": counts["n_prv_in"],
        "template_instances": len(cc.dag.nodes),
        "per_template": per_template,
    }


def write_statistics(cc, path):
    with open(path, "w") as f:
        json.dump(circuit_statistics(cc), f, indent=1)


def _say(*a):
    print(*a, flush=True)


def sync_all():
    """Wait for every card's work (torch.cuda.synchronize waits for the
    current card's only)."""
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def wall_ms(fn):
    """ms of one fn() by the host clock, synchronised with every card on
    both sides."""
    sync_all()
    t = time.perf_counter()
    out = fn()
    sync_all()
    return out, (time.perf_counter() - t) * 1e3


def device_ops(averages):
    """The kernels and copies among key_averages()' events.  An aten op
    carries its kernels' device time as well, and annotations appear on
    the card's side too, spanning its work: the schedule's ProfilerStep
    and the program's spans."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("ProfilerStep", SPAN_PREFIX))]


def profile_breakdown(fn, wall, reps=3, warmup=1, aten=True, show=(),
                      runs=1, pad=0.0):
    """Where a warm run's time goes, printed: device time by kernel from
    torch.profiler, and the device's idle share of the run's wall time
    (`wall`, ms, measured without the profiler, is printed beside it),
    averaged over `reps` profiler steps of `runs` runs each.  A traced
    step before them warms the tracer up: without it the kernels of a
    short first run can go unrecorded (a run of thousands of launches
    needs none).  A run of a few launches needs runs > 1: traced one at a
    time, the kernels of Poseidon2/goldilocks' 3-launch run went
    unrecorded altogether.  aten=False leaves PyTorch's operator events
    out of the host times (a per-op run records some 180,000, slow to
    summarise); the CUDA runtime's calls stay.  `pad` seconds of host
    time stand before and after each step's runs, inside the step and
    outside its timing, so that no kernel runs near the edge of the
    traced window.  Kernels whose names hold
    a string of `show` are printed beside the eight longest.  Returns
    (device busy ms, wall ms, kernels and copies, {name: (count, device
    ms)} of the kernels and copies) a run; the busy time
    sums every card's kernels, so on several cards it exceeds the wall
    time where their work overlaps (on one card's stream the kernels run
    one at a time, and the sum is the time the card was busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def step():
        # each run's output is dropped before the next run: a run's output
        # may take more than a tenth of the card (MK's witness, 10.9 GB)
        for _ in range(runs):
            fn()

    ms, traced = 0.0, []
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if aten else []),
                 schedule=schedule(wait=0, warmup=warmup, active=reps),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for k in range(warmup + reps):
            time.sleep(pad)
            _, t = wall_ms(step)
            time.sleep(pad)
            ms += t if k >= warmup else 0.0
            prof.step()
    ms /= reps * runs
    reps *= runs
    events = device_ops(traced[0])
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    n_kernels = sum(e.count for e in events) / reps
    events.sort(key=lambda e: -e.self_device_time_total)
    _say(f"  profile of {reps} warm runs (a run {ms:.3f} ms under the "
         f"profiler, {wall:.2f} ms without): device busy {busy:.3f} ms a "
         f"run, idle share {max(0.0, 1 - busy / ms):.3f}, {n_kernels:g} "
         "kernels and copies a run")
    for e in events[:8] + [e for e in events[8:]
                           if any(k in e.key for k in show)]:
        _say(f"    {e.self_device_time_total / 1e3 / reps:8.3f} ms "
             f"x{e.count / reps:<5g} {e.key[:90]}")
    host = sorted((e for e in traced[0] if e.device_type == DeviceType.CPU
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda e: -e.self_cpu_time_total)
    _say("  host time a run by op: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3 / reps:.3f} ms "
        f"x{e.count / reps:g}" for e in host[:6]))
    return busy, ms, n_kernels, {
        e.key: (e.count / reps, e.self_device_time_total / 1e3 / reps)
        for e in events}
