"""The program's spans (utils/profiling.span).

With no profiler active a span is one flag test: run, run_mixed and
check_detailed enter no record_function.  Under torch.profiler each entry
call records one span of its name, and every span the package names is a
`ctpu.` span.  These run on the CPU on a circuit of a few steps (under the
profiler the plain versions record every tensor operation: a
MerkleInclusion(1) run records 372,000 events).  On a card (the case
skips without one) MerkleInclusion(4)'s kernel spans nest inside their
entry span and each launch inside its kernel's span.  The file imports
neither JAX nor circom_tpu, so it runs on the card's machine with the
JAX-forcing conftest left out:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import ast
import json
import random
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import MIXED_SRC, merkle_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import to_device
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.utils.profiling import SPAN_PREFIX, device_ops

PACKAGE = Path(__file__).resolve().parents[1] / "circom_tpu_torch"
ENTRIES = ("ctpu.run", "ctpu.run_mixed", "ctpu.check")
# each kernel's span, named as ops/build.LAUNCHES counts its launches
KERNELS = ("ctpu.interp_k1", "ctpu.assemble", "ctpu.gather_w",
           "ctpu.gather_n", "ctpu.r1cs_check")
LAUNCH = "ctpu.launch"
BATCH = 4


def on(source, device):
    """(program, checker, input rows of four lanes) of the circuit
    `source` over bn128 on `device`."""
    cc = compile_source(source)
    tape, _ = cc.build_tape()
    spec = field_spec("bn128")
    hints = cc.input_range_hints()
    prog = WitnessProgram(tape, spec, device=device, input_ranges=hints)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=device)
    rng = random.Random(11)
    cols = [[rng.randrange(2) if i in hints else rng.randrange(cc.p)
             for _ in range(BATCH)] for i in range(tape.n_inputs)]
    return prog, checker, to_device(prog.encode_inputs(cols), prog.device)


@pytest.fixture(scope="module")
def small():
    return on(MIXED_SRC, "cpu")


def calls(prog, checker, x):
    """Each entry call by its span's name."""
    return {"ctpu.run": lambda: prog.run(x),
            "ctpu.run_mixed": lambda: prog.run_mixed(x),
            "ctpu.check": lambda: checker.check_detailed(prog.run(x))}


def test_no_record_function_without_a_profiler(small, monkeypatch):
    prog, checker, x = small
    entered = []
    plain_enter = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return plain_enter(self)

    monkeypatch.setattr(record_function, "__enter__", counting)
    for call in calls(prog, checker, x).values():
        call()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        prog.run(x)
    assert entered == ["ctpu.run"]          # the counter itself counts


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_entry_span_a_call_under_the_profiler(small, entry):
    prog, checker, x = small
    call = calls(prog, checker, x)[entry]
    call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    got = Counter(e.name for e in prof.events()
                  if e.name.startswith(SPAN_PREFIX))
    # the check's call runs the program first; on the CPU no kernel span
    want = {"ctpu.check": 1, "ctpu.run": 1} if entry == "ctpu.check" \
        else {entry: 1}
    assert dict(got) == want


def span_names():
    """The first argument of every span(...) call in the package."""
    names = []
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) == "span":
                arg = node.args[0]
                names.append(arg.value if isinstance(arg, ast.Constant)
                             else ast.unparse(arg))
    return names


def test_every_span_is_a_ctpu_span():
    names = span_names()
    assert all(n.startswith(SPAN_PREFIX) for n in names), names
    assert sorted(set(names)) == sorted(ENTRIES + KERNELS + (LAUNCH,))


def test_breakdown_leaves_out_the_annotations():
    """profile_breakdown counts kernels and copies: the card's side of the
    profiler's step and of the program's spans is no operation."""
    def ev(key, device=DeviceType.CUDA):
        return SimpleNamespace(key=key, device_type=device)

    kernel = ev("void ctpu::interp_k1_kernel<16, true, false>(...)")
    copy = ev("Memcpy DtoH (Device -> Pageable)")
    got = device_ops([ev("ProfilerStep#2"), ev("ctpu.run"), kernel,
                      ev("ctpu.launch"), copy, ev("ctpu.run", DeviceType.CPU),
                      ev("cudaLaunchKernel", DeviceType.CPU)])
    assert got == [kernel, copy]


def nest(events):
    """{name: [(start, end)]} of the trace's ctpu. host spans, and
    [(launch time, kernel name)] of its kernels."""
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith(SPAN_PREFIX):
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    kernels = [(launched.get(e["args"].get("correlation")), e["name"])
               for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    return spans, kernels


def inside(t, intervals):
    return any(s <= t <= e for s, e in intervals)


def within(a, intervals):
    return any(s <= a[0] and a[1] <= e for s, e in intervals)


@pytest.mark.cuda
def test_kernel_spans_nest_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prog, checker, x = on(merkle_source(4), torch.device("cuda", 0))
    for call in calls(prog, checker, x).values():
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls(prog, checker, x).values():
            call()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans, kernels = nest(json.loads(path.read_text())["traceEvents"])
    entries = [iv for n in ENTRIES for iv in spans.get(n, [])]
    assert [len(spans.get(n, [])) for n in ENTRIES] == [2, 1, 1]
    wrappers = [iv for n in KERNELS for iv in spans.get(n, [])]
    for n in KERNELS:
        assert all(within(iv, entries) for iv in spans.get(n, [])), n
    # K1 in each run, K3 in run_mixed (MerkleInclusion's pathIndex rows
    # are narrow), KC in the check
    for n in ("ctpu.interp_k1", "ctpu.gather_n", "ctpu.r1cs_check"):
        assert spans.get(n), n
    assert all(within(iv, wrappers) for iv in spans[LAUNCH])
    ours = [(t, k) for t, k in kernels if "ctpu::" in k]
    assert len(ours) == len(spans[LAUNCH]) >= 6
    assert all(t is not None and inside(t, spans[LAUNCH]) for t, k in ours)
