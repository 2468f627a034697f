"""The program's spans in a trace (witbench/spans.py), and the harness's
readings unmoved by them.

On a synthetic window whose batches carry `ctpu.` spans inside the
harness's `wb.` spans: the four quantities by hand; every Trace method
returns what it returns without the program's spans; a trace without
them reads nothing.  On the card (each case skips without one): a traced
window of each cell, where every operation that `wb.run` or `wb.check`
owns was launched inside the program's entry span, the Trace methods are
unmoved by the program's spans, interp_ms + assemble_ms is run_ms within
2 % and issue_idle_share at most idle_share:

    python -m pytest witbench/tests/test_wb_spans.py -q -s
"""

import statistics
import time

import pytest

from witbench.spans import ProgramSpans, innermost, traced_run
from witbench.tests.test_wb_card import NAMES, card_cell
from witbench.tests.test_wb_metrics import ev
from witbench.trace import Trace


def harness_events():
    """test_wb_metrics' window: batch 1 launches k1 and kw (run) and kc
    (check); batch 2 launches k1 and a kernel on card 1 (run); a kernel
    starts before the window."""
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
          ev("kernel", "k3", 70, 20, device=1, correlation=5),
          ev("kernel", "early", -10, 15, device=0, correlation=6)]
    return e


# (name, start, end): each launch's ctpu.launch around its cudaLaunchKernel
PROGRAM = [("ctpu.run", 1.2, 4.8), ("ctpu.interp_k1", 1.5, 2.5),
           ("ctpu.launch", 1.9, 2.1), ("ctpu.assemble", 2.6, 3.4),
           ("ctpu.launch", 2.9, 3.1),
           ("ctpu.check", 6.1, 7.9), ("ctpu.r1cs_check", 6.5, 7.5),
           ("ctpu.launch", 6.9, 7.1),
           ("ctpu.run", 50.2, 54.0), ("ctpu.interp_k1", 50.5, 51.5),
           ("ctpu.launch", 50.9, 51.1), ("ctpu.gather_n", 51.6, 52.6),
           ("ctpu.launch", 51.9, 52.1)]


def program_events(skip=()):
    """The program's spans on the host, and (as the profiler adds them)
    on the card's side."""
    out = []
    for n, s, e in PROGRAM:
        if n not in skip:
            out += [ev("user_annotation", n, s, e - s),
                    ev("gpu_user_annotation", n, s + 4, e - s, device=0)]
    return out


def spans(skip=()):
    events = harness_events() + program_events(skip)
    return ProgramSpans(events, Trace(events))


def test_the_four_quantities_by_hand():
    ps = spans()
    # batch 1: run 3.6 + check 1.8 us; batch 2: run 3.8 us
    assert ps.issue_ms() == pytest.approx(statistics.median([5.4e-3,
                                                             3.8e-3]))
    # K1's operations: 20 us in each run; KW 10, K3 20
    assert ps.interp_ms() == pytest.approx(0.020)
    assert ps.assemble_ms() == pytest.approx(0.015)
    # card 0 idle [45, 60) and [80, 100): 3.8 us inside batch 2's run;
    # card 1 idle but for [70, 90): every entry span, 9.2 us
    by = ps.idle_by_span()
    assert sum(by.values()) == pytest.approx(13.0e-6)
    assert by["ctpu.run"] == pytest.approx(5.4e-6)
    assert by["ctpu.launch"] == pytest.approx(1.4e-6)
    assert by["ctpu.gather_n"] == pytest.approx(1.6e-6)
    assert ps.issue_idle_share(2) == pytest.approx(100 * 13.0 / 2 / 100)
    idle_share = 100 * (1 - sum(ps.trace.busy_s().values()) / 2
                        / ps.trace.window_s)
    assert ps.issue_idle_share(2) <= idle_share
    # all the idle time (115 us), clipped to the spans: batch 2's run
    # 3.8 us on each card, wb.run's edges around it, the sync, the loop
    split = ps.idle_split()
    assert sum(split.values()) == pytest.approx(115e-6)
    assert sum(v for n, v in split.items() if n.startswith("ctpu.")) == \
        pytest.approx(13.0e-6)
    assert split["wb.sync"] == pytest.approx(43e-6)
    assert split["wb.run"] == pytest.approx(2.8e-6)
    assert split["between spans"] == pytest.approx(56e-6)
    assert ps.outside_entries() == []
    assert set(ps.readings(2)) == {"issue_ms", "issue_idle_share",
                                   "interp_ms", "assemble_ms"}


def test_an_operation_launched_outside_the_entries_is_named():
    ps = spans(skip=("ctpu.check",))
    assert ps.outside_entries() == ["kc"]


def test_innermost_names_each_piece_by_its_deepest_span():
    got = innermost([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d")])
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                   (5, 6, "a"), (6, 8, "d"), (8, 10, "a")]


def test_a_trace_without_program_spans_reads_nothing():
    events = harness_events()
    assert ProgramSpans(events, Trace(events)).readings(2) == {}


def same_readings(with_program, without):
    """Every Trace method gives the same output on both traces."""
    a, b = Trace(with_program), Trace(without)
    assert a.spans == b.spans and a.owner == b.owner
    assert (a.lo, a.hi, a.window_s) == (b.lo, b.hi, b.window_s)
    assert a.busy_s() == b.busy_s()
    for name in ("wb.run", "wb.check", "wb.keep", "wb.sync"):
        assert a.layer_spans_ms(name) == b.layer_spans_ms(name)
    assert a.ops_by_name() == b.ops_by_name()
    assert a.idle_gaps() == b.idle_gaps()


def test_the_harness_readings_ignore_the_program_spans():
    same_readings(harness_events() + program_events(), harness_events())


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_a_traced_window_on_the_card(name):
    c = card_cell(name)
    r, ps = traced_run(c, 2 ** 31 + 2424, 0.0, batches=12,
                       log=lambda *a: None)
    assert r["correct"]
    kept = [e for e in ps.events if not (
        e.get("cat") in ("user_annotation", "gpu_user_annotation")
        and e.get("name", "").startswith("ctpu."))]
    same_readings(ps.events, kept)
    assert ps.outside_entries() == []
    got = ps.readings(c.chips)
    run_ms = statistics.median(ps.trace.layer_spans_ms("wb.run"))
    idle_share = 100 * (1 - sum(ps.trace.busy_s().values()) / c.chips
                        / ps.trace.window_s)
    print(f"\nSPANS {name} {got} run_ms {run_ms} idle_share {idle_share} "
          f"{ps.idle_split()} at {time.strftime('%H:%M:%S')}")
    assert set(got) == {"issue_ms", "issue_idle_share", "interp_ms",
                        "assemble_ms"}
    assert got["interp_ms"] + got["assemble_ms"] == pytest.approx(
        run_ms, rel=0.02)
    assert got["issue_idle_share"] <= idle_share
