"""What the program's own spans say in a traced window.

The port marks its work with `ctpu.*` spans (torch.profiler
record_function, circom_tpu_torch/utils/profiling.py), which land in the
traced run's trace beside the harness's `wb.*` spans:

- entry spans: `ctpu.run`, `ctpu.run_mixed` (a batch's witness) and
  `ctpu.check` (its verdicts), one a call;
- kernel spans, each kernel with its allocations, arguments and launch:
  `ctpu.interp_k1` (K1), `ctpu.assemble`, `ctpu.gather_w`,
  `ctpu.gather_n` (KW, K2, K3), `ctpu.r1cs_check` (KC);
- `ctpu.launch`, the C call of each launch.

Trace (trace.py) keeps the harness's spans and leaves these out, so the
quantities here are read from the trace's events beside it:

- issue_ms: the median over the window's batches of the host's ms inside
  the batch's entry spans (its run, and its check in checked cells);
- issue_idle_share: the cards' idle time in the window that lies inside
  an entry span (clipped to it, not named by a midpoint), over the window,
  averaged over the cards, in %; `idle_by_span` splits it by the
  innermost program span the host was in, `idle_split` all the idle
  time by the innermost span, the program's or the harness's;
- interp_ms, assemble_ms: the median over the window's run spans of the
  summed device time of the operations launched inside K1's span, or
  inside KW's, K2's and K3's.

Each is None where the trace holds no such span (a program without
them).  Times in the trace are microseconds.

    python -m witbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell once, traced, and prints its result line with these beside
it, under "spans" (the harness's run, its trace's events kept as they are
read).
"""

import bisect
import statistics
from collections import defaultdict

from . import trace as tracemod

PREFIX = "ctpu."
RUNS = ("ctpu.run", "ctpu.run_mixed")
ENTRIES = RUNS + ("ctpu.check",)
INTERP = ("ctpu.interp_k1",)
ASSEMBLY = ("ctpu.assemble", "ctpu.gather_w", "ctpu.gather_n")


def _at(intervals, t):
    """The index of the interval of `intervals` (sorted, disjoint) that
    holds t, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i if i >= 0 and t <= intervals[i][1] else None


def innermost(spans):
    """[(start, end, name)] in order: the time the spans (nested, as one
    thread's are) cover, each piece named by the innermost span there."""
    out, stack, t = [], [], None
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, n))
        t = s
    while stack:
        end, name = stack.pop()
        if end > t:
            out.append((t, end, name))
            t = end
    return out


def overlap(named, plain):
    """[(start, end, name)]: where the pieces `named` (sorted, disjoint,
    named) meet the intervals `plain` (sorted, disjoint)."""
    out, j = [], 0
    for s, e, n in named:
        while j < len(plain) and plain[j][1] <= s:
            j += 1
        k = j
        while k < len(plain) and plain[k][0] < e:
            a, b = max(s, plain[k][0]), min(e, plain[k][1])
            if b > a:
                out.append((a, b, n))
            k += 1
    return out


def idle(trace, device):
    """The card's idle intervals inside the window, in order."""
    busy = tracemod.union(trace.intervals(device), trace.lo, trace.hi)
    edges = [trace.lo] + [x for iv in busy for x in iv] + [trace.hi]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


class ProgramSpans:
    """The program's spans of a traced window: `events`, the trace's
    events; `trace`, the Trace made of them."""

    def __init__(self, events, trace):
        self.events, self.trace = events, trace
        self.spans = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"])
            for e in tracemod._complete(events, ("user_annotation",))
            if e["name"].startswith(PREFIX))
        launches = {e["args"]["correlation"]: e["ts"]
                    for e in tracemod._complete(events, tracemod.LAUNCH_CATS)
                    if "correlation" in e.get("args", {})}
        # the host time of each device operation's launch (or None)
        self.launched = [launches.get(o.get("args", {}).get("correlation"))
                         for o in trace.ops]

    def of(self, names, window=False):
        """[(start, end)] of the spans called one of `names`, in order;
        with `window`, those that start inside the window."""
        lo, hi = self.trace.lo, self.trace.hi
        return [(s, e) for s, e, n in self.spans if n in names
                and (not window or lo <= s <= hi)]

    def issue_ms(self):
        tr = self.trace
        batch, k = [], -1
        for _, _, n in tr.spans:
            k += n == "wb.run"
            batch.append(k)
        per = defaultdict(float)
        for s, e in self.of(ENTRIES, window=True):
            i = tr._span_at(s)
            if i is not None and batch[i] >= 0:
                per[batch[i]] += e - s
        return statistics.median(per.values()) / 1e3 if per else None

    def _idle_in(self, pieces):
        out = defaultdict(float)
        for d in self.trace.devices():
            for s, e, n in overlap(pieces, idle(self.trace, d)):
                out[n] += (e - s) / 1e6
        return dict(out)

    def idle_by_span(self):
        """{innermost program span: seconds} of the cards' idle time in
        the window inside the entry spans, summed over the cards."""
        tr = self.trace
        entry = [tuple(iv) for iv in tracemod.union(self.of(ENTRIES),
                                                    tr.lo, tr.hi)]
        return self._idle_in(overlap(innermost(self.spans), entry))

    def idle_split(self):
        """{innermost span, the program's or the harness's, or "between
        spans": seconds} of the cards' idle time in the window, summed
        over the cards: all of it, clipped to the spans."""
        tr = self.trace
        return self._idle_in(innermost(
            self.spans + tr.spans + [(tr.lo, tr.hi, "between spans")]))

    def issue_idle_share(self, chips):
        if not self.of(ENTRIES):
            return None
        idle_s = sum(self.idle_by_span().values())
        return 100 * idle_s / chips / self.trace.window_s

    def device_ms(self, names):
        """The median over the window's run spans of the summed device ms
        of the operations launched inside a span called one of `names`."""
        runs, inner = self.of(RUNS, window=True), self.of(names)
        per, found = [0.0] * len(runs), False
        for o, t in zip(self.trace.ops, self.launched):
            if t is None or _at(inner, t) is None:
                continue
            i = _at(runs, t)
            if i is not None:
                per[i] += o["dur"]
                found = True
        return statistics.median(per) / 1e3 if found else None

    def interp_ms(self):
        return self.device_ms(INTERP)

    def assemble_ms(self):
        return self.device_ms(ASSEMBLY)

    def outside_entries(self):
        """The names of the device operations that `wb.run` or `wb.check`
        owns but that were launched outside every entry span."""
        tr, entries = self.trace, self.of(ENTRIES)
        return [o["name"] for o, i, t in zip(tr.ops, tr.owner, self.launched)
                if i is not None and tr.spans[i][2] in ("wb.run", "wb.check")
                and _at(entries, t) is None]

    def readings(self, chips):
        """The four quantities by name, those the trace holds."""
        got = {"issue_ms": self.issue_ms(),
               "issue_idle_share": self.issue_idle_share(chips),
               "interp_ms": self.interp_ms(),
               "assemble_ms": self.assemble_ms()}
        return {k: v for k, v in got.items() if v is not None}


def traced_run(cell, seed, seconds, **kw):
    """harness.run of `cell`, traced, and the ProgramSpans of its window:
    the trace's events kept as harness.run reads them through
    trace.load."""
    import time

    from . import harness

    t_start = time.perf_counter()
    kept, load = [], tracemod.load

    def keep(path):
        kept.append(load(path))
        return kept[-1]

    tracemod.load = keep
    try:
        result = harness.run(cell, seed, seconds, 1, t_start=t_start, **kw)
    finally:
        tracemod.load = load
    events = kept[-1]
    return result, ProgramSpans(events, tracemod.Trace(events))


def main(argv=None):
    import argparse
    import json
    import sys

    from . import harness, manifest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    harness.set_caches()
    cell = manifest.cell(harness.ROOT / "BENCHMARK.json", a.workload)
    try:
        result, ps = traced_run(cell, a.seed, a.seconds,
                                log=lambda *x: print(*x, file=sys.stderr,
                                                     flush=True))
    except harness.Refused as e:
        print(f"witbench.spans: {e}", file=sys.stderr)
        return e.code
    result["spans"] = {
        **ps.readings(cell.chips),
        "idle_split": ps.idle_split(),
        "outside_entries": len(ps.outside_entries())}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
