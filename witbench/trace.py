"""What a traced window's profiler trace says, in plain arithmetic.

The traced run records the window under torch.profiler (host and device)
and exports it in Chrome's trace format; this module reads the events:

- device operations: events of category kernel, gpu_memcpy or gpu_memset,
  on the card args["device"], with their launch's correlation id;
- launches: the host's runtime calls (cuda_runtime, cuda_driver), which
  carry the same correlation id and the host time of the launch;
- spans: the harness's own annotations (user_annotation), "wb.window"
  around the window and "wb.run", "wb.check", "wb.keep", "wb.sync" around
  each batch's calls.

A device operation belongs to the span in which the host launched it.
From these: each card's busy time, the union of its operations' intervals
inside the window (never their sum, which counts overlaps twice); each
batch's span of a layer on the device, from its first operation's start
to its last one's end on any card; the operations' time by name; and the
idle gaps inside the window by what the host was doing then.  Times in
the trace are microseconds.
"""

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "wb.window"


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals, lo, hi):
    """The merged intervals of `intervals` clipped to [lo, hi], in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, lo, hi):
    return sum(e - s for s, e in union(intervals, lo, hi))


def device_of(op):
    """The card a device operation ran on (its pid where args lack it)."""
    return op.get("args", {}).get("device", op.get("pid"))


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class Trace:
    def __init__(self, events):
        self.ops = _complete(events, DEVICE_CATS)
        launches = {e["args"]["correlation"]: e["ts"]
                    for e in _complete(events, LAUNCH_CATS)
                    if "correlation" in e.get("args", {})}
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in _complete(events, ("user_annotation",))
                       if e["name"].startswith("wb."))
        windows = [(s, e) for s, e, n in spans if n == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"{len(windows)} {WINDOW} spans in the trace")
        self.lo, self.hi = windows[0]
        self.spans = [(s, e, n) for s, e, n in spans if n != WINDOW]
        self._starts = [s for s, _, _ in self.spans]
        # each operation's span index (or None): where its launch lies
        self.owner = [self._span_at(launches.get(
            o.get("args", {}).get("correlation"))) for o in self.ops]

    def _span_at(self, t):
        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return None

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e6

    def devices(self):
        return sorted({device_of(o) for o in self.ops})

    def intervals(self, device):
        return [(o["ts"], o["ts"] + o["dur"]) for o in self.ops
                if device_of(o) == device]

    def busy_s(self):
        """{card: seconds in which an operation ran on it, in the window}."""
        return {d: covered(self.intervals(d), self.lo, self.hi) / 1e6
                for d in self.devices()}

    def layer_spans_ms(self, name):
        """For each batch's span called `name` that launched an operation,
        ms from its operations' first start to their last end, any card."""
        first, last = {}, {}
        for o, i in zip(self.ops, self.owner):
            if i is None or self.spans[i][2] != name:
                continue
            s, e = o["ts"], o["ts"] + o["dur"]
            first[i] = min(first.get(i, s), s)
            last[i] = max(last.get(i, e), e)
        return [(last[i] - first[i]) / 1e3 for i in sorted(first)]

    def ops_by_name(self, top=10):
        """[[name, seconds]] of the device operations inside the window,
        summed over cards, longest first."""
        t = defaultdict(float)
        for o in self.ops:
            t[o["name"]] += max(0.0, min(o["ts"] + o["dur"], self.hi)
                                - max(o["ts"], self.lo)) / 1e6
        return sorted(([n, s] for n, s in t.items() if s > 0),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds]]: each card's gaps between
        its operations inside the window, named by the harness span the
        host was in at the gap's middle ("cuda:<d> <span>", or "between
        spans"), summed by name, longest first."""
        t = defaultdict(float)
        for d in self.devices():
            busy = union(self.intervals(d), self.lo, self.hi)
            edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e > s:
                    i = self._span_at((s + e) / 2)
                    what = self.spans[i][2] if i is not None \
                        else "between spans"
                    t[f"cuda:{d} {what}"] += (e - s) / 1e6
        return sorted(([n, s] for n, s in t.items()),
                      key=lambda x: -x[1])[:top]
