"""A run with the timed path broken underneath comes out not correct.

Each test drives harness.run on the CPU (the look for a card skipped, the
port's plain versions) over MerkleInclusion(2) at a handful of lanes, with
the entry's calls wrapped by a fault: a step that returns its state
unchanged (the first batch's witness, every batch), half of the batch left out (its
lanes never written), the exchange between cards left out (every shard
the first one's), an answer altered where it is produced (witness row 1,
the root), two internal rows of the witness swapped (as a wrong table in
the kernels that place rows, KW or K3, would leave them), and a checker
that passes or fails every lane.  Without a
fault every cell comes out correct.
"""

import time

import pytest
import torch

from witbench import harness, manifest

CONFIG = {"name": "merkle2-bn128", "reference": "merkle",
          "params": {"depth": 2}, "prime": "bn128",
          "program": {"unroll_threshold": 0}}


def cell(entry, check, chips=1):
    traffic = {"entry": entry, "check": check, "lanes": 4 * chips,
               "pool": 2, "judged": 4, "rehearse_lanes": 4 * chips}
    return manifest.Cell(f"mk2.{entry}", chips, CONFIG, traffic, (), ())


def parts(out):
    """The witness tensors of a batch's output, the int32 views."""
    if isinstance(out, tuple) and isinstance(out[0], tuple):
        return [t for shard in out for t in shard]
    ts = out if isinstance(out, tuple) else (out,)
    return [t.view(torch.int32) for t in ts]


def stale(entry):
    """The step computes once and then returns its state unchanged: the
    first batch's witness for every later batch."""
    step, first = entry.step, []

    def f(x):
        if not first:
            first.append(step(x))
        return first[0]
    entry.step = f


def half(entry):
    step = entry.step

    def f(x):
        out = step(x)
        if entry.kind == "mesh":
            for z in out[len(out) // 2:]:
                z.view(torch.int32).zero_()
        else:
            for t in parts(out):
                t[..., t.shape[-1] // 2:] = 0
        return out
    entry.step = f


def exchange(entry):
    """Every card's shard is the first card's: the inputs never reached
    the other cards (each keeps its own device)."""
    step = entry.step

    def f(x):
        out = step(x)
        return tuple(out[0].view(torch.int32).to(z.device).view(z.dtype)
                     for z in out)
    entry.step = f


def altered(entry):
    step = entry.step

    def f(x):
        out = step(x)
        if entry.kind == "run_mixed":
            narrow, wide = out
            if 1 in entry.layout[0]:
                narrow[entry.layout[0].index(1)] ^= 1
            else:
                w = wide.view(torch.int32)
                w[entry.layout[1].index(1), 0] ^= 1
        else:
            for z in (out if entry.kind == "mesh" else (out,)):
                z.view(torch.int32)[1, 0] ^= 1
        return out
    entry.step = f


def swapped(entry):
    """Two internal rows trade places in every batch: the row halfway down
    the witness (run_mixed: its narrow rows) and, of the rows after a
    quarter of the way, the one that differs from it in the most lanes of
    the first batch (the rows of a bit differ in only some)."""
    step, pair = entry.step, []

    def f(x):
        out = step(x)
        zs = [out[0]] if entry.kind == "run_mixed" else list(
            out if entry.kind == "mesh" else (out,))
        for z in zs:
            v = z.view(torch.int32)
            if not pair:
                i = v.shape[0] // 2
                flat = v.reshape(v.shape[0], -1)
                diff = (flat != flat[i]).sum(1)
                diff[i] = -1
                diff[:v.shape[0] // 4] = -1
                pair.extend((i, int(diff.argmax())))
            i, j = pair
            v[[i, j]] = v[[j, i]]
        return out
    entry.step = f


def pass_all(entry):
    check = entry.check
    entry.check = lambda out: torch.ones_like(check(out))


def fail_all(entry):
    check = entry.check
    entry.check = lambda out: torch.zeros_like(check(out))


def run(c, wrap=None, seed=2 ** 31 + 99):
    """Six batches, a lane of each judged."""
    return harness.run(c, seed, 0.0, 0, t_start=time.perf_counter(),
                       device="cpu", lanes=c.traffic["lanes"], pool=2,
                       batches=6, wrap=wrap, log=lambda *a: None)


CELLS = {"run": cell("run", False), "checked": cell("run", True),
         "mixed": cell("run_mixed", False), "mesh": cell("mesh", True, 4)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_runs_are_correct(name):
    r = run(CELLS[name])
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"
    assert r["attempted"] == r["batches"] * CELLS[name].traffic["lanes"]


FAULTS = [(c, f) for c in sorted(CELLS)
          for f in (stale, half, altered, swapped)] \
    + [("mesh", exchange), ("checked", pass_all), ("checked", fail_all),
       ("mesh", pass_all)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_is_not_correct(name, fault):
    r = run(CELLS[name], wrap=fault)
    assert not r["correct"], r["compared"]


def test_the_control_is_not_correct():
    r = harness.run(CELLS["run"], 5, 0.0, 0, t_start=time.perf_counter(),
                    device="cpu", lanes=4, pool=2, batches=2, control=True,
                    log=lambda *a: None)
    assert not r["correct"]
    assert r["compared"]["bad_outputs"]["value"] == r["judged"]
