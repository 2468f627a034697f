"""The control and the faults at each cell's own size, on the card.

Each case drives harness.run over a cell of BENCHMARK.json at its own
lanes, as many batches as a run judges lanes, and prints the numbers
compared, the readings PERF.md sets the limits from: the control (the
reference put in the program's place, a guarantee broken) on three
seeds, and each fault of test_wb_faults.py.  Every one must come out not correct.  Run on the card:

    python -m pytest witbench/tests/test_wb_card.py -q -s -k <cell>

(the mesh cell on four cards).  Without a card, or with fewer than a cell
asks for, each case skips.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from witbench import harness, manifest
from witbench.tests import test_wb_faults as faults

ROOT = Path(__file__).resolve().parents[2]
NAMES = [w["name"] for w in manifest.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def card_cell(name):
    c = manifest.cell(ROOT / "BENCHMARK.json", name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        pytest.skip(f"{name} needs {c.chips} CUDA card(s)")
    return c


def readings(c, seed, **kw):
    r = harness.run(c, seed, 0.0, 0, t_start=time.perf_counter(),
                    batches=c.traffic["judged"], log=lambda *a: None, **kw)
    got = {k: v["value"] for k, v in r["compared"].items()}
    print(f"\nREADINGS {json.dumps({'cell': c.name, 'seed': seed, **got})}")
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_control_is_not_correct(name):
    c = card_cell(name)
    for seed in SEEDS:
        r = readings(c, seed, control=True)
        assert not r["correct"]


def wraps(c):
    out = [faults.stale, faults.half, faults.altered, faults.swapped]
    if c.traffic["entry"] == "mesh":
        out.append(faults.exchange)
    if c.traffic["check"]:
        out += [faults.pass_all, faults.fail_all]
    return out


CASES = [(n, w.__name__, k) for n in NAMES for k, w in enumerate(
    wraps(manifest.cell(ROOT / "BENCHMARK.json", n)))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault,k", CASES,
                         ids=[f"{n}-{f}" for n, f, _ in CASES])
def test_fault_is_not_correct(name, fault, k):
    c = card_cell(name)
    r = readings(c, SEEDS[k % 3], wrap=getattr(faults, fault))
    print(f"FAULT {fault}")
    assert not r["correct"], fault
