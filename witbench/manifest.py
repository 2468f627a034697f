"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, so that adding a cell or a metric adds
files and entries and edits none:

- a configuration `<name>` is witbench/configs/<name>.json: the circuit's
  plain reference (a module of witbench/refs/), its parameters, the prime,
  the program's options, the guarantees and the sizes;
- a traffic mix `<name>` is witbench/traffic/<name>.json, the parameters
  of the one closed-loop generator (harness.py): the entry, whether the
  batch is checked, the lanes a batch, the pool of distinct batches, the
  answers kept and judged;
- a metric `<name>` is witbench/metrics/<name>.py, a reader with
  `read(ctx)` that returns its value, or None where it finds nothing to
  read (the metric is then left out of the line).
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple     # the metric entries this cell reports, trace 0
    per_layer: tuple      # and trace 1


def load_json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, cell):
    """Whether the cell `cell` reports `metric`: every cell, unless the
    metric lists its cells under "workloads"."""
    return cell in metric.get("workloads", (cell,))


def cell(manifest_path, name, bench=BENCH):
    """The workload `name` of the manifest, with its configuration and
    traffic read from their files under `bench`."""
    m = load_json(manifest_path)
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    w = found[0]
    config = load_json(bench / "configs" / f"{w['config']}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                tuple(e for e in m["end_to_end"] if reports(e, name)),
                tuple(e for e in m["per_layer"] if reports(e, name)))


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config, bench=BENCH):
    """The plain reference module the configuration names."""
    return _module(bench / "refs" / f"{config['reference']}.py",
                   f"witbench_ref_{config['reference']}")


def reader(metric_name, bench=BENCH):
    """The metric's reader, witbench/metrics/<name>.py."""
    return _module(bench / "metrics" / f"{metric_name}.py",
                   f"witbench_metric_{metric_name.replace('.', '_')}")
