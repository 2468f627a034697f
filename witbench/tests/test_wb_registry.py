"""Configurations, traffic mixes and metrics are found by name: adding a
file of each (and an entry naming it) adds a cell or a metric, with no
edit to a file that is there."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from witbench import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "witbench"


def test_every_name_of_the_manifest_has_its_files():
    m = manifest.load_json(ROOT / "BENCHMARK.json")
    for w in m["workloads"]:
        cell = manifest.cell(ROOT / "BENCHMARK.json", w["name"])
        assert cell.config["name"] == w["config"]
        assert manifest.reference(cell.config).make_batch
        assert {e["name"] for e in cell.end_to_end} >= {"setup_s", "wit_s"}
        assert cell.per_layer
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists()
        assert manifest.load_json(ROOT / c["file"])["name"] == c["name"]
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"]).read)


def snapshot(d):
    return {p: p.read_bytes() for p in d.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    bench = tmp_path / "witbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = snapshot(bench)
    (bench / "configs" / "merkle4-bn128.json").write_text(json.dumps({
        "name": "merkle4-bn128", "reference": "merkle",
        "params": {"depth": 4}, "prime": "bn128", "reduced": []}))
    (bench / "traffic" / "run-64.json").write_text(json.dumps({
        "entry": "run", "check": False, "lanes": 64, "pool": 2,
        "judged": 4, "rehearse_lanes": 4}))
    (bench / "metrics" / "lanes_done.py").write_text(
        "def read(ctx):\n    return ctx.n_batches * ctx.lanes\n")
    m = manifest.load_json(ROOT / "BENCHMARK.json")
    m["configs"].append({"name": "merkle4-bn128", "source": "x",
                         "file": "witbench/configs/merkle4-bn128.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "mk4.run", "config": "merkle4-bn128",
                           "traffic": "run-64", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "lanes_done", "unit": "witnesses",
                           "better": "higher", "source": "host_clock",
                           "layer": "witness program", "moves": "wit_s",
                           "workloads": ["mk4.run"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    cell = manifest.cell(path, "mk4.run", bench=bench)
    assert cell.config["params"] == {"depth": 4}
    assert cell.traffic["lanes"] == 64
    assert "lanes_done" in {e["name"] for e in cell.per_layer}
    assert "lanes_done" not in {e["name"] for e in manifest.cell(
        path, "mk32.run", bench=bench).per_layer}
    ctx = SimpleNamespace(n_batches=3, lanes=64)
    assert manifest.reader("lanes_done", bench=bench).read(ctx) == 192
    ref = manifest.reference(cell.config, bench=bench)
    assert "MerkleInclusion(4)" in ref.source(cell.config["params"])
    after = snapshot(bench)
    assert {p: b for p, b in after.items() if p in before} == before


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        manifest.cell(ROOT / "BENCHMARK.json", "no.such.cell")
