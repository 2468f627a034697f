"""Two coordinated processes of the port (circom_tpu_torch/parallel/
multihost.py) on torch.distributed over gloo, on the CPU.

Spawned as subprocesses, as tests/test_multihost.py spawns the JAX
module's: each worker splits its own slice of the seeded global batch
over 4 shards, checks every lane against the host calculator, and
all-reduces the checker's all-ok verdict, the one collective.  The
artifact must say so, with the JAX module's keys.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def jax_artifact_keys():
    """The keys of the artifact the JAX module writes (its json.dump)."""
    tree = ast.parse((ROOT / "circom_tpu/parallel/multihost.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dump" and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dump of a dict in the JAX module")


def test_two_process_split_and_reduced_verdict(tmp_path):
    out = tmp_path / "mp.json"
    r = subprocess.run(
        [sys.executable, "-m", "circom_tpu_torch.parallel.multihost",
         "--spawn", "2", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, timeout=240, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    art = json.loads(out.read_text())
    assert set(art) == jax_artifact_keys()
    assert art["ok"] and art["checker_all_ok"]
    assert art["n_processes"] == 2 and art["global_devices"] == 8
    assert art["devices_per_process"] == 4
    assert art["parity"] == "exact"
    assert art["elements_checked_per_process"] * 2 == art["batch"] == 32
    assert art["platform"] == "cpu" and "gloo" in art["mechanism"]
