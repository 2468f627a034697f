"""The port stands alone: no JAX, nothing of circom_tpu and not the JAX
package's benchmark (bench.py), anywhere in it.

An AST walk over every module of circom_tpu_torch/, chip_smoke.py and
bench_gpu.py finds no import of `jax`, of `circom_tpu` or of `bench`; a
fresh interpreter that imports the port's modules has none of them in
sys.modules.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "circom_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "bench_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "circom_tpu", "bench")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_no_forbidden_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import circom_tpu_torch\n"
            "import circom_tpu_torch.witness\n"
            "import circom_tpu_torch.cli\n"
            "import circom_tpu_torch.native\n"
            "import circom_tpu_torch.utils.cache\n"
            "import circom_tpu_torch.utils.profiling\n"
            "import circom_tpu_torch.backend.torch_backend\n"
            "import circom_tpu_torch.backend.checker\n"
            "import circom_tpu_torch.ops.build\n"
            "import circom_tpu_torch.circuits.sha256_io\n"
            "import circom_tpu_torch.entry\n"
            "import circom_tpu_torch.parallel.mesh\n"
            "import circom_tpu_torch.parallel.multihost\n"
            "import circom_tpu_torch.utils.roofline\n"
            "import bench_gpu\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'circom_tpu', 'bench'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
