"""Where the port's built kernels go.

The JAX package wires XLA's persistent compilation cache here
(`circom_tpu/utils/cache.py`).  The port has no XLA: what it builds once
and reuses are its kernel libraries (`ops/build.py`: one nvcc a CUDA
source, a library a generated K4 segment; `native/`: the g++ build of
tapeval.cpp), each named by a hash of its sources and flags.  This module
chooses the directory they go to:

1. circom_tpu_torch/_build/ in the checkout, the default;
2. if that directory cannot be created or written, a per-user directory,
   ~/.cache/circom_tpu_torch/build;
3. if that fails too, a fresh temporary directory (nothing is reused
   across processes then).

Each fallback prints one line on stderr.  This is the JAX module's degrade
rule: an unwritable cache directory costs build time, never the run.
"""

import sys
import tempfile
import threading
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"
USER_DIR = Path.home() / ".cache" / "circom_tpu_torch" / "build"

_chosen = None
_choosing = threading.Lock()


def _writable(d: Path):
    """None if `d` can be created and a file written in it, else the
    OSError that says why not."""
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=d):
            pass
    except OSError as e:
        return e
    return None


def choose_dir(default=DEFAULT_DIR, user=USER_DIR) -> Path:
    """The first of `default`, `user` and a fresh temporary directory that
    can be written, one line on stderr for each that was passed over."""
    for d, then in ((Path(default), "the per-user directory"),
                    (Path(user), "a temporary directory")):
        err = _writable(d)
        if err is None:
            return d
        print(f"circom_tpu_torch: build directory {d} is not writable "
              f"({err.__class__.__name__}: {err}); using {then}",
              file=sys.stderr)
    return Path(tempfile.mkdtemp(prefix="circom_tpu_torch_build_"))


def build_dir() -> Path:
    """The build directory of this process, chosen on first use; one
    directory a process, also when threads build at once."""
    global _chosen
    with _choosing:
        if _chosen is None:
            _chosen = choose_dir()
    return _chosen
