"""Build and load the port's CUDA kernels.

Each source under ops/cuda/ compiles on first use into its own shared
library with a plain C interface (`nvcc -shared`), loaded with ctypes; the
wrappers launch on PyTorch's current stream with the tensors' data
pointers.  Libraries are cached in circom_tpu_torch/_build/ under a hash of
the sources and flags, so a later process reuses them.  All sources build
in parallel, one nvcc each.  A failed build raises with nvcc's output.

`LAUNCHES` counts kernel launches by name; each wrapper adds one where it
launches its kernel, and nowhere else.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "cuda"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("field_ops", "interp", "gather")
HEADERS = ("field.cuh", "narrow.cuh", "wide.cuh")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U32 = ctypes.c_uint32
_PLL = ctypes.POINTER(ctypes.c_longlong)
_PU32 = ctypes.POINTER(ctypes.c_uint32)

# C entry points of each library: (restype, argtypes)
SIGNATURES = {
    "field_ops": {
        "ctpu_field_elementwise": (
            _I, [_I, _I, _P, _PLL, _P, _PLL, _P, _LL, _LL, _PU32, _U32, _P]),
    },
    "interp": {
        "ctpu_interp_k1": (
            _I, [_I, _LL, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                 _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _PU32, _PU32,
                 _U32, _PU32, _PU32, _PU32, _I, _I, _P]),
    },
    "gather": {
        "ctpu_gather_rows": (_I, [_P, _P, _P, _LL, _LL, _P]),
        "ctpu_gather_n": (_I, [_P, _LL, _P, _P, _P, _P, _LL, _LL, _P]),
    },
}

_lock = threading.Lock()
_libs = {}
BUILD_LOG = {}   # name -> nvcc's output of the last build (ptxas usage)


def reset_launches():
    LAUNCHES.clear()


def nvcc_path():
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME)")
    return found


def _target(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((SRC_DIR / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all():
    """Compile every missing library in parallel; returns the seconds
    spent.  Raises RuntimeError with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name):
    """The loaded ctypes library of one source, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (res, args) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _libs[name] = lib
        return lib


def check_launch(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def u32_array(values):
    return (ctypes.c_uint32 * len(values))(*[int(v) for v in values])


def ll_array(values):
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
