"""Build and load the port's CUDA kernels.

Each source under ops/cuda/ compiles on first use into its own shared
library with a plain C interface (`nvcc -shared`), loaded with ctypes; the
wrappers launch on PyTorch's current stream with the tensors' data
pointers.  Libraries are cached under a hash of the sources and flags in
the build directory of utils/cache.py (circom_tpu_torch/_build/ unless it
cannot be written), so a later process reuses them.  All sources build
in parallel, one nvcc each.  A failed build raises with nvcc's output.

`build_generated` does the same for a source written at run time (kernel
K4, ops/segment_gen.py): the text is saved beside its libraries, built
with the same flags against the headers of ops/cuda/, a library a segment
(-DK4_SEG=s, all in parallel), and cached under a hash of the text, the
headers and the flags; `build_all(generated=...)` builds such texts in
parallel with the fixed sources.

`launch` makes every launch: it calls a C entry point with the tensors'
device as the current device (a `<<<..., stream>>>` launch runs on the
calling thread's current device, whatever device the stream belongs
to), in the span `ctpu.launch` (utils/profiling.py), then counts it.
`LAUNCHES` counts kernel launches by name; each wrapper adds one,
through `launch`, where it launches its kernel, and nowhere else.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

from ..utils.cache import build_dir
from ..utils.profiling import span

SRC_DIR = Path(__file__).resolve().parent / "cuda"
SOURCES = ("field_ops", "interp", "gather", "check", "scan")
HEADERS = ("dot32.cuh", "field.cuh", "field32.cuh", "narrow.cuh",
           "wide.cuh", "wide32.cuh")
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
            _I, [_I, _I, _P, _PLL, _P, _PLL, _P, _LL, _LL, _PU32, _U32, _U32,
                 _P]),
    },
    "interp": {
        "ctpu_interp_k1": (
            _I, [_I, _LL, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I,
                 _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                 _PU32, _PU32, _U32, _PU32, _PU32, _PU32, _I, _I, _P]),
    },
    "gather": {
        "ctpu_gather_rows": (_I, [_P, _P, _P, _LL, _LL, _P]),
        "ctpu_gather_n": (_I, [_P, _LL, _P, _I, _P, _P, _P, _P, _LL, _LL,
                               _P]),
        "ctpu_assemble": (_I, [_I, _LL, _P, _LL, _P, _P, _P, _P, _PU32, _P,
                               _P]),
    },
    "check": {
        "ctpu_r1cs_check": (
            _I, [_I, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _LL, _PU32,
                 _U32, _P, _P]),
    },
    "scan": {
        "ctpu_scan": (
            _I, [_I, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _PU32, _U32, _I,
                 _I, _P]),
    },
}

_lock = threading.Lock()
_libs = {}
BUILD_LOG = {}   # name -> nvcc's output of the last build (ptxas usage)
BUILD_SECONDS = {}   # name -> nvcc's wall time of the last build


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


def _digest(text: bytes):
    """A hash of the flags, a source's text and the headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(text)
    for f in HEADERS:
        h.update((SRC_DIR / f).read_bytes())
    return h.hexdigest()[:16]


def source_flags(name):
    """nvcc flags of the fixed source `name` beyond NVCC_FLAGS: interp.cu
    takes the length of its narrow step groups from convert.K1B_GROUP."""
    if name != "interp":
        return ()
    from ..convert import K1B_GROUP

    return (f"-DCTPU_K1B_GROUP={K1B_GROUP}",)


def _target(name):
    digest = _digest((SRC_DIR / f"{name}.cu").read_bytes()
                     + " ".join(source_flags(name)).encode())
    return build_dir() / f"{name}-{digest}.so"


def generated_name(source):
    """The library name of a generated source."""
    return f"k4-{_digest(source.encode())}"


def _compile(jobs):
    """nvcc on every (name, source path, target, extra flags) at once, a
    thread waiting on each; each build's output and wall time land in
    BUILD_LOG and BUILD_SECONDS.  Raises RuntimeError with nvcc's output
    if a build fails."""
    nvcc = nvcc_path()

    def one(job):
        name, src, target, extra = job
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([nvcc, *NVCC_FLAGS, *extra, "-I", str(SRC_DIR),
                            "-o", str(tmp), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = r.stdout
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"nvcc failed on {src} (exit {r.returncode}):\n{r.stdout}"
        os.replace(tmp, target)
        return None

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        errors = [e for e in pool.map(one, jobs) if e]
    if errors:
        raise RuntimeError("\n".join(errors))


def segment_library(name, s):
    """The library of segment s of the generated source `name`."""
    return build_dir() / f"{name}-s{s}.so"


def _build(names, generated):
    """Compile the missing libraries of the fixed sources `names` and of
    the generated sources, (text, number of segments) pairs, a library a
    segment (-DK4_SEG=s), all in parallel; returns the seconds spent."""
    t0 = time.perf_counter()
    jobs = [(n, SRC_DIR / f"{n}.cu", _target(n), source_flags(n))
            for n in names if not _target(n).exists()]
    for text, n_segments in generated:
        name = generated_name(text)
        src = build_dir() / f"{name}.cu"
        todo = [s for s in range(n_segments)
                if not segment_library(name, s).exists()
                and f"{name}-s{s}" not in [j[0] for j in jobs]]
        if todo:
            src.write_text(text)
        jobs += [(f"{name}-s{s}", src, segment_library(name, s),
                  (f"-DK4_SEG={s}",)) for s in todo]
    if not jobs:
        return 0.0
    _compile(jobs)
    return time.perf_counter() - t0


def build_all(generated=()):
    """Compile every missing library in parallel, and with them the
    generated K4 sources given as (text, number of segments) pairs;
    returns the seconds spent.  Raises RuntimeError with nvcc's output
    if a build fails."""
    return _build(SOURCES, generated)


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


def build_generated(source, n_segments):
    """The entry points ctpu_k4_seg0 .. ctpu_k4_seg<n_segments - 1> of a
    generated K4 source, each (const uint32_t* x, uint32_t* w,
    uint32_t* c, long long B, void* stream) -> int (the inputs, the
    witness and the crossing buffer), as attributes of one namespace:
    built by nvcc on first use, a library a segment in parallel (build_all
    builds several sources at once), then cached on disk and in this
    process."""
    name = generated_name(source)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build((), [(source, n_segments)])
            lib = SimpleNamespace()
            for s in range(n_segments):
                fn = getattr(ctypes.CDLL(str(segment_library(name, s))),
                             f"ctpu_k4_seg{s}")
                fn.restype = _I
                fn.argtypes = [_P, _P, _P, _LL, _P]
                setattr(lib, f"ctpu_k4_seg{s}", fn)
            _libs[name] = lib
        return lib


def check_launch(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def launch(name, fn, device, *args, parts=None):
    """fn(*args), a C entry point that launches kernel `name` on a stream
    of `device`, called with `device` as the current device; adds one to
    LAUNCHES[name], or to each of `parts` (the parts of one kernel that
    the launch runs), and raises RuntimeError if the launch failed."""
    import torch

    with torch.cuda.device(device):
        with span("ctpu.launch"):
            rc = fn(*args)
    for part in parts or (name,):
        LAUNCHES[part] += 1
    check_launch(rc, name)


def stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def u32_array(values):
    return (ctypes.c_uint32 * len(values))(*[int(v) for v in values])


def ll_array(values):
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
