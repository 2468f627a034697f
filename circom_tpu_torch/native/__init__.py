"""Native (C++) witness runtime: builds and binds tapeval.cpp via ctypes.

The port of the JAX package's `circom_tpu/native`: the domain-resolved
tape is evaluated with 4x64-limb Montgomery arithmetic, OpenMP-parallel
over the witness batch, on the host CPU.  It mirrors the reference's
compiled C++ witness calculator (code_producers/src/c_elements) and is
the port's CPU baseline and an independent cross-check of the card's
witnesses.  Fields up to 256 bits (all 8 supported primes).

tapeval.cpp is a verbatim copy of the JAX package's.  It is built with
g++ at first use into the build directory of utils/cache.py, named by a
hash of the source, the flags and the host CPU's model (-march=native).
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..backend.domain import DomainTape
from ..field.primes import FieldSpec
from ..utils.cache import build_dir

_OPS = [
    "const", "input", "add", "sub", "mul", "div", "neg",
    "lt", "le", "gt", "ge", "eq", "neq",
    "land", "lor", "lnot", "band", "bor", "bxor", "bnot",
    "shl_k", "shr_k", "pow_k", "select", "to_mont", "from_mont",
    "idiv", "mod", "mulp",
]
_OP_ID = {o: i for i, o in enumerate(_OPS)}

SRC = Path(__file__).resolve().parent / "tapeval.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-march=native")

_LIB = None
_lock = threading.Lock()


def cpu_model():
    """The host CPU's model name, or where the host hides it (a virtual
    machine may report "unknown"), its vendor, family and model numbers:
    -march=native builds for this CPU, so a checkout shared between hosts
    keeps one library for each."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break             # the first processor's fields
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return platform.processor() or platform.machine()


def library_path():
    """Where the built library goes: the build directory, under a hash of
    the source, the flags and the host CPU's model."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(cpu_model().encode())
    return build_dir() / f"libtapeval-{h.hexdigest()[:16]}.so"


def build():
    """Build the library if it is missing; returns the seconds g++ took
    (0.0 when it was found built).  Raises RuntimeError with g++'s
    output if the build fails."""
    so = library_path()
    if so.exists():
        return 0.0
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC} (exit {r.returncode}):\n"
                           f"{r.stdout}")
    tmp.replace(so)
    return time.perf_counter() - t0


def _build_lib():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.tv_create.restype = ctypes.c_void_p
        lib.tv_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.tv_destroy.argtypes = [ctypes.c_void_p]
        lib.tv_run_batch.restype = ctypes.c_int
        lib.tv_run_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
        return lib


def _to_u64(x: int) -> np.ndarray:
    out = np.empty(4, np.uint64)
    for i in range(4):
        out[i] = x & 0xFFFFFFFFFFFFFFFF
        x >>= 64
    assert x == 0
    return out


def _from_u64(arr) -> int:
    x = 0
    for i in range(3, -1, -1):
        x = (x << 64) | int(arr[i])
    return x


class NativeCalculator:
    """Evaluates a witness tape natively (host CPU, OpenMP batch)."""

    MONT = 0

    def __init__(self, tape, spec: FieldSpec, input_ranges=None):
        if spec.bits > 256:
            raise ValueError("native runtime supports primes up to 256 bits")
        self.spec = spec
        self.p = spec.p
        lib = _build_lib()
        # narrow int64 fast path (the reference FrElement's short-value
        # representation, fr.hpp:12-26, classified at compile time by
        # the same range analysis the card's narrow lane uses)
        from ..backend.dynops import lower_dynamic_ops
        from ..backend.ranges import narrow_nodes

        # dynamic pow/shl/shr/mod lower to primitive ops exactly as on
        # the card's path (tapeval keeps idiv native)
        tape = lower_dynamic_ops(tape)
        nset, _ = narrow_nodes(tape, input_ranges or {})
        dt = DomainTape(tape, narrow=nset)
        n = len(dt.ops)
        R = 1 << 256
        op = np.zeros(n, np.int32)
        a = np.zeros(n, np.int32)
        b = np.zeros(n, np.int32)
        c = np.zeros(n, np.int32)
        imm = np.zeros(n, np.int64)
        nres = np.zeros(n, np.uint8)
        na = np.zeros(n, np.uint8)
        nb = np.zeros(n, np.uint8)
        nc = np.zeros(n, np.uint8)
        consts = []
        self.n_inputs = dt.n_inputs
        for i in range(n):
            opname = dt.ops[i]
            op[i] = _OP_ID[opname]
            nres[i] = bool(dt.narrow[i])
            args = dt.args[i]
            if len(args) > 0:
                a[i] = args[0]
                na[i] = bool(dt.narrow[args[0]])
            if len(args) > 1:
                b[i] = args[1]
                nb[i] = bool(dt.narrow[args[1]])
            if len(args) > 2:
                c[i] = args[2]
                nc[i] = bool(dt.narrow[args[2]])
            if opname == "const":
                v = dt.imms[i]
                if dt.domains[i] == self.MONT:
                    v = (v * R) % self.p
                imm[i] = len(consts)
                consts.append(v)
            elif dt.imms[i] is not None:
                imm[i] = dt.imms[i]
        carr = np.zeros((max(len(consts), 1), 4), np.uint64)
        for j, v in enumerate(consts):
            carr[j] = _to_u64(v)
        outputs = np.asarray(dt.outputs, np.int32)
        self.n_outputs = len(outputs)

        p_l = _to_u64(self.p)
        r2 = _to_u64((R * R) % self.p)
        one_m = _to_u64(R % self.p)
        half = _to_u64(spec.half)
        mask = _to_u64(spec.mask)
        n0inv = (-pow(self.p, -1, 1 << 64)) % (1 << 64)
        self._keepalive = (op, a, b, c, imm, carr, outputs,
                           nres, na, nb, nc)
        self._lib = lib
        self._h = lib.tv_create(
            p_l.ctypes.data, r2.ctypes.data, one_m.ctypes.data,
            half.ctypes.data, mask.ctypes.data,
            ctypes.c_uint64(n0inv), spec.bits,
            n, op.ctypes.data, a.ctypes.data, b.ctypes.data, c.ctypes.data,
            imm.ctypes.data, len(consts) or 1, carr.ctypes.data,
            dt.n_inputs, len(outputs), outputs.ctypes.data,
            nres.ctypes.data, na.ctypes.data, nb.ctypes.data,
            nc.ctypes.data,
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tv_destroy(self._h)
            self._h = None

    def run_raw(self, inp):
        """inp: uint64 (batch, n_inputs, 4) canonical limbs ->
        uint64 (batch, n_outputs, 4).  The native-speed entry point —
        the reference's calculator writes witness limb bytes the same
        way (main.cpp writeBinWitness); Python int conversion is a
        separate (slow) convenience."""
        batch = inp.shape[0]
        inp = np.ascontiguousarray(inp, np.uint64)
        out = np.zeros((batch, self.n_outputs, 4), np.uint64)
        rc = self._lib.tv_run_batch(
            self._h, batch, inp.ctypes.data, out.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"native witness evaluation failed (rc={rc})")
        return out

    def encode_rows(self, input_rows):
        batch = len(input_rows)
        inp = np.zeros((batch, self.n_inputs, 4), np.uint64)
        for w, row in enumerate(input_rows):
            assert len(row) == self.n_inputs
            for i, v in enumerate(row):
                inp[w, i] = _to_u64(v % self.p)
        return inp

    def run(self, input_rows):
        """input_rows: list (batch) of lists (n_inputs) of ints ->
        list (batch) of witness lists."""
        out = self.run_raw(self.encode_rows(input_rows))
        return [
            [_from_u64(out[w, k]) for k in range(self.n_outputs)]
            for w in range(out.shape[0])
        ]
