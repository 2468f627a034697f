"""A configuration's compiled circuit and planned programs, built once a
checkout.

Compiling and planning take seconds (SHA256 of two blocks: ~26 s of
compile and tape and ~27 s of plan on a host core), and every run of a
cell would pay them again.  So the first run builds, on the CPU, what a
run needs (the WitnessProgram, the R1CSChecker, the input count, the
roofline's counts from the tape and the R1CS, each witness row's signal
name) and pickles it into a fixed directory of the checkout,
witbench/.cache/programs/, under a key of the circuit's text, the prime,
the program's options and the text of every source file of the port.  A
later run of the same checkout reads it back; a change to the compiler,
the planner or a kernel source makes a new key, and its first run builds
afresh.  Reading back runs no code but this benchmark's own pickles
(tensors travel as numpy arrays: PyTorch cannot load uint32 tensors back).
"""

import fcntl
import hashlib
import os
import pickle
from pathlib import Path

import torch

from . import roofline, wires

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "circom_tpu_torch"
CACHE = Path(__file__).resolve().parent / ".cache" / "programs"


def port_digest():
    """A hash of every source file of the port (not its build directory
    or byte code), in path order."""
    h = hashlib.sha256()
    for f in sorted(PORT.rglob("*")):
        rel = f.relative_to(PORT)
        if f.is_file() and rel.parts[0] != "_build" \
                and "__pycache__" not in rel.parts:
            h.update(str(rel).encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()


def key_of(source, prime, options):
    h = hashlib.sha256(repr((source, prime, sorted(options.items()))).encode())
    h.update(port_digest().encode())
    return h.hexdigest()[:32]


def _tensor(a):
    return torch.from_numpy(a)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.device.type != "cpu":
                raise ValueError("only CPU programs are cached")
            return _tensor, (obj.detach().numpy().copy(),)
        return NotImplemented


def build(source, prime, options):
    """Compile and plan on the CPU: {"program", "checker", "n_inputs",
    "counts", "wire_names"} (each witness row's signal name, from the
    compiler's symbol table)."""
    from circom_tpu_torch.backend.checker import R1CSChecker
    from circom_tpu_torch.backend.torch_backend import WitnessProgram
    from circom_tpu_torch.compiler.pipeline import compile_source
    from circom_tpu_torch.field.primes import field_spec

    spec = field_spec(prime)
    cc = compile_source(source, prime=prime)
    tape = cc.build_tape()[0]
    rows = cc.r1cs_rows()
    hints = cc.input_range_hints()
    n_wires = cc.counts()["n_wires"]
    prog = WitnessProgram(tape, spec, device="cpu", input_ranges=hints,
                          **options)
    checker = R1CSChecker(rows, n_wires, spec, device="cpu")
    return {"program": prog, "checker": checker, "n_inputs": tape.n_inputs,
            "counts": roofline.circuit_counts(tape, rows, spec.p, hints),
            "wire_names": wires.wire_names(cc.sym_lines(), n_wires)}


def load(source, prime, options, cache=CACHE):
    """build()'s result, from the cache when a run of this checkout made
    it, else built and written there (under a lock, by os.replace).
    Returns (result, whether it was read back)."""
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"{key_of(source, prime, options)}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f), True
        obj = build(source, prime, options)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
        os.replace(tmp, path)
    return obj, False
