"""Circuits built once a test run, shared by the port's test files.

Compiling, taping and planning SHA256 takes ~25 s on a quiet core and
several times that under six pytest-xdist workers, and several files
need it.  With `--dist loadfile` each file runs in one worker, so a
module's own cache still builds a circuit once a file.  `circuit` and
`program` build it once a run: the first caller builds it and writes it,
pickled, into a directory of this run, under a lock, by os.replace; every
other caller, in any worker, waits for the lock and reads it.  The
directory is named by PYTEST_XDIST_TESTRUNUID (new in every run), or is
private to the process without xdist, so nothing carries over from one
run to the next.  Keys are the package (the port, "port", or the JAX
package, "jax"), the `--prime` field, the source text and the program's
options.  Programs are built on the CPU only.

Under pytest-xdist this module also caps each worker's PyTorch threads
at its share of the cores: the plain kernels run many small tensor
operations, and six workers of as many threads as the machine has cores
each wait on one another: MerkleInclusion(2) at each of the eight fields
took 43 s a case so and 12 s with one thread a worker (8 cores).

The tests below hold a program read back from the cache equal to one
built afresh.
"""

import atexit
import fcntl
import hashlib
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
STALE_S = 6 * 3600      # older run directories are removed

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _workers))

_memo = {}
_dir = []


def sha256_source(package="circom_tpu_torch"):
    """circuits/sha256.circom of a package with Sha256Block as main."""
    return (ROOT / package / "circuits/sha256.circom").read_text() \
        + "\ncomponent main = Sha256Block();\n"


def run_dir():
    """This run's directory, made at the first call."""
    if not _dir:
        base = Path(tempfile.gettempdir())
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        for old in base.glob("circom_tpu_torch_tests_*"):
            try:
                if time.time() - old.stat().st_mtime > STALE_S:
                    shutil.rmtree(old, ignore_errors=True)
            except FileNotFoundError:
                pass
        if uid:
            d = base / f"circom_tpu_torch_tests_{uid}"
            d.mkdir(exist_ok=True)
        else:
            d = Path(tempfile.mkdtemp(prefix="circom_tpu_torch_tests_"))
            atexit.register(shutil.rmtree, d, True)
        _dir.append(d)
    return _dir[0]


def _tensor(a):
    return torch.from_numpy(a)


class _Pickler(pickle.Pickler):
    """Pickles CPU tensors as numpy arrays (PyTorch's own reduction cannot
    load uint32 tensors back)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.device.type != "cpu":
                raise ValueError("only CPU programs are cached")
            return _tensor, (obj.detach().numpy().copy(),)
        return NotImplemented


def key_of(*parts):
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:32]


def cached(key, build):
    """build() once a run: from this process's memo, else from the run's
    directory, else built here and written there."""
    if key in _memo:
        return _memo[key]
    path = run_dir() / f"{key}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                obj = pickle.load(f)
        else:
            obj = build()
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
            os.replace(tmp, path)
    _memo[key] = obj
    return obj


def circuit(src, prime="bn128", package="port"):
    """(compiled circuit, tape) of src at a field, by the port's compiler
    (package "port") or the JAX package's ("jax")."""
    def build():
        if package == "port":
            from circom_tpu_torch.compiler.pipeline import compile_source
        elif package == "jax":
            from circom_tpu.compiler.pipeline import compile_source
        else:
            raise ValueError(f"no package {package!r}")
        cc = compile_source(src, prime=prime)
        return cc, cc.build_tape()[0]
    return cached(key_of("circuit", package, prime, src), build)


def program(src, prime="bn128", **options):
    """(compiled circuit, tape, WitnessProgram on the CPU) of src at a
    field, the port's, planned with the circuit's range hints and
    `options` (mode, unroll_threshold, ...)."""
    from circom_tpu_torch.backend.torch_backend import WitnessProgram
    from circom_tpu_torch.field.primes import field_spec

    cc, tape = circuit(src, prime)

    def build():
        return WitnessProgram(tape, field_spec(prime), device="cpu",
                              input_ranges=cc.input_range_hints(), **options)
    prog = cached(key_of("program", prime, src, sorted(options.items())),
                  build)
    return cc, tape, prog


# -- the cache itself ---------------------------------------------------------

def _reload(key):
    """The entry `key` read back from the run's directory."""
    _memo.pop(key)
    with open(run_dir() / f"{key}.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def poseidon2():
    from circom_tpu_torch.circuits.sources import poseidon2_source
    return poseidon2_source("bn128")


@pytest.mark.parametrize("mode", ["auto", "scan"])
def test_program_read_back_equals_a_fresh_build(poseidon2, mode):
    """A program read back from the run's directory has the plan, the
    constants and the witness of one built afresh; so has its circuit."""
    from circom_tpu_torch.backend.torch_backend import WitnessProgram
    from circom_tpu_torch.compiler.pipeline import compile_source
    from circom_tpu_torch.field.primes import field_spec

    spec = field_spec("bn128")
    program(poseidon2, "bn128", mode=mode, unroll_threshold=0)
    prog = _reload(key_of("program", "bn128", poseidon2,
                          sorted({"mode": mode,
                                  "unroll_threshold": 0}.items())))
    cc, tape = _reload(key_of("circuit", "port", "bn128", poseidon2))
    fresh_cc = compile_source(poseidon2)
    fresh = WitnessProgram(fresh_cc.build_tape()[0], spec, device="cpu",
                           mode=mode, unroll_threshold=0)
    assert (prog.interp is None) == (mode == "scan")
    if prog.interp is not None:
        got, want = prog.plan.plan_arrays(), fresh.plan.plan_arrays()
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k], dtype=object),
                                  np.asarray(want[k], dtype=object)), k
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, size=(2, 16, 5), dtype=np.uint32)
    x[:, 15] = 0
    assert torch.equal(prog.run(x).view(torch.int32),
                       fresh.run(x).view(torch.int32))
    assert cc.r1cs_rows() == fresh_cc.r1cs_rows()
    assert list(cc.witness_host({"inputs": [3, 4]})) == \
        list(fresh_cc.witness_host({"inputs": [3, 4]}))
    assert tape.n_inputs == 2
    assert len(tape.ops) == len(fresh_cc.build_tape()[0].ops)


def test_jax_circuit_read_back_equals_a_fresh_compile(poseidon2):
    """The JAX package's compile, read back, gives its host witness and
    constraints."""
    from circom_tpu.compiler.pipeline import compile_source as jax_compile

    circuit(poseidon2, "goldilocks", package="jax")
    cc, tape = _reload(key_of("circuit", "jax", "goldilocks", poseidon2))
    fresh = jax_compile(poseidon2, prime="goldilocks")
    assert cc.r1cs_rows() == fresh.r1cs_rows()
    assert list(cc.witness_host({"inputs": [5, 6]})) == \
        list(fresh.witness_host({"inputs": [5, 6]}))
    assert tape.n_inputs == fresh.build_tape()[0].n_inputs


def test_keys_name_package_prime_source_and_options(poseidon2):
    keys = {key_of("circuit", "port", "bn128", poseidon2),
            key_of("circuit", "jax", "bn128", poseidon2),
            key_of("circuit", "port", "goldilocks", poseidon2),
            key_of("circuit", "port", "bn128", poseidon2 + " "),
            key_of("program", "bn128", poseidon2, []),
            key_of("program", "bn128", poseidon2, [("mode", "interp")])}
    assert len(keys) == 6
    with pytest.raises(ValueError):
        _Pickler(open(os.devnull, "wb")).dump(
            torch.zeros(1, device="meta"))
