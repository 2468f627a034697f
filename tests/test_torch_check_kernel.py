"""Kernel KC (ops/cuda/check.cu), the R1CS check of one batch slice, on
the CPU.

- KC's matrices hold the checker's COO lists row for row: each row's
  entries decode (column, class, sign, coefficient words) to the same
  nonzeros, wide entries first, then small, then units, each by column.
- The plain route `first_violated_plain`, and the verdicts built from it,
  equal the JAX checker's check_detailed (jitted, on the CPU): verdicts
  and first-bad indices, on Poseidon2/bn128 lanes corrupted to fail at
  different constraints, a random system at goldilocks and at secq256r1
  (p just under R), the comparators (Num2Bits(64): a row of 64 terms), a
  batch over several slices, no rows, and empty matrices.
- check.cu built by g++ for the host (the launch replaced by a loop over
  the 2-D grid and the lanes, atomicMin by a plain minimum) and called
  through the checker's own argument list (`kc_args`) on CPU tensors
  gives the plain route's `first` on those inputs, with one row and
  several rows a block, and at L = 24 (the 381-bit base field of
  BLS12-381, no prime of the compiler).
- On any tensor not on the CPU the checker launches KC: it never takes
  the plain route there.

Every comparison is exact.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend import checker as checker_mod
from circom_tpu_torch.backend.checker import (KC_BLOCKS, KC_THREADS,
                                              R1CSChecker, kc_args,
                                              kc_rows_per_chunk)
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (comparator_inputs,
                                               comparators_source,
                                               poseidon2_source, random_r1cs)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import LIMB_BITS, FieldSpec, field_spec
from circom_tpu_torch.ops import build
from circom_tpu_torch.ops.limbs import limbs_to_int

ROOT = Path(__file__).resolve().parents[1]
# the base field of BLS12-381, 381 bits: 24 limbs
BLS12381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eab"
    "fffeb153ffffb9feffffffffaaab", 16)

# the CUDA names check.cu uses, for g++: a launch runs every block of the
# 2-D grid and every thread of a block in turn
SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int atomicMin(int* a, int v) {
  const int old = *a;
  if (v < old) *a = v;
  return old;
}
template <class K, class... A>
void host_launch(K kernel, dim3 grid, int threads, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (int th = 0; th < threads; ++th) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(th);
        kernel(args...);
      }
}
"""


@pytest.fixture(scope="module")
def kchost(tmp_path_factory):
    """check.cu built by g++, entry point ctpu_r1cs_check as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build check.cu for the host")
    src = (ROOT / "circom_tpu_torch/ops/cuda/check.cu").read_text()
    src, n = re.subn(r"(r1cs_check_kernel<L>)<<<grid, KC_THREADS, 0, "
                     r"s>>>\(a, fc\);",
                     r"host_launch(\1, grid, KC_THREADS, a, fc);", src)
    assert n == 1
    tmp = tmp_path_factory.mktemp("kchost")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "check_host.cpp").write_text(src)
    so = tmp / "check_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w", "-I",
         str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"), "-o",
         str(so), str(tmp / "check_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    res, args = build.SIGNATURES["check"]["ctpu_r1cs_check"]
    lib.ctpu_r1cs_check.restype = res
    lib.ctpu_r1cs_check.argtypes = args
    return lib


def as_tensor(z):
    return torch.from_numpy(np.ascontiguousarray(z).view(np.int32)) \
        .view(torch.uint32)


def circuit_case(src, prime, inputs, corrupt):
    """(rows, n_wires, spec, witnesses) of a compiled circuit run on the
    plain executor, with limb 0 of each (wire, lane) of `corrupt`
    flipped."""
    cc = compile_source(src, prime=prime)
    spec = field_spec(prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu")
    z = prog.run(torch.from_numpy(inputs.view(np.int32)).view(torch.uint32))
    z = z.view(torch.int32).numpy().view(np.uint32).copy()
    for wire, lane in corrupt:
        z[wire, 0, lane] ^= 1
    return cc.r1cs_rows(), cc.counts()["n_wires"], spec, z


def random_case(spec, corrupt, B=9, seed=3):
    rows, z = random_r1cs(spec, 6, 24, 5, B, seed)
    for wire, lane in corrupt:
        z[wire, 0, lane] ^= 1
    return rows, z.shape[0], spec, z


def empty_matrix_case():
    """Rows whose A and B are empty (Az Bz = 0: the row holds where its
    C value is 0) beside an ordinary row; lanes 1, 3 and 5 fail at rows
    0, 1 and 2, the others at none."""
    spec = field_spec("bn128")
    rows = [({}, {}, {1: 1}), ({0: 1}, {2: 1}, {3: 1}),
            ({}, {}, {4: 3, 1: spec.p - 1})]
    B = 6
    z = np.zeros((5, spec.n_limbs, B), np.uint32)
    z[0, 0] = 1
    z[2, 0] = z[3, 0] = [7, 7, 9, 9, 4, 4]
    z[1, 0, 1] = 3
    z[2, 0, 3] = 8
    z[4, 0, 5] = 2
    return rows, 5, spec, z


def poseidon2_inputs(B, seed):
    rng = np.random.default_rng(seed)
    L = 16
    top = field_spec("bn128").p >> (LIMB_BITS * (L - 1))
    x = rng.integers(0, 1 << 16, size=(2, L, B), dtype=np.uint32)
    x[:, L - 1] = rng.integers(0, top, size=(2, B), dtype=np.uint32)
    return x


@pytest.fixture(scope="module")
def cases():
    """name -> (rows, n_wires, spec, witnesses, lanes a slice); the
    corrupted lanes fail at the rows of FIRST."""
    out = {
        # lanes 0-1 good, lanes 2-7 corrupted at wires that fail different
        # constraints
        "poseidon2": (*circuit_case(
            poseidon2_source(), "bn128", poseidon2_inputs(8, 21),
            [(3, 2), (40, 3), (150, 4), (322, 5), (100, 6), (7, 7)]), 8192),
        "comparators": (*circuit_case(
            comparators_source(), "bn128", comparator_inputs(6, 12, 16),
            [(20, 1), (100, 3), (150, 4)]), 8192),
        "goldilocks": (*random_case(field_spec("goldilocks"),
                                    [(9, 2), (20, 5), (28, 6)]), 8192),
        "secq256r1": (*random_case(field_spec("secq256r1"),
                                   [(7, 1), (30, 8)]), 8192),
        "empty_matrix": (*empty_matrix_case(), 8192),
    }
    # the same Poseidon2 lanes in slices of 3: lanes 0-2, 3-5, 6-7
    out["slices"] = out["poseidon2"][:4] + (3,)
    return out


FIRST = {"poseidon2": [None, None, 241, 25, 107, 236, 70, 3],
         "comparators": [None, 205, None, 201, 204, None],
         "goldilocks": [None, None, 2, None, None, 13, 21, None, None],
         "secq256r1": [None, 0, None, None, None, None, None, None, 23],
         "empty_matrix": [None, 0, None, 1, None, 2]}
FIRST["slices"] = FIRST["poseidon2"]
CASES = ["poseidon2", "comparators", "goldilocks", "secq256r1",
         "empty_matrix", "slices"]


def jax_verdicts(rows, n_wires, spec, z):
    ok, first = jax.jit(JaxChecker(rows, n_wires, jax_field_spec(spec.name))
                        .check_detailed)(z)
    return np.asarray(ok), np.asarray(first)


@pytest.mark.parametrize("name", CASES)
def test_plain_route_matches_jax(cases, name):
    rows, n_wires, spec, z, lanes = cases[name]
    port = R1CSChecker(rows, n_wires, spec, device="cpu", lanes=lanes)
    ok_j, first_j = jax_verdicts(rows, n_wires, spec, z)
    ok, first_bad = port.check_detailed(as_tensor(z))
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    np.testing.assert_array_equal(first_bad.numpy(), first_j)
    first = port.first_violated_plain(as_tensor(z))
    assert first.dtype == torch.int32
    np.testing.assert_array_equal(first.numpy(),
                                  np.where(ok_j, len(rows), first_j))
    assert [None if o else int(f) for o, f in zip(ok_j, first_j)] == \
        FIRST[name]


def test_no_rows_match_jax():
    """A system with no rows (every constraint simplified away) passes
    every lane, first-bad 0, as in the JAX checker."""
    spec = field_spec("bn128")
    z = np.zeros((3, spec.n_limbs, 5), np.uint32)
    port = R1CSChecker([], 3, spec, device="cpu")
    ok, first_bad = port.check_detailed(as_tensor(z))
    ok_j, first_j = jax_verdicts([], 3, spec, z)
    assert ok.tolist() == ok_j.tolist() == [True] * 5
    assert first_bad.tolist() == first_j.tolist() == [0] * 5
    assert port.first_violated_plain(as_tensor(z)).tolist() == [0] * 5


@pytest.mark.parametrize("name", ["poseidon2", "comparators", "goldilocks",
                                  "empty_matrix"])
def test_csr_equals_coo(cases, name):
    rows, n_wires, spec, _z, _lanes = cases[name]
    port = R1CSChecker(rows, n_wires, spec, device="cpu")
    L, p = spec.n_limbs, spec.p
    N = L // 2
    R = 1 << (LIMB_BITS * L)
    unshift = pow(2, -32 * (N - 1), p)
    for (rws, cols, coef), (ptr, ent) in zip(port.coo, port.kc):
        assert ptr.dtype == torch.int32 and ent.dtype == torch.uint32
        assert ptr.shape == (len(rows) + 1,) and int(ptr[0]) == 0
        words = ent.view(torch.int32).numpy().view(np.uint32).tolist()
        assert int(ptr[-1]) == len(words)
        want = [limbs_to_int(c[:, 0]) * pow(R, -1, p) % p
                for c in coef.view(torch.int32).numpy().view(np.uint32)]
        for r in range(len(rows)):
            got, k = [], int(ptr[r])
            while k < int(ptr[r + 1]):
                e = words[k]
                col, cls, neg = e >> 3, (e >> 1) & 3, e & 1
                if cls == checker_mod.KC_WIDE:
                    m = sum(w << (32 * i) for i, w in
                            enumerate(words[k + 1:k + 1 + N])) * unshift % p
                    k += 1 + N
                elif cls == checker_mod.KC_SMALL:
                    m, k = words[k + 1], k + 2
                else:
                    m, k = 1, k + 1
                assert checker_mod.kc_class((p - m if neg else m) % p, p) \
                    == (cls, bool(neg), m)
                got.append((col, cls, (p - m if neg else m) % p))
            assert k == int(ptr[r + 1])
            # wide entries first, then small, then units, each by column
            assert got == sorted(got, key=lambda g: (-g[1], g[0]))
            sel = (rws == r).numpy()
            assert sorted((c, v) for c, _, v in got) == sorted(
                zip(cols.numpy()[sel].tolist(),
                    [w for w, s in zip(want, sel) if s]))


def host_first(lib, checker, z):
    zs = as_tensor(z)
    first = torch.full((zs.shape[-1],), checker.n_rows, dtype=torch.int32)
    rc = lib.ctpu_r1cs_check(*kc_args(checker, zs, first, None))
    assert rc == 0
    return first


@pytest.mark.parametrize("blocks", [KC_BLOCKS, 3])
@pytest.mark.parametrize("name", CASES)
def test_host_kc_matches_plain(kchost, cases, monkeypatch, name, blocks):
    """KC built by g++ equals the plain route on each slice: with one row
    a block (KC_BLOCKS at these few lanes) and with the rows cut into 3
    chunks of several rows."""
    monkeypatch.setattr(checker_mod, "KC_BLOCKS", blocks)
    rows, n_wires, spec, z, lanes = cases[name]
    port = R1CSChecker(rows, n_wires, spec, device="cpu", lanes=lanes)
    for s in range(0, z.shape[-1], lanes):
        zs = np.ascontiguousarray(z[..., s:s + lanes])
        np.testing.assert_array_equal(
            host_first(kchost, port, zs).numpy(),
            port.first_violated_plain(as_tensor(zs)).numpy())


def test_host_kc_at_24_limbs(kchost):
    """L = 24: a random system over the 381-bit base field of BLS12-381,
    good and corrupted lanes, against the plain route."""
    spec = FieldSpec("bls12381_base", BLS12381_Q)
    assert spec.n_limbs == 24
    rows, n_wires, spec, z = random_case(spec, [(8, 0), (25, 4), (29, 7)],
                                         B=10, seed=4)
    port = R1CSChecker(rows, n_wires, spec, device="cpu")
    want = port.first_violated_plain(as_tensor(z))
    assert want.tolist().count(len(rows)) == 7
    assert torch.equal(host_first(kchost, port, z), want)


def test_host_kc_refuses_other_limb_counts(kchost):
    """L outside 4, 16 and 24 returns an error without a launch."""
    rows, n_wires, spec, z, = random_case(field_spec("bn128"), [], B=2)
    port = R1CSChecker(rows, n_wires, spec, device="cpu")
    zs = as_tensor(z)
    first = torch.full((2,), 99, dtype=torch.int32)
    args = list(kc_args(port, zs, first, None))
    args[0] = 8
    assert kchost.ctpu_r1cs_check(*args) != 0
    assert first.tolist() == [99, 99]


@pytest.mark.parametrize("n_rows, b, want", [
    (320, 8192, 5),       # Poseidon2's slice: 64 lane blocks x 64 chunks
    (27552, 260, 21),     # SHA256's: 3 lane blocks x 1,312 chunks
    (10368, 8192, 162),   # MerkleInclusion(32)'s
    (3, 8192, 1),         # fewer rows than chunks: a row a block
    (5, 1 << 20, 5)])     # more lane blocks than KC_BLOCKS: one chunk
def test_rows_per_chunk(n_rows, b, want):
    r = kc_rows_per_chunk(n_rows, b)
    assert r == want
    lane_blocks = -(-b // KC_THREADS)
    chunks = -(-n_rows // r)
    assert chunks * r >= n_rows > (chunks - 1) * r
    assert chunks * lane_blocks <= max(KC_BLOCKS, lane_blocks) + lane_blocks


def test_off_the_cpu_it_launches_kc(cases, monkeypatch):
    """A slice on another device goes to KC through build.launch (the
    launch is recorded, not made), never to the plain route; a slice of
    the wrong shape raises before any launch."""
    rows, n_wires, spec, z, _lanes = cases["poseidon2"]
    port = R1CSChecker(rows, n_wires, spec, device="cpu").for_device("meta")
    calls = []
    monkeypatch.setattr(build, "library", lambda name: type(
        "Lib", (), {"ctpu_r1cs_check": f"{name}.ctpu_r1cs_check"}))
    monkeypatch.setattr(build, "launch",
                        lambda name, fn, dev, *a: calls.append((name, fn,
                                                                dev, a)))
    monkeypatch.setattr(build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(R1CSChecker, "first_violated_plain", None)
    zs = as_tensor(z).to("meta")
    first = port.first_violated(zs)
    assert [c[:3] for c in calls] == [
        ("r1cs_check", "check.ctpu_r1cs_check", torch.device("meta"))]
    assert first.shape == (8,) and first.dtype == torch.int32
    with pytest.raises(ValueError):
        port.first_violated(zs[:-1])
    with pytest.raises(ValueError):
        port.first_violated(zs[..., ::2])
    assert len(calls) == 1
