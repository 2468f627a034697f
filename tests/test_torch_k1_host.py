"""Kernel K1 (ops/cuda/interp.cu) built by g++ for the host, and the plan
rules its design rests on, on the CPU.

- interp.cu compiled by g++ with the CUDA qualifiers defined away and its
  launch replaced by a loop over the lanes, called through the port's own
  argument list (backend/interp.k1_args) on CPU tensors: every emitted row
  of both banks equals the plain executor's (interp_ref.run_plan), and
  K1 writes nothing beyond its wide file of L/2 words a register a lane
  (backend/interp.k1_file_shape), on the plans of Poseidon2 over bn128
  and goldilocks (one 64-bit word a register), SHA256, bigint-div, the
  stdlib comparators, the unit plans of every K1b, K1c and K1d opcode, a
  plan whose constants are overwritten and a run that K1 reads in groups
  of steps; and Poseidon2 at bls12381 and secq256r1 and
  MerkleInclusion(2) at secq256r1, whose lazy dots take two and three
  subtracts of p there (the count K1's launch computes from p).
- Dump rows are nobody's output: on each of those plans no witness
  gather (wd_src, nw_src) and no trailing-REDC flag (mont_tab) names a
  chunk's dump row, so K1 need not store it; `emitted_rows` is
  `written_rows` without them.
- The groups of narrow steps (DevicePlan.grp) read nothing an earlier
  step of their group writes, and are cut only where they must be.

Comparisons are exact.
"""

import ctypes
import os
import random
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch.backend.interp import (k1_args, k1_file_shape,
                                             split_inputs)
from circom_tpu_torch.backend.interp_plan import (_NARROW_RESULT,
                                                  _OPERAND_FILES)
from circom_tpu_torch.backend.interp_ref import run_plan
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                               comparator_inputs,
                                               comparators_source,
                                               merkle_source,
                                               poseidon2_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import (K1B_GROUP, K1B_OPCODES, K1C_OPCODES,
                                      K1D_OPCODES, N_OPERANDS, OPCODES,
                                      input_rows, narrow_unit_arrays,
                                      plan_from_arrays, unit_arrays,
                                      unit_inputs)
from circom_tpu_torch.field.primes import LIMB_BITS, field_spec
from circom_tpu_torch.ops import build
from circom_tpu_torch.ops.field import TorchField, as_i64
import test_torch_shared as shared

ROOT = Path(__file__).resolve().parents[1]
B = 8

# the CUDA names interp.cu uses, for g++; a launch runs the kernel once a
# lane, in order
SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct Dim3Shim { unsigned x; };
static Dim3Shim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class K, class... A>
void host_launch(K kernel, unsigned blocks, int threads, A... args) {
  blockDim.x = threads;
  for (unsigned bl = 0; bl < blocks; ++bl)
    for (int th = 0; th < threads; ++th) {
      blockIdx.x = bl;
      threadIdx.x = th;
      kernel(args...);
    }
}
"""


@pytest.fixture(scope="module")
def k1host(tmp_path_factory):
    """interp.cu built by g++, entry point ctpu_interp_k1 as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build interp.cu for the host")
    src = (ROOT / "circom_tpu_torch/ops/cuda/interp.cu").read_text()
    src, n = re.subn(r"(interp_k1_kernel<L, FULL, SUBS>)<<<blocks, THREADS, "
                     r"0, s>>>\(a, kc\);",
                     r"host_launch(\1, blocks, THREADS, a, kc);", src)
    assert n == 1
    tmp = tmp_path_factory.mktemp("k1host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "interp_host.cpp").write_text(src)
    so = tmp / "interp_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
         *build.source_flags("interp"), "-I", str(tmp),
         "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp / "interp_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    res, args = build.SIGNATURES["interp"]["ctpu_interp_k1"]
    lib.ctpu_interp_k1.restype = res
    lib.ctpu_interp_k1.argtypes = args
    return lib


def canonical(rng, spec, shape):
    L = spec.n_limbs
    top = spec.p >> (LIMB_BITS * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return x


def overwrite_arrays(L):
    """Plan arrays of a narrow plan whose constants are read before and
    after a step overwrites them, over two chunks: narrow input a in
    register 0, constants 5 and -7 in registers 1 and 2, then
      chunk 0:  t0 r3 = a + r1      (constant 0)
                t1 r1 = a           (overwrites r1; emitted to the dump row)
                t2 r3 = r1 + r2     (r1 overwritten, r2 constant 1)
      chunk 1:  t3 r2 = r2 * r2     (constant 1, then overwrites r2)
                t4 r4 = r2 ^ r1     (both overwritten)
    """
    ops = ["nadd", "ncopy", "nadd", "nmul", "nbxor"]
    opset = sorted(set(ops))
    rows = [(0, 1, 0, 3, 0, 0), (0, 0, 0, 1, 3, 0), (1, 2, 0, 3, 1, 0),
            (2, 2, 0, 2, 0, 0), (2, 1, 0, 4, 1, 0)]
    table = np.asarray([(opset.index(op), *r) for op, r in zip(ops, rows)],
                       np.int32)
    arrays = {
        "table": table, "r_op": table[:, 0].copy(),
        "r_s0": np.arange(6, dtype=np.int32),
        "rstarts": np.asarray([0, 3, 5], np.int32),
        "cbank": np.zeros((1, L), np.int32),
        "mont_tab": np.zeros(2, np.int32), "mat_loads": [],
        "nmat_loads": [(1, 5), (2, -7)],
        "wit_src": [("emitn", 0, 0), ("emitn", 0, 1), ("emitn", 1, 0),
                    ("emitn", 1, 1)],
        "win_of": {}, "nin_of": {0: 0}, "K": 0, "KN": 3, "n_regs": 1,
        "n_nregs": 6, "n_chunks": 2, "calls": [(0, 2, 0, 5)],
        "opset_n": opset, "opset_w": [],
    }
    return arrays


def groups_arrays(L):
    """Plan arrays of one run of 15 nadd steps over narrow inputs a, b
    (registers 0, 1) that the kernel reads in groups, and the group
    lengths it must have:
      t0 r2 = a + b,   t1 r3 = a + a (dump row),   t2 r0 = b + b
                                 (rewrites a, which t0 and t1 read)
      t3 r4 = r2 + r3  (reads t0's result: a new group)
      t4 r4 = r0 + b   (rewrites r4 after t3, reads t2's r0)
      t5 r5 = r4 + r4  (a new group), then t6-t12 read r0, r1 and r4 only
      t13 r13 = r5 + r6, t14 r14 = r13 + r0 (each a new group)."""
    pairs = [(0, 1, 2), (0, 0, 3), (1, 1, 0), (2, 3, 4), (0, 1, 4),
             (4, 4, 5), (0, 1, 6), (1, 4, 7), (0, 0, 8), (4, 1, 9),
             (0, 4, 10), (1, 1, 11), (4, 4, 12), (5, 6, 13), (13, 0, 14)]
    KN = len(pairs)
    table = np.asarray([(0, ia, ib, 0, dst, KN if t == 1 else t, 0)
                        for t, (ia, ib, dst) in enumerate(pairs)], np.int32)
    arrays = {
        "table": table, "r_op": np.zeros(1, np.int32),
        "r_s0": np.asarray([0, KN], np.int32),
        "rstarts": np.asarray([0, 1], np.int32),
        "cbank": np.zeros((1, L), np.int32),
        "mont_tab": np.zeros(1, np.int32), "mat_loads": [], "nmat_loads": [],
        "wit_src": [("emitn", 0, t) for t in range(KN) if t != 1],
        "win_of": {}, "nin_of": {0: 0, 1: 1}, "K": 0, "KN": KN,
        "n_regs": 1, "n_nregs": 16, "n_chunks": 1, "calls": [(0, 1, 0, KN)],
        "opset_n": ["nadd"], "opset_w": [],
    }
    grp = np.ones(KN, np.int32)
    grp[[0, 3, 5]] = (3, 2, 8)
    return arrays, grp


def _program(src, prime):
    cc = compile_source(src, prime=prime)
    return WitnessProgram(cc.build_tape()[0], field_spec(prime),
                          device="cpu", input_ranges=cc.input_range_hints())


@lru_cache(maxsize=None)
def case(name):
    """(plan, field, input rows uint32 (n_inputs, L, B)) of one plan, on
    the CPU."""
    rng = np.random.default_rng(71)
    if name.startswith("unit-"):
        prime = name[len("unit-"):]
        spec = field_spec(prime)
        ops = K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks"
                             else ("add",))
        plan = plan_from_arrays(unit_arrays(spec.p, spec.n_limbs, ops)[0],
                                "cpu")
        x = input_rows(plan, *unit_inputs(spec.p, spec.n_limbs, 400, 72))
        return plan, TorchField(spec), u32_tensor(x)
    if name in ("narrow-unit", "overwrite", "groups"):
        arrays = {"narrow-unit": narrow_unit_arrays(16)[0],
                  "overwrite": overwrite_arrays(16),
                  "groups": groups_arrays(16)[0]}[name]
        plan = plan_from_arrays(arrays, "cpu")
        x_n = rng.integers(-2 ** 31, 2 ** 31, size=(len(plan.nin_order), B))
        x_n[:, :4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
        x = input_rows(plan, np.zeros((0, 16, B), np.uint32), x_n)
        return plan, TorchField(field_spec("bn128")), u32_tensor(x)
    if name == "sha256":
        prog = shared.program(shared.sha256_source())[2]
        r = random.Random(73)
        msgs = [bytes(r.randrange(256) for _ in range(32)) for _ in range(B)]
        x = sha256_io.input_rows(msgs)
    else:
        prime = name.split("-")[1] if "-" in name else "bn128"
        src = (poseidon2_source(prime) if name.startswith("poseidon2-")
               else merkle_source(2) if name.startswith("merkle2-")
               else {"bigdiv": BIGINT_DIV_SRC,
                     "cmp": comparators_source()}[name])
        prog = _program(src, prime)
        spec = prog.spec
        if name.startswith("merkle2-"):
            # canonical leaf and path elements, pathIndex bits
            x = canonical(rng, spec, (prog.n_inputs, spec.n_limbs, B))
            for i, (lo, hi) in prog.input_ranges.items():
                x[i] = 0
                x[i, 0] = rng.integers(lo, hi + 1, size=B)
        elif name == "cmp":
            x = comparator_inputs(B, 74, spec.n_limbs)
        else:
            x = canonical(rng, spec, (prog.n_inputs, spec.n_limbs, B))
            if name == "bigdiv":
                x[1, 0, :] |= 1        # a nonzero divisor
    return prog.interp.plan, prog.field, u32_tensor(x)


def u32_tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)
                            .view(np.int32)).view(torch.uint32)


PLANS = ["poseidon2-bn128", "poseidon2-goldilocks", "sha256", "bigdiv",
         "cmp", "narrow-unit", "unit-bn128", "unit-goldilocks", "overwrite",
         "groups", "poseidon2-bls12381", "poseidon2-secq256r1",
         "merkle2-secq256r1"]


@pytest.mark.parametrize("name", PLANS)
def test_host_k1_matches_plain_on_emitted_rows(k1host, name):
    plan, field, x = case(name)
    L, Bx = plan.L, x.shape[-1]
    # the wide file, L/2 words a register a lane, then a guard that K1
    # must not touch
    n_file = plan.n_regs * (L // 2) * Bx
    assert np.prod(k1_file_shape(plan, Bx)) == n_file
    rf_guarded = torch.full((n_file + 64,), -1, dtype=torch.int32)
    rf = rf_guarded[:n_file].view(k1_file_shape(plan, Bx))
    rf_n = torch.zeros((plan.n_nregs, Bx), dtype=torch.int32)
    # banks filled with a marker: rows K1 does not store keep it
    bank = torch.full((plan.n_bank_rows, L, Bx), -1, dtype=torch.int32)
    bank_n = torch.full((plan.n_bank_n_rows, Bx), -1, dtype=torch.int32)
    rc = k1host.ctpu_interp_k1(*k1_args(
        plan, field, x, rf.view(torch.uint32), bank.view(torch.uint32),
        rf_n, bank_n, None))
    assert rc == 0
    assert bool((rf_guarded[n_file:] == -1).all())
    x_w, x_n = split_inputs(plan, x)
    want_w, want_n = run_plan(plan, field, as_i64(x_w), as_i64(x_n))
    rows = torch.as_tensor(plan.emitted_rows())
    rows_n = torch.as_tensor(plan.emitted_rows(narrow=True))
    assert len(rows) + len(rows_n)
    assert torch.equal(as_i64(bank.view(torch.uint32))[rows], want_w[rows])
    assert torch.equal(bank_n[rows_n].long(), want_n[rows_n])
    # no dump row is stored
    for per, got, n in ((plan.K + 1, bank, plan.n_chunks),
                        (plan.KN + 1, bank_n, plan.n_chunks)):
        dump = torch.arange(n) * per + per - 1
        assert bool((got[dump] == -1).all())


def test_wide_file_is_words():
    """K1's wide file holds L/2 32-bit words a register a lane: the
    comparators' 139 registers at 65,536 lanes take 291 MB, not the 583 MB
    of 16-bit limbs."""
    plan = case("cmp")[0]
    shape = k1_file_shape(plan, 65536)
    assert shape == (139, 8, 65536)
    assert 4 * np.prod(shape) == 291_504_128
    assert k1_file_shape(case("poseidon2-goldilocks")[0], 65536) == \
        (case("poseidon2-goldilocks")[0].n_regs, 65536, 2)


def dump_rows(plan, narrow):
    per = (plan.KN if narrow else plan.K) + 1
    return set(range(per - 1, plan.n_chunks * per, per))


@pytest.mark.parametrize("name", PLANS)
def test_dump_rows_are_nobodys_output(name):
    plan = case(name)[0]
    dump_w, dump_n = dump_rows(plan, False), dump_rows(plan, True)
    assert not dump_w & set(plan.wd_src.tolist())
    assert not dump_n & set(plan.nw_src.tolist())
    assert not dump_w & set(np.flatnonzero(plan.mont_tab).tolist())
    for narrow, dump in ((False, dump_w), (True, dump_n)):
        written = set(plan.written_rows(narrow).tolist())
        assert set(plan.emitted_rows(narrow).tolist()) == written - dump


@pytest.mark.parametrize("name", PLANS)
def test_narrow_step_groups(name):
    """grp cuts every narrow run into groups that read nothing an earlier
    step of the group writes, each as long as that allows (at most
    K1B_GROUP); other steps have 1."""
    plan = case(name)[0]
    if name == "groups":
        np.testing.assert_array_equal(plan.grp, groups_arrays(16)[1])
    starts = set()
    for rr in range(plan.rstarts[0], plan.rstarts[-1]):
        op = OPCODES[plan.r_op[rr]]
        if op not in _NARROW_RESULT:
            continue
        files = _OPERAND_FILES.get(op, "www")[:N_OPERANDS[op]]

        def reads(t):
            return {int(plan.table[t, 1 + j])
                    for j, f in enumerate(files) if f == "n"}

        t, s1 = int(plan.r_s0[rr]), int(plan.r_s0[rr + 1])
        while t < s1:
            g = int(plan.grp[t])
            assert 1 <= g <= K1B_GROUP and t + g <= s1
            written = {int(plan.table[u, 4]) for u in range(t, t + g)}
            for u in range(t + 1, t + g):
                assert not reads(u) & {int(plan.table[v, 4])
                                       for v in range(t, u)}
            if g < K1B_GROUP and t + g < s1:
                assert reads(t + g) & written
            starts.add(t)
            t += g
    assert all(plan.grp[t] == 1 for t in range(len(plan.table))
               if t not in starts)
    if name == "sha256":
        assert int((plan.grp > 1).sum()) > 1000


def test_group_length_matches_the_kernel(tmp_path):
    """The kernel's largest group (NGROUP in interp.cu) is the converter's
    K1B_GROUP, which the build passes as a -D flag: a longer group would
    skip steps, and interp.cu does not build without the flag."""
    assert build.source_flags("interp") == (f"-DCTPU_K1B_GROUP={K1B_GROUP}",)
    assert build.source_flags("gather") == ()
    src = (ROOT / "circom_tpu_torch/ops/cuda/interp.cu").read_text()
    assert re.findall(r"constexpr int NGROUP = (\w+);", src) == \
        ["CTPU_K1B_GROUP"]
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to preprocess interp.cu")
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    cmd = ["g++", "-E", "-std=c++17", "-x", "c++", "-I", str(tmp_path),
           "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
           str(ROOT / "circom_tpu_torch/ops/cuda/interp.cu"),
           "-o", os.devnull]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "CTPU_K1B_GROUP" in r.stderr
    r = subprocess.run(cmd + list(build.source_flags("interp")),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
