"""Kernel KS (ops/cuda/scan.cu), the scan executor's run as one kernel, on
the CPU.

scan.cu is built by g++ for the host: the CUDA qualifiers defined away, a
launch running each block's threads as host threads, the block's barrier
a host barrier, so the barrier order is the card's.  It is called through
the port's own argument list (backend/scan.ks_args) on CPU tensors, at a
thread a lane (1 warp a block) and a warp a slot (8 warps a block; 4 on
the unit tapes and at 1 slot).

- On test_torch_scan's TAPES and pow_div, over bn128 and goldilocks, at
  1, 8 and 64 slots: host KS's witness equals the step loop's (KS's plain
  version, `run_loop`) and the JAX scan's (`JaxProgram(...,
  unroll_threshold=0, mode="scan").run` at 8 slots; the witness does not
  depend on the slots), batch 3: lane 0 holds the edges 0, 1, p - 1 and
  2^253 mod p across its inputs, lane 1 divides by 0 where the tape
  divides.
- A unit tape for each of the 27 opcodes of JAX's `_branch`, a slot a
  set of operands and an immediate (shifts 0, 1, 15, 16, 17, 253, 254;
  exponents 0, 1, 2^31 - 1), two padding slots, a second step reading
  the first's results: KS equals the loop and JAX's `_branch`.
- L = 24 (the 381-bit base field of BLS12-381) against the loop; L = 8
  refused at construction, naming L.
- The table checks: a register read before it is written, a step writing
  what it reads, a witness row written twice or never, an opcode KS
  lacks.
- On a device other than the CPU ("meta" here) a run takes KS: a library
  that fails to build raises, and the loop is never called.

Every comparison is exact (tolerance 0).
"""

import ctypes
import dataclasses
import functools
import re
import shutil
import subprocess
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops.jfield import JaxField
from circom_tpu_torch.backend import scan as scan_mod
from circom_tpu_torch.backend.scan import (KS_BRANCHES, Schedule, ScanProgram,
                                           ks_args, ks_tables)
from circom_tpu_torch.field.primes import FieldSpec, field_spec
from circom_tpu_torch.ops import build
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs
from circom_tpu_torch.utils.roofline import ks_bytes, ks_ops
from test_torch_perop import _inputs, tensor, u32
from test_torch_scan import DIVIDES, PRIMES, TAPES, compiled, programs

ROOT = Path(__file__).resolve().parents[1]
# the base field of BLS12-381, 381 bits: 24 limbs
BLS12381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eab"
    "fffeb153ffffb9feffffffffaaab", 16)

# the CUDA names scan.cu uses, for g++: a launch runs each block's threads
# as host threads, and __syncthreads() waits for all of them
SHIM = """\
#pragma once
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
struct int4 { int x, y, z, w; };
struct Dim3Shim { unsigned x; };
static thread_local Dim3Shim blockIdx, threadIdx;
static Dim3Shim blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, waiting = 0;
  unsigned long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned long g = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};
static HostBarrier block_barrier;
inline void __syncthreads() { block_barrier.wait(); }
template <class K, class... A>
void host_launch(K kernel, unsigned blocks, int threads, const A&... args) {
  blockDim.x = threads;
  block_barrier.n = threads;
  for (unsigned bl = 0; bl < blocks; ++bl) {
    std::vector<std::thread> pool;
    for (int th = 0; th < threads; ++th)
      pool.emplace_back([=, &args...] {
        blockIdx.x = bl;
        threadIdx.x = th;
        kernel(args...);
      });
    for (auto& t : pool) t.join();
  }
}
"""


@pytest.fixture(scope="module")
def kshost(tmp_path_factory):
    """scan.cu built by g++, entry point ctpu_scan as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build scan.cu for the host")
    src = (ROOT / "circom_tpu_torch/ops/cuda/scan.cu").read_text()
    src, n = re.subn(r"(scan_kernel<L>)<<<\(unsigned\)blocks, KS_LANES \* "
                     r"warps, 0, s>>>\(a, kc\);",
                     r"host_launch(\1, (unsigned)blocks, KS_LANES * warps, "
                     r"a, kc);", src)
    assert n == 1
    tmp = tmp_path_factory.mktemp("kshost")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "scan_host.cpp").write_text(src)
    so = tmp / "scan_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp / "scan_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    res, args = build.SIGNATURES["scan"]["ctpu_scan"]
    lib.ctpu_scan.restype = res
    lib.ctpu_scan.argtypes = args
    return lib


def host_ks(lib, scan, x, warps):
    """One run of host KS: witness uint32 (n_witness, L, B), as
    ScanProgram.run_ks allocates it on the card."""
    x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    x = tensor(x) if x.dtype != torch.uint32 else x.contiguous()
    L, B = scan.field.L, x.shape[-1]
    rf = torch.empty((scan.sched.n_regs, L // 2, B), dtype=torch.int32)
    out = torch.empty((scan.n_witness, L, B), dtype=torch.int32)
    rc = lib.ctpu_scan(*ks_args(scan, x, rf, out, warps, None))
    assert rc == 0
    return u32(out)


def edge_columns(prime, wp, name):
    """Batch 3: lane 0 holds the edges across its un-hinted inputs, lane 1
    divides by 0 where the tape divides."""
    p = field_spec(prime).p
    hints = compiled(name, prime)[2]
    cols = _inputs(prime, wp.n_inputs, hints, 3, zlib.crc32(name.encode()))
    edges = [0, 1, p - 1, (1 << 253) % p]
    for i, col in enumerate(cols):
        if i not in hints:
            col[0] = edges[i % 4]
    if name in DIVIDES:
        cols[1][1] = 0
    return cols


@functools.lru_cache(maxsize=None)
def jax_witness(name, prime):
    """(inputs, the JAX scan's witness at 8 slots) of a tape, batch 3."""
    jp, wp = programs(name, prime, unroll_threshold=0, mode="scan")
    x = wp.encode_inputs(edge_columns(prime, wp, name))
    return x, np.asarray(jp.run(x))


@pytest.mark.parametrize("slots", (1, 8, 64))
@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("name", list(TAPES) + ["pow_div"])
def test_ks_matches_loop_and_jax_scan(kshost, name, prime, slots):
    x, want = jax_witness(name, prime)
    wp = programs(name, prime, unroll_threshold=0, mode="scan",
                  slots=slots)[1]
    loop = u32(wp.scan.run_loop(x))
    np.testing.assert_array_equal(loop, want)
    # a step of one slot keeps one warp of a block busy: 4 warps, not 8,
    # for the barrier's order at 1 slot
    for warps in (1, 4 if slots == 1 else 8):
        np.testing.assert_array_equal(host_ks(kshost, wp.scan, x, warps),
                                      want, err_msg=f"warps {warps}")


# per-slot immediates of the unit tapes
SHIFTS = (0, 1, 15, 16, 17, 253, 254)
EXPONENTS = (0, 1, 2 ** 31 - 1)
IMMS = {"shl_k": SHIFTS, "shr_k": SHIFTS, "pow_k": EXPONENTS}
PAD = 2


def unit_schedule(op, n_slots, imms):
    """A schedule of two steps: `op` on n_slots real slots, slot j reading
    inputs 3j, 3j + 1, 3j + 2 (registers of the same numbers) and writing
    register 3 n + j and witness row j, then PAD padding slots; then an
    `add` step reading the first two results (witness row n)."""
    n, S = n_slots, n_slots + PAD
    base = 3 * n
    trash = base + n + 1
    a_i = np.zeros((2, S), np.int32)
    b_i, c_i, imm = (np.zeros_like(a_i) for _ in range(3))
    o_i = np.full((2, S), trash, np.int32)
    w_i = np.full((2, S), n + 1, np.int32)
    a_i[0, :n], b_i[0, :n], c_i[0, :n] = (np.arange(n) * 3 + k
                                          for k in range(3))
    o_i[0, :n], w_i[0, :n] = base + np.arange(n), np.arange(n)
    imm[0, :n] = imms
    a_i[1, 0], b_i[1, 0] = base, base + (1 if n > 1 else 0)
    o_i[1, 0], w_i[1, 0] = base + n, n
    ops = sorted({op, "add"})
    opc = np.asarray([ops.index(op), ops.index("add")], np.int32)
    return Schedule(
        slots=S, tables=(opc, a_i, b_i, c_i, o_i, w_i, imm),
        const_loads=[], input_loads=[(r, r) for r in range(base)],
        out_dups=[], load_outputs=[],
        out_regs=np.asarray(list(range(base, base + n + 1)), np.int32),
        n_regs=trash + 1, n_steps=2, n_witness=n + 1, branch_ops=ops)


def unit_inputs(prime, n_slots, seed):
    """(3 n_slots, L, B) canonical operands: every pair of the edges 0, 1,
    p - 1, p // 2, p // 2 + 1, 2^253 mod p in each slot's a and b (c the
    edges too), then random values."""
    p = field_spec(prime).p
    L = field_spec(prime).n_limbs
    edges = [0, 1, p - 1, p // 2, p // 2 + 1, (1 << 253) % p]
    B = len(edges) ** 2 + 4
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(3 * n_slots):
        v = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(B)]
        for k in range(len(edges) ** 2):
            v[k] = edges[(k // len(edges) ** (i % 3 % 2)) % len(edges)]
        cols.append(ints_to_limbs(v, L).T)
    return np.stack(cols)


def jax_branch(prime, op, x, n_slots, imms):
    """JAX's `_branch` on the slots' operands (S, L, B)."""
    jf = JaxField(jax_field_spec(prime))
    branch = functools.partial(JaxProgram._branch, SimpleNamespace(jf=jf))
    a, b, c = (x[k::3][:n_slots] for k in range(3))
    return np.asarray(branch(op)(a, b, c, jnp.asarray(imms, jnp.uint32)))


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("op", KS_BRANCHES)
def test_ks_unit_opcode(kshost, op, prime):
    imms = IMMS.get(op, (0, 0, 0, 0))
    n = len(imms)
    sched = unit_schedule(op, n, imms)
    scan = ScanProgram(sched, TorchField(field_spec(prime)))
    x = unit_inputs(prime, n, zlib.crc32(f"{op}{prime}".encode()))
    loop = u32(scan.run_loop(tensor(x)))
    np.testing.assert_array_equal(loop[:n], jax_branch(prime, op, x, n,
                                                       imms))
    for warps in (1, 4):
        np.testing.assert_array_equal(host_ks(kshost, scan, x, warps), loop,
                                      err_msg=f"warps {warps}")


def test_ks_l24_matches_loop(kshost):
    """L = 24, the 381-bit base field of BLS12-381: every opcode of the
    bigint-div + Num2Bits(254) tape and pow_div's."""
    spec = FieldSpec("bls12381_q", BLS12381_Q)
    assert spec.n_limbs == 24
    tf = TorchField(spec)
    for name in ("bigdiv_num2bits", "pow_div"):
        _, wp = programs(name, "bn128", unroll_threshold=0, mode="scan")
        scan = ScanProgram(wp.scan.sched, tf)
        cols = [[int(v) for v in np.random.default_rng(k).integers(
            0, 1 << 62, size=3)] for k in range(wp.n_inputs)]
        cols[0][0] = BLS12381_Q - 1
        cols[1][1] = 0
        x = np.stack([ints_to_limbs(c, 24).T for c in cols])
        loop = u32(scan.run_loop(tensor(x)))
        for warps in (1, 8):
            np.testing.assert_array_equal(host_ks(kshost, scan, x, warps),
                                          loop, err_msg=f"{name} {warps}")


def test_ks_refuses_another_l():
    spec = FieldSpec("p128", (1 << 127) - 1)
    assert spec.n_limbs == 8
    _, wp = programs("mixed", "bn128", unroll_threshold=0, mode="scan")
    with pytest.raises(ValueError, match="not L = 8"):
        ScanProgram(wp.scan.sched, TorchField(spec))


def test_ks_tables_checks():
    base = unit_schedule("add", 2, (0, 0))
    ks_tables(base)

    def broken(**edit):
        t = [a.copy() for a in base.tables]
        for k, (si, sj, v) in edit.items():
            t["opc a_i b_i c_i o_i w_i imm".split().index(k)][si, sj] = v
        return dataclasses.replace(base, tables=tuple(t))

    # registers 0-5 hold the inputs, step 0 writes 6 and 7, step 1 8
    with pytest.raises(ValueError, match="reads register 8 before"):
        ks_tables(broken(a_i=(0, 1, 8)))
    with pytest.raises(ValueError, match="writes a register twice or one "
                       "that it reads"):
        ks_tables(broken(o_i=(0, 0, 0)))
    with pytest.raises(ValueError, match="writes a register twice"):
        ks_tables(broken(o_i=(0, 1, 6)))
    with pytest.raises(ValueError, match="other than once"):
        ks_tables(broken(w_i=(0, 1, 0)))
    with pytest.raises(ValueError, match="padding slot"):
        ks_tables(broken(w_i=(0, 2, 1)))
    with pytest.raises(NotImplementedError, match="no opcode 'pow'"):
        ks_tables(dataclasses.replace(base, branch_ops=["add", "pow"]))


def test_ks_never_falls_back(monkeypatch):
    """A run on a device other than the CPU launches KS: a library that
    fails to build raises, and the step loop is not called."""
    _, wp = programs("bigdiv", "goldilocks", unroll_threshold=0, mode="scan")
    twin = wp.for_device("meta")

    def no_library(name):
        raise RuntimeError(f"nvcc failed on {name}.cu")

    def no_loop(*a, **k):
        raise AssertionError("the step loop ran")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(ScanProgram, "run_loop", no_loop)
    x = torch.zeros((wp.n_inputs, 4, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc failed on scan.cu"):
        twin.run(x.view(torch.uint32))
    assert scan_mod.KS_WARPS in scan_mod.KS_LAYOUTS


def test_roofline_counts_by_hand():
    """ks_bytes and ks_ops on the unit tape of `mul` (4 slots, L = 16):
    counted by hand from the entries."""
    sched = unit_schedule("mul", 4, (0, 0, 0, 0))
    L, N = 16, 8
    # first step: 12 inputs read (L limbs) and written to registers (N
    # words); step 0: 4 products read 2 N, write N + L; step 1: one add
    # reads 2 N, writes N + L
    regs = 4 * (12 * (L + N) + 4 * (2 * N + N + L) + (2 * N + N + L))
    assert ks_bytes(sched, L) == (regs, 4 * (12 * L + 5 * L))
    # a product 2 N^2 32x32->64-bit products, two instructions each; an
    # add N
    assert ks_ops(sched, field_spec("bn128").p) == 4 * (2 * 2 * N * N) + N
