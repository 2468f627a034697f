"""Kernel KS (ops/cuda/scan.cu), a per-op tape's run as one kernel, on the
CPU.

scan.cu is built by g++ for the host: the CUDA qualifiers defined away, a
launch running each block's threads as host threads, the block's barrier
a host barrier, so the barrier order is the card's, and the block's shared
memory one buffer (blocks run in turn, the buffer refilled with a
pattern before each).  It is called through the port's own argument list
(backend/ks.ks_args) on CPU tensors, over the tables backend/ks.py builds
from the DomainTape, at every width KS takes (KS_WIDTHS: 1 to 16 warps a
block).

- On test_torch_scan's TAPES and pow_div, over bn128 and goldilocks, the
  step loop at 1, 8 and 64 slots: host KS's witness at each width equals
  the step loop's (the scan's plain version, `run_loop`) and the JAX
  scan's (`JaxProgram(..., unroll_threshold=0, mode="scan").run` at 8
  slots), batch 3: lane 0 holds the edges 0, 1, p - 1 and 2^253 mod p
  across its inputs, lane 1 divides by 0 where the tape divides.
- A unit tape for each of the 27 opcodes of JAX's `_branch`, an entry a
  set of operands and an immediate (shifts 0, 1, 15, 16, 17, 253, 254;
  exponents 0, 1, 2^31 - 1), a second step reading the first's results:
  KS equals the loop (over the same nodes' schedule with two padding
  slots) and JAX's `_branch`.
- L = 24 (the 381-bit base field of BLS12-381) against the loop; L = 8
  refused at construction, naming L.
- Spills: a budget of a few registers, and of none, so that registers
  live in the file in device memory, against the loop.
- The builder: Q's tape (16 x Num2Bits(254)) at 8 warps in at most 32
  registers, O's (bigint-div + Num2Bits(254)) in at most 16, no constant
  in a register; the widths ks_width picks.
- The straight-line path: O's tape (bn128, goldilocks) and powers beyond
  32 bits (a chain of 16-bit powers) by host KS against the per-node
  path (`run_nodes`) and the host calculator; the per-node path against
  JAX's straight-line `_run_ssa` (O's tape at goldilocks only: at bn128
  its jit takes minutes on the CPU).
- The table checks: a register read before it is written, a step writing
  what it reads, a witness row written twice or never, an operand outside
  the constants, a register that no longer holds the value read, an
  opcode KS lacks.
- On a device other than the CPU ("meta" here) a scan run and a
  straight-line run take KS: a library that fails to build raises, and
  neither the loop nor the per-node path is called.

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
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu_torch.backend import ks as ks_mod
from circom_tpu_torch.backend.ks import (KS_BRANCHES, KS_OPS, KS_WIDTHS,
                                         KsProgram, ks_args, ks_check,
                                         ks_tables, ks_width)
from circom_tpu_torch.backend.perop import PerOpProgram
from circom_tpu_torch.backend.scan import Schedule, ScanProgram
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (bigdiv_num2bits_source,
                                               num2bits_source)
from circom_tpu_torch.compiler.pipeline import compile_source
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
// the block's dynamic shared memory: blocks run one at a time, so one
// buffer, refilled with a pattern before each block (a read before a
// write shows as a wrong value)
static uint32_t* host_smem = nullptr;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 227 * 1024 ? cudaSuccess : cudaErrorInvalidValue;
}
template <class K, class... A>
void host_launch(K kernel, unsigned blocks, int threads, int smem,
                 const A&... args) {
  blockDim.x = threads;
  block_barrier.n = threads;
  std::vector<uint32_t> buf(smem / 4 + 1);
  host_smem = buf.data();
  for (unsigned bl = 0; bl < blocks; ++bl) {
    for (auto& w : buf) w = 0xdeadbeefu;
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
                     r"warps, smem, s>>>\(a, kc\);",
                     r"host_launch(\1, (unsigned)blocks, KS_LANES * warps, "
                     r"smem, a, kc);", src)
    assert n == 1
    src, n = re.subn(r"extern __shared__ uint32_t ks_smem\[\];",
                     "uint32_t* ks_smem = host_smem;", src)
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


def host_ks(lib, ks, x, warps):
    """One run of host KS over KsProgram `ks`'s tables at `warps` a block:
    witness uint32 (n_witness, L, B), allocated as KsProgram.run does."""
    x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    x = tensor(x) if x.dtype != torch.uint32 else x.contiguous()
    L, B = ks.field.L, x.shape[-1]
    d = ks.device_tables(warps)
    t = d["t"]
    spill = (torch.empty((t.n_spill, L // 2, B), dtype=torch.int32)
             if t.n_spill else None)
    out = torch.empty((ks.n_witness, L, B), dtype=torch.int32)
    rc = lib.ctpu_scan(*ks_args(ks.field, d, x, spill, out, None))
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
    for warps in KS_WIDTHS:
        np.testing.assert_array_equal(host_ks(kshost, wp.scan.ks, x, warps),
                                      want, err_msg=f"warps {warps}")


# per-entry immediates of the unit tapes
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


def unit_tape(op, n_slots, imms):
    """unit_schedule's nodes as a tape (the fields KS's builder reads):
    inputs 0 .. 3n - 1, then `op` on inputs 3j, 3j + 1, 3j + 2 (as many as
    it reads) with immediate imms[j], then the add of the first two
    results; the witness the n results and the sum."""
    n = n_slots
    arity = ks_mod.arity(op)
    ops = ["input"] * (3 * n) + [op] * n + ["add"]
    args = [()] * (3 * n) + [tuple(range(3 * j, 3 * j + arity))
                             for j in range(n)]
    args.append((3 * n, 3 * n + (1 if n > 1 else 0)))
    imms = list(range(3 * n)) + [int(v) for v in imms] + [None]
    return SimpleNamespace(ops=ops, args=args, imms=imms,
                           domains=[0] * len(ops),
                           outputs=list(range(3 * n, 4 * n + 1)))


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
    scan = ScanProgram(unit_schedule(op, n, imms),
                       TorchField(field_spec(prime)), unit_tape(op, n, imms))
    x = unit_inputs(prime, n, zlib.crc32(f"{op}{prime}".encode()))
    loop = u32(scan.run_loop(tensor(x)))
    np.testing.assert_array_equal(loop[:n], jax_branch(prime, op, x, n,
                                                       imms))
    for warps in (1, 4, 16):
        np.testing.assert_array_equal(host_ks(kshost, scan.ks, x, warps),
                                      loop, err_msg=f"warps {warps}")


def test_ks_l24_matches_loop(kshost):
    """L = 24, the 381-bit base field of BLS12-381: every opcode of the
    bigint-div + Num2Bits(254) tape and pow_div's."""
    spec = FieldSpec("bls12381_q", BLS12381_Q)
    assert spec.n_limbs == 24
    tf = TorchField(spec)
    for name in ("bigdiv_num2bits", "pow_div"):
        _, wp = programs(name, "bn128", unroll_threshold=0, mode="scan")
        scan = ScanProgram(wp.scan.sched, tf, wp.dt)
        cols = [[int(v) for v in np.random.default_rng(k).integers(
            0, 1 << 62, size=3)] for k in range(wp.n_inputs)]
        cols[0][0] = BLS12381_Q - 1
        cols[1][1] = 0
        x = np.stack([ints_to_limbs(c, 24).T for c in cols])
        loop = u32(scan.run_loop(tensor(x)))
        for warps in (1, 8):
            np.testing.assert_array_equal(host_ks(kshost, scan.ks, x, warps),
                                          loop, err_msg=f"{name} {warps}")


def test_ks_refuses_another_l():
    spec = FieldSpec("p128", (1 << 127) - 1)
    assert spec.n_limbs == 8
    _, wp = programs("mixed", "bn128", unroll_threshold=0, mode="scan")
    with pytest.raises(ValueError, match="not L = 8"):
        ScanProgram(wp.scan.sched, TorchField(spec), wp.dt)


@pytest.mark.parametrize("prime", PRIMES)
def test_ks_spill_matches_loop(kshost, prime):
    """A shared file of 3 registers, then of none: the rest live in the
    file in device memory (bigint-div + Num2Bits(254), pow_div)."""
    L = field_spec(prime).n_limbs
    for name in ("bigdiv_num2bits", "pow_div"):
        x, want = jax_witness(name, prime)
        wp = programs(name, prime, unroll_threshold=0, mode="scan")[1]
        for regs in (3, 0):
            ks = KsProgram(wp.dt, wp.field, budget=regs * L // 2 * 4 * 32)
            for warps in (1, 8):
                t = ks.tables(warps)
                assert t.n_smem == regs and t.n_spill > 0
                np.testing.assert_array_equal(
                    host_ks(kshost, ks, x, warps), want,
                    err_msg=f"{name}, {regs} shared, warps {warps}")


@functools.lru_cache(maxsize=None)
def port_dt(source):
    cc = compile_source(source)
    wp = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                        device="cpu", unroll_threshold=0, mode="scan")
    return cc, wp


def test_builder_registers_on_q_and_o():
    """At 8 warps a block: Q's tape (16 x Num2Bits(254), 8,128 live
    compute nodes) in at most 32 registers, O's (bigint-div +
    Num2Bits(254), 515) in at most 16; every constant read as an operand
    (no entry writes a constant to a register); nothing spills at the
    default budget."""
    for source, nodes, most in ((num2bits_source(254, 16), 8128, 32),
                                (bigdiv_num2bits_source(), 515, 16)):
        _, wp = port_dt(source)
        t = ks_tables(wp.dt, 16, 8)
        op = np.asarray(KS_OPS)[t.ent[:, 0]]
        computes = ~np.isin(op, ("const", "input", "dup"))
        assert computes.sum() == nodes
        assert t.n_regs <= most and t.n_spill == 0
        assert t.n_steps <= -(-len(t.ent) // 8) + 2
        assert (t.ent[op == "const", 4] == -1).all()
        live_consts = {i for i in range(len(wp.dt.ops))
                       if wp.dt.ops[i] == "const"} & set(
            ks_mod.live_nodes(wp.dt))
        assert len(t.consts) == len(live_consts)


def test_ks_width_choice():
    """16 warps while the blocks fit one wave at 16 warps (8,448 lanes),
    else 8, and never more than the tape's steps fill on average (nodes /
    depth): Q's and O's tapes 16 at 8,192 lanes and 8 at 65,536; a chain
    1."""
    assert ks_mod.KS_ONE_WAVE_LANES == 8448
    assert [ks_width(2, 8128, B) for B in (300, 8192, 8448, 8449, 65536)] \
        == [16, 16, 16, 8, 8]
    assert ks_width(100, 150, 8192) == 1 and ks_width(10, 35, 300) == 2
    assert ks_width(10, 35, 65536) == 2
    for source in (num2bits_source(254, 16), bigdiv_num2bits_source()):
        _, wp = port_dt(source)
        assert (wp.scan.ks.width(8192), wp.scan.ks.width(65536)) == (16, 8)


POW_BIG_SRC = """
pragma circom 2.0.0;
template PowBig() {
    signal input a;
    signal input b;
    signal output o[4];
    o[0] <-- a ** 2147483648;
    o[1] <-- a ** 4294967295;
    o[2] <-- (a * b) ** 1099511640831;
    o[3] <-- b ** 18446744073709551616;
}
component main = PowBig();
"""


@pytest.mark.parametrize("source,prime", (("bigdiv_num2bits", "bn128"),
                                          ("bigdiv_num2bits", "goldilocks"),
                                          ("pow_big", "bn128")))
def test_straight_line_ks_matches_nodes_host_and_jax(kshost, source, prime):
    """The straight-line path (WitnessProgram at the default threshold):
    host KS over its tables at every width against the per-node path and
    the host calculator, batch 3, lane 1 dividing by 0 (bigint-div +
    Num2Bits(254): O's tape); exponents of 2^31, 2^32 - 1 (one 32-bit
    power), 2^40 + 2^16 - 1 and 2^64 (chains of 16-bit powers and
    products).  The per-node path against JAX's straight-line `_run_ssa`
    too, but for O's tape at bn128, whose jit takes minutes on the CPU
    (at goldilocks ~30 s)."""
    src = bigdiv_num2bits_source() if source == "bigdiv_num2bits" \
        else POW_BIG_SRC
    spec = field_spec(prime)
    p, L = spec.p, spec.n_limbs
    cc = compile_source(src, prime=prime)
    wp = WitnessProgram(cc.build_tape()[0], spec, device="cpu", mode="scan")
    assert wp.perop is not None
    if source == "pow_big":
        assert max(i for i in wp.dt.imms if i is not None) == 2 ** 64
    cols = [[p - 1, 12345, (1 << 253) % p], [3, 0, p - 2]]
    x = wp.encode_inputs(cols)
    want = u32(wp.perop.run_nodes(x))
    for lane in (0, 2):     # the host calculator refuses lane 1's a \ 0
        host = list(cc.witness_host({"a": cols[0][lane],
                                     "b": cols[1][lane]}))
        got = [sum(int(want[i, k, lane]) << (16 * k) for k in range(L))
               for i in range(len(host))]
        assert got == host, lane
    if (source, prime) != ("bigdiv_num2bits", "bn128"):
        jp = JaxProgram(jax_compile(src, prime=prime).build_tape()[0],
                        jax_field_spec(prime), mode="scan")
        assert jp.unroll and jp.fused is None
        np.testing.assert_array_equal(want, np.asarray(jp.run(x)))
    for warps in KS_WIDTHS:
        np.testing.assert_array_equal(host_ks(kshost, wp.perop.ks, x, warps),
                                      want, err_msg=f"warps {warps}")


def test_ks_tables_checks():
    """ks_check on the tables of unit_tape("add", 2): inputs 0, 1, 3, 4
    loaded in step 0, the two sums in step 1, their sum in step 2."""
    base = ks_tables(unit_tape("add", 2, (0, 0)), 16, 4)
    ks_check(base)
    assert base.n_steps == 3 and list(base.off) == [0, 4, 6, 7]

    def broken(k, col, v):
        ent = base.ent.copy()
        ent[k, col] = v
        return dataclasses.replace(base, ent=ent)

    written_1 = base.ent[5, 4]          # the register step 1 writes second
    with pytest.raises(ValueError, match=f"reads register {written_1} "
                       "before"):
        ks_check(broken(4, 1, written_1))
    with pytest.raises(ValueError, match="writes a register twice or one "
                       "that it reads"):
        ks_check(broken(5, 4, base.ent[4, 4]))
    with pytest.raises(ValueError, match="writes a register twice or one "
                       "that it reads"):
        ks_check(broken(4, 4, base.ent[4, 1]))
    with pytest.raises(ValueError, match="other than once"):
        ks_check(broken(6, 5, base.ent[4, 5]))
    with pytest.raises(ValueError, match="outside the constants"):
        ks_check(broken(4, 1, -1))
    with pytest.raises(ValueError, match="no longer holds"):
        # the second sum written over the first before the last entry
        # reads it: caught while the tables are made
        tape = unit_tape("add", 2, (0, 0))
        ks_mod._check_holders([[0, 1, 3, 4], [6], [7], [8]], tape.ops,
                              tape.args, {0: 0, 1: 1, 3: 2, 4: 3, 6: 4,
                                          7: 4, 8: -1}, {})
    with pytest.raises(NotImplementedError, match="no opcode 'pow'"):
        ks_tables(unit_tape("pow", 2, (0, 0)), 16, 4)


def test_ks_never_falls_back(monkeypatch):
    """A scan run and a straight-line run on a device other than the CPU
    launch KS: a library that fails to build raises, and neither the step
    loop nor the per-node path is called."""
    _, wp = programs("bigdiv", "goldilocks", unroll_threshold=0, mode="scan")
    _, line = programs("bigdiv", "goldilocks", mode="scan")
    assert line.perop is not None

    def no_library(name):
        raise RuntimeError(f"nvcc failed on {name}.cu")

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(ScanProgram, "run_loop", no_plain)
    monkeypatch.setattr(PerOpProgram, "run_nodes", no_plain)
    x = torch.zeros((wp.n_inputs, 4, 2), dtype=torch.int32)
    for prog in (wp, line):
        with pytest.raises(RuntimeError, match="nvcc failed on scan.cu"):
            prog.for_device("meta").run(x.view(torch.uint32))


def test_roofline_counts_by_hand():
    """ks_bytes and ks_ops on the unit tape of `mul` (4 entries, L = 16)
    at 16 warps, counted by hand from the entries: step 0 loads the 8
    inputs the products read (registers 0-7), step 1 the 4 products (the
    first two kept, registers 8 and 9, for the add), step 2 the add."""
    t = ks_tables(unit_tape("mul", 4, (0, 0, 0, 0)), 16, 16)
    assert (t.n_steps, t.n_regs, t.n_spill) == (3, 10, 0)
    L, N = 16, 8
    # compulsory: 8 inputs read, 5 witness rows written, L limbs each;
    # the shared file: 8 loads write N words, 4 products read 2 N, 2 of
    # them write N, the add reads 2 N
    got = ks_bytes(t, L)
    assert got == {"compulsory": 4 * L * (8 + 5), "spill": 0,
                   "shared": 4 * (8 * N + 4 * 2 * N + 2 * N + 2 * N)}
    spilled = dataclasses.replace(t, n_smem=8)
    assert ks_bytes(spilled, L)["spill"] == 4 * (2 * N + 2 * N)
    # a product 2 N^2 32x32->64-bit products, two instructions each; an
    # add N
    assert ks_ops(t, field_spec("bn128").p) == 4 * (2 * 2 * N * N) + N
