"""The port's segmented backend (kernel K4's plain version and its source
generator) against the JAX package's SegmentedProgram and the host
calculator.

- Planning parity: the same segments (instructions, input and output
  nodes, register slots, stats) as the JAX planner, at bn128 and
  goldilocks.
- Values: the plain K4 against the JAX K4 in Pallas interpret mode at
  goldilocks (batch 3, run eagerly as tests/test_fused.py runs it), and
  against the host calculator at bn128 on the full-width Num2Bits(254),
  LessThan(252) and 4 x Num2Bits(254), with edge inputs.
- The generator: one entry point per segment, every op of the segmented
  backend (plan.KERNEL_OPS but idiv) reached by the op circuits, and,
  where the machine has g++, the generated source compiled as host C++
  (a shim for the CUDA qualifiers, one lane a loop step) equal to the
  plain version bit for bit.

Comparisons are exact: field elements are integers.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.plan import KERNEL_OPS
from circom_tpu_torch.backend.segments import (UNWRITTEN, SegmentedProgram,
                                               segment_ref)
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (lessthan_source,
                                               num2bits_source,
                                               segment_ops_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops import segment_gen
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_fused import MIXED_SRC

ROOT = Path(__file__).resolve().parents[1]

CROSS_SRC = """
pragma circom 2.0.0;
template T() {
  signal input x;
  signal output y;
  signal t[4];
  t[0] <== x * x;
  t[1] <== t[0] * x + 1;
  t[2] <== t[1] * t[0];
  t[3] <== t[2] * t[1] + x;
  y <== t[3] * x;
}
component main = T();
"""


def source(name, prime):
    stdlib = (ROOT / "circom_tpu_torch/circuits/stdlib.circom").read_text()
    return {"n2b254": lambda: num2bits_source(254, 1, stdlib),
            "n2b254x4": lambda: num2bits_source(254, 4, stdlib),
            "lt252": lambda: lessthan_source(252, stdlib),
            "mixed": lambda: MIXED_SRC, "cross": lambda: CROSS_SRC,
            "ops": lambda: segment_ops_source(
                field_spec(prime).p.bit_length()),
            # without goldilocks' division chain (129 products, a minute
            # in interpret mode)
            "ops_nodiv": lambda: segment_ops_source(
                field_spec(prime).p.bit_length(), division=False)}[name]()


# name -> the budget it is cut with (the cross-boundary circuit of
# test_fused.py with a tiny one, so that values travel between segments)
BUDGET = {"cross": 400}


def programs(name, prime, budget=None):
    """(JAX SegmentedProgram, the port's, the port's compiled circuit),
    both cut at `budget`, by default the port's (BUDGET above, else
    segments.BUDGET: shorter segments than the JAX package's 60,000 units,
    for nvcc's sake)."""
    src = source(name, prime)
    cc_ref = jax_compile(src, prime=prime)
    hints = cc_ref.input_range_hints()
    jp = JaxProgram(cc_ref.build_tape()[0], jax_field_spec(prime),
                    mode="segments", input_ranges=hints)
    cc = compile_source(src, prime=prime)
    wp = WitnessProgram(cc.build_tape()[0], field_spec(prime), device="cpu",
                        mode="segments", input_ranges=hints)
    seg = wp.fused
    budget = budget or BUDGET.get(name)
    if budget is not None:
        seg = SegmentedProgram(wp.dt, field_spec(prime), "cpu", budget=budget)
    jseg = type(jp.fused)(jp.dt, jax_field_spec(prime), budget=seg.budget)
    return jseg, seg, cc


PARITY = [("n2b254", "bn128"), ("n2b254x4", "bn128"), ("lt252", "bn128"),
          ("ops", "bn128"), ("ops", "goldilocks"), ("cross", "goldilocks"),
          ("mixed", "goldilocks")]


def assert_same_segments(jseg, seg):
    assert seg.stats() == jseg.stats()
    assert len(seg.segments) == len(jseg.segments)
    for a, b in zip(seg.segments, jseg.segments):
        assert a.instrs == b.instrs
        assert (a.in_nodes, a.out_nodes, a.n_rf, a.cost) == \
            (b.in_nodes, b.out_nodes, b.n_rf, b.cost)
    assert seg.xt.out_ids == jseg.xt.out_ids


@pytest.mark.parametrize("name, prime", PARITY)
def test_segments_match_jax_planner(name, prime):
    jseg, seg, _ = programs(name, prime)
    assert_same_segments(jseg, seg)
    if name == "n2b254x4":
        assert len(seg.segments) > 1 and seg.segments[1].in_nodes


def test_default_budget_segments_match_jax():
    """At the JAX package's own budget (60,000 units) the port cuts
    4 x Num2Bits(254) as the JAX package does: two segments, values
    crossing the boundary."""
    jseg, seg, _ = programs("n2b254x4", "bn128", budget=60_000)
    assert_same_segments(jseg, seg)
    assert len(seg.segments) == 2 and seg.segments[1].in_nodes


def edge_columns(prime, n_inputs, hints, B, seed):
    """Input columns: the first lanes take every pair of the edge values
    0, 1, p - 1, p // 2, p // 2 + 1, 2^16 (inputs 0 and 1), the rest are
    random; range-hinted inputs are bits."""
    p = field_spec(prime).p
    edges = [0, 1, p - 1, p // 2, p // 2 + 1, 1 << 16]
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n_inputs):
        col = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(B)]
        for lane in range(min(B, 36)):
            col[lane] = edges[(lane // 6 ** min(i, 1)) % 6]
        if i in hints:
            col = [lane % 2 for lane in range(B)]
        cols.append(col)
    return cols


def limbs(cols, L):
    return np.stack([ints_to_limbs(c, L).T.copy() for c in cols])


def as_ints(wit):
    w = wit.view(torch.int32).numpy().view(np.uint32)
    return [[sum(int(w[i, k, b]) << (16 * k) for k in range(w.shape[1]))
             for b in range(w.shape[2])] for i in range(w.shape[0])]


@pytest.mark.parametrize("name", ["mixed", "cross", "ops_nodiv"])
def test_plain_k4_matches_jax_k4_interpret_goldilocks(name):
    """The JAX K4 in Pallas interpret mode, run eagerly, batch 3."""
    jseg, seg, _ = programs(name, "goldilocks")
    cols = edge_columns("goldilocks", seg.n_inputs, {}, 3, 41)
    x = limbs(cols, 4)
    want = np.asarray(jseg._run(x))
    got = seg._run(x).view(torch.int32).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def host_map(name, cols, lane):
    vals = [c[lane] for c in cols]
    if name in ("n2b254", "n2b254x4"):
        return {"a": vals}
    return dict(zip(["a", "b", "c"], vals))


@pytest.mark.parametrize("name, prime", [
    ("n2b254", "bn128"), ("lt252", "bn128"), ("n2b254x4", "bn128"),
    ("ops", "bn128"), ("ops", "goldilocks")])
def test_segments_match_host(name, prime):
    cc = compile_source(source(name, prime), prime=prime)
    hints = cc.input_range_hints()
    wp = WitnessProgram(cc.build_tape()[0], field_spec(prime), device="cpu",
                        input_ranges=hints, mode="segments")
    B = 40
    cols = edge_columns(prime, wp.n_inputs, hints, B, 42)
    if name == "lt252":      # LessThan(252) holds for inputs below 2^252
        cols = [[v >> 2 for v in c] for c in cols]
    if name == "ops":        # the host calculator refuses a / 0
        cols[1] = [v or 1 for v in cols[1]]
    wit = as_ints(wp.run(wp.encode_inputs(cols)))
    for lane in range(B):
        host = list(cc.witness_host(host_map(name, cols, lane)))
        assert [row[lane] for row in wit] == host, lane


def test_generator_reaches_every_segment_op():
    """One entry point per segment; the op circuits reach every op of
    plan.KERNEL_OPS but idiv at both fields, and the generator has code
    for exactly those."""
    assert segment_gen.OPS == set(KERNEL_OPS) - {"idiv"}
    reached = {}
    for prime in ("bn128", "goldilocks"):
        cc = compile_source(source("ops", prime), prime=prime)
        wp = WitnessProgram(cc.build_tape()[0], field_spec(prime),
                            device="cpu", mode="segments",
                            input_ranges=cc.input_range_hints())
        reached[prime] = {op for s in wp.fused.segments
                          for (op, *_rest) in s.instrs}
        text = wp.fused.source()
        assert re.findall(r'extern "C" int (ctpu_k4_seg\d+)', text) == \
            [f"ctpu_k4_seg{s}" for s in range(len(wp.fused.segments))]
    assert reached["bn128"] == reached["goldilocks"] == segment_gen.OPS
    _, seg, _ = programs("n2b254x4", "bn128")
    text = seg.source()
    assert text.count("__global__") == len(seg.segments) > 1
    seg.segments[0].instrs.append(("idiv", (("in", 0), ("in", 0)), None,
                                   None, None))
    with pytest.raises(ValueError, match="idiv"):
        seg.source()


# the CUDA qualifiers as plain C++, so that g++ compiles a generated K4
# source for the host
SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __constant__
#define __noinline__ __attribute__((noinline))
#define __forceinline__ inline
#define __launch_bounds__(x)
struct Dim3Shim { unsigned x; };
static Dim3Shim blockIdx, threadIdx;
typedef void* cudaStream_t;
"""


def host_library(text, n_segments, tmp_path):
    """The generated source, its launch wrappers replaced by a loop over
    the lanes, built by g++ into a shared library."""
    text = re.sub(r'extern "C" int ctpu_k4_seg\d+\(.*?\n}\n', "", text,
                  flags=re.S)
    for s in range(n_segments):
        text += (f'extern "C" void host_seg{s}(const uint32_t* x, '
                 f'uint32_t* w, uint32_t* c, long long B) {{\n'
                 f'  for (long long l = 0; l < B; ++l) {{\n'
                 f'    blockIdx.x = l / THREADS; threadIdx.x = l % THREADS;'
                 f'\n    k4_seg{s}(x, w, c, B);\n  }}\n}}\n')
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    (tmp_path / "k4.cpp").write_text(text)
    so = tmp_path / "k4.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
         "-I", str(tmp_path), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp_path / "k4.cpp")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    for s in range(n_segments):
        getattr(lib, f"host_seg{s}").argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong]
    return lib


def ptr(t):
    return t.view(torch.int32).numpy().ctypes.data


@pytest.mark.parametrize("name, prime", [
    ("ops", "bn128"), ("ops", "goldilocks"), ("n2b254x4", "bn128"),
    ("cross", "goldilocks")])
def test_generated_source_on_the_host_matches_plain(name, prime, tmp_path):
    """Each segment's generated kernel, built by g++, against the plain
    version on the same buffers: the inputs, and the witness and crossing
    rows the earlier segments wrote; every witness and crossing row equal
    after each segment."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the generated source for the host")
    _, seg, cc = programs(name, prime)
    lib = host_library(seg.source(), len(seg.kernels), tmp_path)
    B = 48
    cols = edge_columns(prime, seg.n_inputs, cc.input_range_hints(), B, 43)
    x = torch.from_numpy(limbs(cols, seg.L).view(np.int32)) \
        .view(torch.uint32)
    got, want = seg.buffers(B, UNWRITTEN), seg.buffers(B, UNWRITTEN)
    for s, sg in enumerate(seg.kernels):
        segment_ref(seg.field, sg, x, *want)
        getattr(lib, f"host_seg{s}")(ptr(x), ptr(got[0]), ptr(got[1]), B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                          w.view(torch.int32).numpy(),
                                          err_msg=f"seg {s}")
