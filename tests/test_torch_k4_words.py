"""K4 and K6 in 32-bit words, on the CPU, at all eight --prime fields.

The segment kernels K4 (ops/segment_gen.py) and the elementwise add and
subtract K6 (ops/cuda/field_ops.cu) compute with the word headers
(field32.cuh, dot32.cuh, wide32.cuh), which are plain C++ on 32- and
64-bit integers: g++ builds them for the host here through a shim for the
CUDA qualifiers (one lane, or one element, a loop step).

- K4's generated source for the op circuit (every op a segment holds),
  the cross-boundary circuit (cut at 400 units, so that values travel in
  crossing rows or witness rows read back) and both shifts by the counts
  beside every word boundary, against the plain version
  (backend/segments.py `segment_ref`) on the same in-place buffers, every
  witness and crossing row after each segment, at each field; the first
  lanes take every pair of the edges 0, 1, p - 1, p // 2, p // 2 + 1,
  2^16, 2^32 and 2^64 (mod p) on the first two inputs.
- K6's elementwise kernel (its launch wrapper left out) against the plain
  TorchField add and subtract at each field, on every pair of the edge
  operands and on seeded canonical ones, with the second operand also a
  constant column broadcast over the lanes (stride 0), as field_kernels
  passes it.
- No kernel source in ops/cuda and no source segment_gen writes includes
  wide.cuh or calls field.cuh's 16-bit routines, through any header it
  includes.

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

from circom_tpu_torch.backend.segments import UNWRITTEN, segment_ref
from circom_tpu_torch.circuits.sources import (num2bits_source,
                                               segment_ops_source)
from circom_tpu_torch.field.primes import PRIMES, field_spec
from circom_tpu_torch.ops.field import TorchField, mont_edge_values
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_torch_segments import CROSS_SRC, host_library, limbs, ptr
from test_torch_segments_inplace import pair_columns, program

ROOT = Path(__file__).resolve().parents[1]
CUDA_DIR = ROOT / "circom_tpu_torch/ops/cuda"

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++ to build the word "
                                      "headers for the host")


def shifts_source(bits):
    """Both shifts of one input by the counts at and beside the word
    boundaries below the field's bits (31-33, 63-65, ..., bits - 1)."""
    counts = sorted({k for w in range(32, bits, 32) for k in (w - 1, w,
                                                               w + 1)
                     if k < bits} | {bits - 2, bits - 1})
    exprs = [f"a {d} {k}" for d in (">>", "<<") for k in counts]
    body = "\n".join(f"  o[{i}] <-- {e};" for i, e in enumerate(exprs))
    return f"""
pragma circom 2.0.0;
template Shifts() {{
  signal input a;
  signal output o[{len(exprs)}];
{body}
  for (var i = 0; i < {len(exprs)}; i++) {{ o[i] * 0 === 0; }}
}}
component main = Shifts();
"""


def edge_values(p):
    """0, 1, p - 1, p // 2, p // 2 + 1, 2^16, 2^32 and 2^64, mod p."""
    return [0, 1, p - 1, p // 2, p // 2 + 1, 1 << 16, (1 << 32) % p,
            (1 << 64) % p]


@needs_gxx
@pytest.mark.parametrize("name", ["ops", "cross", "shifts"])
@pytest.mark.parametrize("prime", list(PRIMES))
def test_word_k4_matches_plain(prime, name, tmp_path):
    """Each segment's generated kernel, built by g++, against segment_ref
    on the same buffers: the inputs, and the witness and crossing rows
    the earlier segments wrote; every witness and crossing row equal after
    each segment, and no witness row left unwritten."""
    p = field_spec(prime).p
    src, budget = {"ops": (segment_ops_source(p.bit_length()), None),
                   "cross": (CROSS_SRC, 400),
                   "shifts": (shifts_source(p.bit_length()), None)}[name]
    cc, sp = program(src, prime, budget)
    assert len(sp.kernels) >= (name != "shifts") + 1
    text = sp.source()
    lib = host_library(text, len(sp.kernels), tmp_path)
    B = 80
    cols = pair_columns(edge_values(p), sp.n_inputs, B, 61, p,
                        cc.input_range_hints())
    x = torch.from_numpy(limbs(cols, sp.L).view(np.int32)).view(torch.uint32)
    got, want = sp.buffers(B, UNWRITTEN), sp.buffers(B, UNWRITTEN)
    for s, kn in enumerate(sp.kernels):
        segment_ref(sp.field, kn, x, *want)
        getattr(lib, f"host_seg{s}")(ptr(x), ptr(got[0]), ptr(got[1]), B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                          w.view(torch.int32).numpy(),
                                          err_msg=f"{prime} seg {s}")
    assert not bool((got[0].view(torch.int32) == UNWRITTEN).any())


# the CUDA qualifiers and the grid as plain C++, for field_ops.cu's kernels
K6_SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
struct Dim3Shim { unsigned x, y, z; };
static Dim3Shim blockIdx, threadIdx, blockDim, gridDim;
"""

# K6's kernel over the whole (n, L, B) as one thread of a one-thread grid
# (its grid-stride loop takes every element), the field's constants as
# ctpu_field_elementwise sets them
K6_HOST = """
}  // namespace ctpu

template <int L, int OP>
static void run(const uint32_t* a, const long long* sa, const uint32_t* b,
                const long long* sb, uint32_t* out, long long n, long long B,
                const uint32_t* p_limbs) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L; ++i) fc.p[i] = p_limbs[i];
  blockIdx = threadIdx = {0, 0, 0};
  blockDim = gridDim = {1, 1, 1};
  ctpu::elementwise_kernel<L, OP>(a, {sa[0], sa[1], sa[2]}, b,
                                  {sb[0], sb[1], sb[2]}, out, n, B, fc);
}

extern "C" int host_k6(int op, int L, const uint32_t* a, const long long* sa,
                       const uint32_t* b, const long long* sb,
                       uint32_t* out, long long n, long long B,
                       const uint32_t* p_limbs) {
  const bool add = op == ctpu::OP_ADD;
  switch (L) {
    case 4: (add ? run<4, ctpu::OP_ADD> : run<4, ctpu::OP_SUB>)(
        a, sa, b, sb, out, n, B, p_limbs); return 0;
    case 16: (add ? run<16, ctpu::OP_ADD> : run<16, ctpu::OP_SUB>)(
        a, sa, b, sb, out, n, B, p_limbs); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def k6host(tmp_path_factory):
    """field_ops.cu's kernels, its launch wrapper and C entry point cut
    off, built by g++ with K6_HOST into a host library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build field_ops.cu's kernels for the host")
    d = tmp_path_factory.mktemp("k6")
    text = (CUDA_DIR / "field_ops.cu").read_text()
    text = text[:text.index("template <int L>\nvoid launch(")] + K6_HOST
    (d / "cuda_runtime.h").write_text(K6_SHIM)
    (d / "k6.cpp").write_text(text)
    so = d / "k6.so"
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
                        "-I", str(d), "-I", str(CUDA_DIR), "-o", str(so),
                        str(d / "k6.cpp")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.host_k6.restype = ctypes.c_int
    lib.host_k6.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    return lib


def u32(values, L):
    """Canonical ints as uint32 limbs (L, len(values))."""
    return torch.from_numpy(ints_to_limbs(values, L).T.copy().view(
        np.int32)).view(torch.uint32)


def host_k6(lib, op, f, a, b):
    """K6 on the host as field_kernels launches it on the card: both
    operands broadcast and reshaped to (n, L, B), strides in elements."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = int(np.prod(shape[:-2]))
    a3 = a.broadcast_to(shape).reshape(n, f.L, shape[-1])
    b3 = b.broadcast_to(shape).reshape(n, f.L, shape[-1])
    out = torch.empty((n, f.L, shape[-1]), dtype=torch.uint32)
    strides = [np.array(t.stride(), dtype=np.int64) for t in (a3, b3)]
    p = np.array(f.p_list, dtype=np.uint32)
    rc = lib.host_k6({"add": 1, "sub": 2}[op], f.L, a3.data_ptr(),
                     strides[0].ctypes.data, b3.data_ptr(),
                     strides[1].ctypes.data, out.data_ptr(), n, shape[-1],
                     p.ctypes.data)
    assert rc == 0
    return out.reshape(shape)


@pytest.mark.parametrize("prime", list(PRIMES))
def test_word_k6_matches_plain(k6host, prime):
    """mod_add32 / mod_sub32 in K6's kernel against TorchField.add / sub:
    every pair of the edges (mont_edge_values, p // 2, p // 2 + 1, 2^32
    mod p) and 200 seeded pairs, as (2, L, B) operands and with the second
    a constant column (L, 1) broadcast over the lanes."""
    spec = field_spec(prime)
    f = TorchField(spec)
    p, L = spec.p, spec.n_limbs
    edges = mont_edge_values(spec) + [p // 2, p // 2 + 1, (1 << 32) % p]
    rng = np.random.default_rng(62)
    rand = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(400)]
    xs = [x for x in edges for _ in edges] + rand[:200]
    ys = [y for _ in edges for y in edges] + rand[200:]
    a = torch.stack([u32(xs, L), u32(ys, L)])
    b = torch.stack([u32(ys, L), u32(xs, L)])
    for op in ("add", "sub"):
        want = getattr(f, op)(a, b)
        got = host_k6(k6host, op, f, a, b)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), op
        for c in (edges[2], edges[-2], rand[0]):
            col = u32([c], L)
            want = getattr(f, op)(a, col)
            got = host_k6(k6host, op, f, a, col)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (op, c)


# field.cuh's 16-bit routines: a call names one with its template
# arguments or its argument list (the word versions end in 32)
LIMB_CALL = re.compile(r"\b(mont_mul|mont_reduce_cols|mac_cols|mod_add|"
                       r"mod_sub|cond_sub)\s*[<(]")


def code_of(text):
    """C++ text without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def included(text, seen):
    """The headers of ops/cuda that a source includes, directly or through
    another header, added to `seen`."""
    for name in re.findall(r'#include "([^"]+)"', code_of(text)):
        if name not in seen and (CUDA_DIR / name).exists():
            seen.add(name)
            included((CUDA_DIR / name).read_text(), seen)
    return seen


def generated_sources():
    """K4's sources for the op circuit at every field, and for 4 x
    Num2Bits(254) at bn128."""
    out = {}
    for prime in PRIMES:
        bits = field_spec(prime).p.bit_length()
        out[f"ops/{prime}"] = program(segment_ops_source(bits),
                                      prime)[1].source()
    out["n2b254x4/bn128"] = program(num2bits_source(254, 4),
                                    "bn128")[1].source()
    return out


def test_no_kernel_computes_in_16bit_limbs():
    """No .cu of ops/cuda and no generated K4 source includes wide.cuh,
    and none, nor a header it includes other than field.cuh itself, calls
    field.cuh's 16-bit mont_mul, mont_reduce_cols, mac_cols, mod_add,
    mod_sub or cond_sub; field.cuh's FieldConsts stays where the kernels
    find it."""
    sources = {p.name: p.read_text() for p in sorted(CUDA_DIR.glob("*.cu"))}
    assert {"check.cu", "field_ops.cu", "gather.cu", "interp.cu",
            "scan.cu"} <= set(sources)
    sources.update(generated_sources())
    for name, text in sources.items():
        headers = included(text, set())
        assert "wide.cuh" not in headers, name
        for code in [code_of(text)] + [
                code_of((CUDA_DIR / h).read_text())
                for h in sorted(headers - {"field.cuh"})]:
            assert not LIMB_CALL.findall(code), (name, LIMB_CALL.findall(
                code))
    assert "struct FieldConsts" in (CUDA_DIR / "field.cuh").read_text()
