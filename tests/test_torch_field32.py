"""Kernel K5's 32-bit arithmetic, and the main path's gathers, on the CPU.

- ops/cuda/field32.cuh compiled by g++ for the host, through the
  CUDA-qualifier shim of test_torch_segments.py: its Montgomery product
  equals TorchField.mont_mul for every prime of field/primes.py (L = 4
  and 16) on seeded random canonical operands and the edge operands of
  mont_edge_values, the second operand full or one broadcast column, and
  on operands in [p, R); its packing of 16-bit limbs into 32-bit words,
  and of p, equals Python integers' 32-bit digits; TorchField.n0inv32 is
  -p^-1 mod 2^32.
- The interpreter's main path gathers through its own unchecked route,
  never the public gather_w and gather_n with their index check (a
  device-to-host sync on the card): the plan's indices were checked when
  it was built.

Comparisons are exact: field elements are integers.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch.backend import interp
from circom_tpu_torch.backend.interp import TorchInterpreter
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (comparator_inputs,
                                               comparators_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import LIMB_BITS, PRIMES, field_spec
from circom_tpu_torch.ops.field import TorchField, as_i64, mont_edge_values
from circom_tpu_torch.ops.limbs import (int_to_limbs, ints_to_limbs,
                                        limbs_to_int)
from test_torch_segments import SHIM

ROOT = Path(__file__).resolve().parents[1]

HOST_SRC = """\
#include "cuda_runtime.h"
#include "field32.cuh"

template <int L>
void mont_mul_lanes(const uint32_t* a, const uint32_t* b, long long b_lane,
                    long long b_limb, uint32_t* out, long long n,
                    const uint32_t* p16, uint32_t n0inv32) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L; ++i) fc.p[i] = p16[i];
  uint32_t p[L / 2];
  ctpu::p_words<L>(fc, p);
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L / 2], y[L / 2], r[L / 2];
    ctpu::pack32<L>(a + e, n, x);
    ctpu::pack32<L>(b + e * b_lane, b_limb, y);
    ctpu::mont_mul32<L / 2>(x, y, p, n0inv32, r);
    ctpu::unpack32<L>(r, out + e, n);
  }
}

template <int L>
void pack_rows(const uint32_t* limbs, uint32_t* words, uint32_t* back,
               long long n) {
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L / 2];
    ctpu::pack32<L>(limbs + e * L, 1, x);
    for (int i = 0; i < L / 2; ++i) words[e * (L / 2) + i] = x[i];
    ctpu::unpack32<L>(x, back + e * L, 1);
  }
}

template <int L>
void p_words(const uint32_t* p16, uint32_t* out) {
  ctpu::FieldConsts fc = {};
  for (int i = 0; i < L; ++i) fc.p[i] = p16[i];
  uint32_t p[L / 2];
  ctpu::p_words<L>(fc, p);
  for (int i = 0; i < L / 2; ++i) out[i] = p[i];
}

// (L, n) limb planes a and out; b (L, n) with b_lane = 1, b_limb = n, or a
// column (L, 1) with b_lane = 0, b_limb = 1
extern "C" void host_mont_mul(int L, const uint32_t* a, const uint32_t* b,
                              long long b_lane, long long b_limb,
                              uint32_t* out, long long n,
                              const uint32_t* p16, uint32_t n0inv32) {
  if (L == 4) mont_mul_lanes<4>(a, b, b_lane, b_limb, out, n, p16, n0inv32);
  else mont_mul_lanes<16>(a, b, b_lane, b_limb, out, n, p16, n0inv32);
}

// (n, L) limb rows -> (n, L / 2) words and back to (n, L) limbs
extern "C" void host_pack(int L, const uint32_t* limbs, uint32_t* words,
                          uint32_t* back, long long n) {
  if (L == 4) pack_rows<4>(limbs, words, back, n);
  else pack_rows<16>(limbs, words, back, n);
}

extern "C" void host_p_words(int L, const uint32_t* p16, uint32_t* out) {
  if (L == 4) p_words<4>(p16, out);
  else p_words<16>(p16, out);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """field32.cuh built by g++ into a host library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build field32.cuh for the host")
    tmp = tmp_path_factory.mktemp("field32")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "field32_host.cpp").write_text(HOST_SRC)
    so = tmp / "field32_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
         "-I", str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp / "field32_host.cpp")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_uint32
    lib.host_mont_mul.argtypes = [I, P, P, LL, LL, P, LL, P, U]
    lib.host_pack.argtypes = [I, P, P, P, LL]
    lib.host_p_words.argtypes = [I, P, P]
    return lib


def _ptr(a):
    return a.ctypes.data


def host_mont_mul(lib, field, a, b):
    """The header's product on (L, n) planes a and b, b (L, n) or (L, 1)."""
    L, n = a.shape
    out = np.zeros_like(a)
    p16 = np.asarray(field.p_list, np.uint32)
    lane, limb = (1, n) if b.shape[1] == n else (0, 1)
    lib.host_mont_mul(L, _ptr(a), _ptr(b), lane, limb, _ptr(out), n,
                      _ptr(p16), field.n0inv32)
    return out


def plain_mont_mul(field, a, b):
    t = [torch.from_numpy(x.view(np.int32)).view(torch.uint32)
         for x in (a, b)]
    return as_i64(field.mont_mul(*t)).numpy().astype(np.uint32)


def canonical_ints(rng, p, n):
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_mont_mul32_matches_plain(host, prime):
    spec = field_spec(prime)
    L, p = spec.n_limbs, spec.p
    field = TorchField(spec)
    rng = np.random.default_rng(51)
    edges = mont_edge_values(spec)
    xs = canonical_ints(rng, p, 200) + [x for x in edges for _ in edges]
    ys = canonical_ints(rng, p, 200) + [y for _ in edges for y in edges]
    a = np.ascontiguousarray(ints_to_limbs(xs, L).T)
    b = np.ascontiguousarray(ints_to_limbs(ys, L).T)
    np.testing.assert_array_equal(host_mont_mul(host, field, a, b),
                                  plain_mont_mul(field, a, b))
    for y in edges + canonical_ints(rng, p, 2):
        col = np.ascontiguousarray(ints_to_limbs([y], L).T)      # (L, 1)
        np.testing.assert_array_equal(host_mont_mul(host, field, a, col),
                                      plain_mont_mul(field, a, col),
                                      err_msg=f"column {y}")
    # the value itself, for the edges: x * y * R^-1 mod p
    R_inv = pow(1 << (LIMB_BITS * L), -1, p)
    got = host_mont_mul(host, field, a, b)
    for j in range(200, len(xs)):
        v = sum(int(got[i, j]) << (LIMB_BITS * i) for i in range(L))
        assert v == xs[j] * ys[j] * R_inv % p


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_mont_mul32_above_p_matches_plain(host, prime):
    """Operands in [p, R), which no canonical value reaches: R - 1, p and
    p plus small values, and seeded ones, against canonical and
    non-canonical partners, full and as a broadcast column."""
    spec = field_spec(prime)
    L, p = spec.n_limbs, spec.p
    R = 1 << (LIMB_BITS * L)
    field = TorchField(spec)
    rng = np.random.default_rng(54)
    high = [R - 1, p, p + 1, p + 2 ** 16, min(2 * p, R) - 1] + [
        p + int.from_bytes(rng.bytes(2 * L), "little") % (R - p)
        for _ in range(20)]
    assert all(p <= v < R for v in high)
    low = mont_edge_values(spec) + canonical_ints(rng, p, 5)
    xs = [x for x in high for _ in high + low] + [x for x in low for _ in high]
    ys = [y for _ in high for y in high + low] + [y for _ in low for y in high]
    a = np.ascontiguousarray(ints_to_limbs(xs, L).T)
    b = np.ascontiguousarray(ints_to_limbs(ys, L).T)
    np.testing.assert_array_equal(host_mont_mul(host, field, a, b),
                                  plain_mont_mul(field, a, b))
    for y in high[:5]:
        col = np.ascontiguousarray(ints_to_limbs([y], L).T)      # (L, 1)
        np.testing.assert_array_equal(host_mont_mul(host, field, a, col),
                                      plain_mont_mul(field, a, col),
                                      err_msg=f"column {y}")


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_packing_and_n0inv32_match_python_ints(host, prime):
    spec = field_spec(prime)
    L, p = spec.n_limbs, spec.p
    field = TorchField(spec)
    assert L % 2 == 0
    assert (field.n0inv32 * p + 1) % (1 << 32) == 0
    assert field.n0inv32 % (1 << LIMB_BITS) == field.n0inv
    rng = np.random.default_rng(52)
    vals = mont_edge_values(spec) + [(1 << (LIMB_BITS * L)) - 1] + [
        int.from_bytes(rng.bytes(2 * L), "little") for _ in range(50)]
    limbs = ints_to_limbs(vals, L)
    words = np.zeros((len(vals), L // 2), np.uint32)
    back = np.zeros_like(limbs)
    host.host_pack(L, _ptr(limbs), _ptr(words), _ptr(back), len(vals))
    for j, v in enumerate(vals):
        assert [int(w) for w in words[j]] == \
            [(v >> (32 * i)) & 0xFFFFFFFF for i in range(L // 2)]
    np.testing.assert_array_equal(back, limbs)
    pw = np.zeros(L // 2, np.uint32)
    host.host_p_words(L, _ptr(int_to_limbs(p, L)), _ptr(pw))
    assert [int(w) for w in pw] == \
        [(p >> (32 * i)) & 0xFFFFFFFF for i in range(L // 2)]


def test_goldilocks_n0inv32():
    """p = 2^64 - 2^32 + 1 is 1 mod 2^32, so -p^-1 mod 2^32 is 2^32 - 1."""
    assert TorchField(field_spec("goldilocks")).n0inv32 == (1 << 32) - 1


def test_main_path_gathers_skip_the_index_check(monkeypatch):
    """TorchInterpreter's run and run_mixed never call the public gather_w
    and gather_n, whose index check is a device-to-host sync on the
    card, and still give the host calculator's witness."""
    cc = compile_source(comparators_source())
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu",
                          input_ranges=cc.input_range_hints())
    assert isinstance(prog.interp, TorchInterpreter)
    assert len(prog.interp.plan.wd_src) and len(prog.interp.plan.nw_src)

    def refuse(*args):
        raise AssertionError("a checked gather on the main path")

    monkeypatch.setattr(interp, "gather_w", refuse)
    monkeypatch.setattr(interp, "gather_n", refuse)
    x = comparator_inputs(3, 54, spec.n_limbs)
    wit = prog.run(x)
    prog.run_mixed(x)
    w = as_i64(wit).numpy()
    for lane in range(3):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        host = list(cc.witness_host({"a": ins[0], "b": ins[1]}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host
