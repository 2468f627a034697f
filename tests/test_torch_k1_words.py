"""K1's arithmetic in 32-bit words (ops/cuda/dot32.cuh), on the CPU.

The header is plain C++ on 64-bit integers, so g++ builds it for the host
here, beside field.cuh's 16-bit steps, through the CUDA-qualifier shim of
test_torch_segments.py.  For every prime of field/primes.py (L = 4 and 16):

- the lazy dot of dot2_c and dot3_c (the terms' products, the constant
  row, one Montgomery reduction in base 2^32) equals field.cuh's
  mac_cols + mont_reduce_cols bit for bit, and TorchField's
  product_cols64 + mont_reduce64, the plain executor's dot;
- the trailing REDC (one reduction of a single value) equals
  mont_reduce_cols of that value and TorchField.mont_reduce64;
- the modular add of add_c equals field.cuh's mod_add and TorchField.add64;

on seeded canonical operands, the edge operands of mont_edge_values, and
operands in [p, R) up to R - 1 (coefficients and constant rows too).
Comparisons are exact: field elements are integers.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch.field.primes import LIMB_BITS, PRIMES, field_spec
from circom_tpu_torch.ops.field import TorchField, mont_edge_values
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_torch_segments import SHIM

ROOT = Path(__file__).resolve().parents[1]

HOST_SRC = """\
#include "cuda_runtime.h"
#include "dot32.cuh"

using namespace ctpu;

// xs: (n_terms + 1, L, n) limb planes, the terms' operands then one unused
// plane; cs: (n_terms + 1, L, n), the coefficients then the constant row.
// out16 and out32: (L, n), the 16-bit and the 32-bit dot.
template <int L>
void dot_lanes(int n_terms, const uint32_t* xs, const uint32_t* cs,
               uint32_t* out16, uint32_t* out32, long long n,
               const FieldConsts& fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
  p_words<L>(fc, p);
  for (long long e = 0; e < n; ++e) {
    uint32_t cols[2 * L + 1] = {};
    uint32_t acc[2 * N + 1] = {};
    for (int t = 0; t < n_terms; ++t) {
      uint32_t x[L], c[L], xw[N], cw[N];
      for (int i = 0; i < L; ++i) {
        x[i] = xs[(t * L + i) * n + e];
        c[i] = cs[(t * L + i) * n + e];
      }
      mac_cols<L>(cols, x, c);
      pack32<L>(xs + t * L * n + e, n, xw);
      pack32<L>(cs + t * L * n + e, n, cw);
      mac32<N>(acc, xw, cw);
    }
    for (int j = 0; j < L; ++j) cols[j] += cs[(n_terms * L + j) * n + e];
    uint32_t k[N], r16[L], r32[N];
    pack32<L>(cs + n_terms * L * n + e, n, k);
    add_low32<N>(acc, k);
    mont_reduce_cols<L>(cols, r16, fc);
    mont_reduce32<N>(acc, p, fc.n0inv32, r32);
    for (int i = 0; i < L; ++i) out16[i * n + e] = r16[i];
    unpack32<L>(r32, out32 + e, n);
  }
}

// the trailing REDC of (L, n) values, as interp.cu runs it in words and
// as the 16-bit kernel ran it
template <int L>
void redc_lanes(const uint32_t* v, uint32_t* out16, uint32_t* out32,
                long long n, const FieldConsts& fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
  p_words<L>(fc, p);
  for (long long e = 0; e < n; ++e) {
    uint32_t cols[2 * L + 1], r16[L], w[N], t[2 * N + 1], r32[N];
    for (int k = 0; k < 2 * L + 1; ++k) cols[k] = k < L ? v[k * n + e] : 0;
    mont_reduce_cols<L>(cols, r16, fc);
    pack32<L>(v + e, n, w);
    for (int k = 0; k < 2 * N + 1; ++k) t[k] = k < N ? w[k] : 0;
    mont_reduce32<N>(t, p, fc.n0inv32, r32);
    for (int i = 0; i < L; ++i) out16[i * n + e] = r16[i];
    unpack32<L>(r32, out32 + e, n);
  }
}

template <int L>
void add_lanes(const uint32_t* a, const uint32_t* b, uint32_t* out16,
               uint32_t* out32, long long n, const FieldConsts& fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
  p_words<L>(fc, p);
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L], y[L], r16[L], xw[N], yw[N], r32[N];
    for (int i = 0; i < L; ++i) {
      x[i] = a[i * n + e];
      y[i] = b[i * n + e];
    }
    mod_add<L>(x, y, r16, fc);
    pack32<L>(a + e, n, xw);
    pack32<L>(b + e, n, yw);
    mod_add32<N>(xw, yw, p, r32);
    for (int i = 0; i < L; ++i) out16[i * n + e] = r16[i];
    unpack32<L>(r32, out32 + e, n);
  }
}

static FieldConsts consts(int L, const uint32_t* p16, uint32_t n0inv,
                          uint32_t n0inv32) {
  FieldConsts fc = {};
  for (int i = 0; i < L; ++i) fc.p[i] = p16[i];
  fc.n0inv = n0inv;
  fc.n0inv32 = n0inv32;
  return fc;
}

extern "C" void host_dot(int L, int n_terms, const uint32_t* xs,
                         const uint32_t* cs, uint32_t* out16,
                         uint32_t* out32, long long n, const uint32_t* p16,
                         uint32_t n0inv, uint32_t n0inv32) {
  const FieldConsts fc = consts(L, p16, n0inv, n0inv32);
  if (L == 4) dot_lanes<4>(n_terms, xs, cs, out16, out32, n, fc);
  else dot_lanes<16>(n_terms, xs, cs, out16, out32, n, fc);
}

extern "C" void host_redc(int L, const uint32_t* v, uint32_t* out16,
                          uint32_t* out32, long long n, const uint32_t* p16,
                          uint32_t n0inv, uint32_t n0inv32) {
  const FieldConsts fc = consts(L, p16, n0inv, n0inv32);
  if (L == 4) redc_lanes<4>(v, out16, out32, n, fc);
  else redc_lanes<16>(v, out16, out32, n, fc);
}

extern "C" void host_add(int L, const uint32_t* a, const uint32_t* b,
                         uint32_t* out16, uint32_t* out32, long long n,
                         const uint32_t* p16, uint32_t n0inv,
                         uint32_t n0inv32) {
  const FieldConsts fc = consts(L, p16, n0inv, n0inv32);
  if (L == 4) add_lanes<4>(a, b, out16, out32, n, fc);
  else add_lanes<16>(a, b, out16, out32, n, fc);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """dot32.cuh and field.cuh built by g++ into a host library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build dot32.cuh for the host")
    tmp = tmp_path_factory.mktemp("dot32")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "dot32_host.cpp").write_text(HOST_SRC)
    so = tmp / "dot32_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
         "-I", str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp / "dot32_host.cpp")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_uint32
    lib.host_dot.argtypes = [I, I, P, P, P, P, LL, P, U, U]
    lib.host_redc.argtypes = [I, P, P, P, LL, P, U, U]
    lib.host_add.argtypes = [I, P, P, P, P, LL, P, U, U]
    return lib


def _ptr(a):
    return a.ctypes.data


def _consts(field):
    return (_ptr(field.p16), field.n0inv, field.n0inv32)


def operand_values(spec, rng, n_random):
    """Canonical seeded values, the edge operands, and values in [p, R):
    R - 1, p, p + 1, 2p - 1 (when below R) and seeded ones."""
    L, p = spec.n_limbs, spec.p
    R = 1 << (LIMB_BITS * L)
    canon = [int.from_bytes(rng.bytes(40), "little") % p
             for _ in range(n_random)]
    high = [R - 1, p, p + 1, min(2 * p, R) - 1] + [
        p + int.from_bytes(rng.bytes(2 * L), "little") % (R - p)
        for _ in range(n_random // 4)]
    assert all(p <= v < R for v in high)
    return canon + mont_edge_values(spec) + high


def planes(values, L):
    """ints -> (L, n) uint32 limb planes."""
    return np.ascontiguousarray(ints_to_limbs(values, L).T)


def field_of(prime):
    spec = field_spec(prime)
    field = TorchField(spec)
    field.p16 = np.asarray(field.p_list, np.uint32)
    return spec, field


def as_t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("n_terms", [2, 3])
@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_dot32_matches_16bit_and_plain(host, prime, n_terms):
    spec, field = field_of(prime)
    L = spec.n_limbs
    rng = np.random.default_rng(61 + n_terms)
    vals = operand_values(spec, rng, 24)
    m = len(vals)
    n = m * m
    # each lane draws its operands, coefficients and constant row from the
    # pool; the first operand and coefficient run over every pair
    pick = rng.integers(0, m, size=(2 * n_terms + 1, n))
    pick[0] = np.repeat(np.arange(m), m)
    pick[n_terms] = np.tile(np.arange(m), m)
    xs = np.stack([planes([vals[k] for k in pick[t]], L)
                   for t in range(n_terms)]
                  + [np.zeros((L, n), np.uint32)])
    cs = np.stack([planes([vals[k] for k in pick[n_terms + t]], L)
                   for t in range(n_terms + 1)])
    out16, out32 = np.zeros((L, n), np.uint32), np.zeros((L, n), np.uint32)
    host.host_dot(L, n_terms, _ptr(xs), _ptr(cs), _ptr(out16), _ptr(out32),
                  n, *_consts(field))
    np.testing.assert_array_equal(out32, out16)
    cols = sum(field.product_cols64(as_t(xs[t]), as_t(cs[t]))
               for t in range(n_terms))
    cols[:L] += as_t(cs[n_terms])
    np.testing.assert_array_equal(out32, field.mont_reduce64(cols).numpy())
    # the value itself where V < R p, so that one subtract makes it
    # canonical: (sum x c + k) R^-1 mod p
    R = 1 << (LIMB_BITS * L)
    R_inv = pow(R, -1, spec.p)
    n_canonical = 0
    for e in range(n):
        v = sum(vals[pick[t, e]] * vals[pick[n_terms + t, e]]
                for t in range(n_terms)) + vals[pick[2 * n_terms, e]]
        if v < R * spec.p:
            got = sum(int(out32[i, e]) << (LIMB_BITS * i) for i in range(L))
            assert got == v * R_inv % spec.p
            n_canonical += 1
    assert n_canonical > n // 4


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_redc32_matches_16bit_and_plain(host, prime):
    spec, field = field_of(prime)
    L = spec.n_limbs
    vals = operand_values(spec, np.random.default_rng(63), 200)
    v = planes(vals, L)
    n = v.shape[1]
    out16, out32 = np.zeros((L, n), np.uint32), np.zeros((L, n), np.uint32)
    host.host_redc(L, _ptr(v), _ptr(out16), _ptr(out32), n, *_consts(field))
    np.testing.assert_array_equal(out32, out16)
    np.testing.assert_array_equal(out32,
                                  field.mont_reduce64(as_t(v)).numpy())
    R_inv = pow(1 << (LIMB_BITS * L), -1, spec.p)
    for e, x in enumerate(vals):
        got = sum(int(out32[i, e]) << (LIMB_BITS * i) for i in range(L))
        assert got == x * R_inv % spec.p


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_mod_add32_matches_16bit_and_plain(host, prime):
    spec, field = field_of(prime)
    L = spec.n_limbs
    vals = operand_values(spec, np.random.default_rng(64), 20)
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a, b = planes(xs, L), planes(ys, L)
    n = a.shape[1]
    out16, out32 = np.zeros((L, n), np.uint32), np.zeros((L, n), np.uint32)
    host.host_add(L, _ptr(a), _ptr(b), _ptr(out16), _ptr(out32), n,
                  *_consts(field))
    np.testing.assert_array_equal(out32, out16)
    np.testing.assert_array_equal(out32,
                                  field.add64(as_t(a), as_t(b)).numpy())
