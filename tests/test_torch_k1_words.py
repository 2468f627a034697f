"""K1's arithmetic in 32-bit words (ops/cuda/dot32.cuh), on the CPU.

The header is plain C++ on 64-bit integers, so g++ builds it for the host
here, beside field.cuh's 16-bit steps, through the CUDA-qualifier shim of
test_torch_segments.py.  For every prime of field/primes.py (L = 4 and 16):

- the lazy dot of dot2_c and dot3_c (the terms' products, the constant
  row, one Montgomery reduction in base 2^32, then the field's S_n
  subtracts of p) equals the exact integer (sum x_i c_i + k) R^-1 mod p,
  computed with Python ints, on every lane of canonical operands (x_i =
  c_i = k = p - 1 included), and TorchField's product_cols64 +
  mont_reduce_dot64, the plain executor's dot, bit for bit on every lane
  (operands in [p, R) too); where S_n = 1 it also equals field.cuh's
  mac_cols + mont_reduce_cols, which subtract once;
- the count S_n (dot32.cuh dot_subtractions, which K1's launch computes)
  equals ops/field.dot_subtractions at every prime and at odd moduli from
  just above R / 2^k to R - 1;
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
from circom_tpu_torch.ops.field import (TorchField, dot_subtractions,
                                        mont_edge_values)
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_torch_segments import SHIM

ROOT = Path(__file__).resolve().parents[1]

HOST_SRC = """\
#include "cuda_runtime.h"
#include "dot32.cuh"

using namespace ctpu;

// xs: (n_terms + 1, L, n) limb planes, the terms' operands then one unused
// plane; cs: (n_terms + 1, L, n), the coefficients then the constant row.
// out16 and out32: (L, n), the 16-bit dot (one subtract) and K1's dot
// (the field's count of subtracts).
template <int L>
void dot_lanes(int n_terms, const uint32_t* xs, const uint32_t* cs,
               uint32_t* out16, uint32_t* out32, long long n,
               const FieldConsts& fc) {
  constexpr int N = L / 2;
  uint32_t p[N];
  p_words<L>(fc, p);
  const int subs = dot_subtractions<N>(p, n_terms);
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
    if (n_terms == 3)
      mont_reduce_dot32<N, 3>(acc, p, fc.n0inv32, subs, r32);
    else
      mont_reduce_dot32<N, 2>(acc, p, fc.n0inv32, subs, r32);
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

template <int N>
void words_of16(const uint32_t* p16, uint32_t (&p)[N]) {
  for (int i = 0; i < N; ++i) p[i] = p16[2 * i] | (p16[2 * i + 1] << 16);
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

extern "C" int host_dot_subs(int L, int n_terms, const uint32_t* p16) {
  if (L == 4) {
    uint32_t p[2];
    words_of16<2>(p16, p);
    return dot_subtractions<2>(p, n_terms);
  }
  uint32_t p[8];
  words_of16<8>(p16, p);
  return dot_subtractions<8>(p, n_terms);
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
    lib.host_dot_subs.argtypes = [I, I, P]
    lib.host_dot_subs.restype = I
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


def reduced_dot(ops, n_terms, p, R):
    """(V, (V + M p) / R before any subtract) of a dot's operands
    x_1..x_n, c_1..c_n, k, exact."""
    v = sum(ops[t] * ops[n_terms + t] for t in range(n_terms)) \
        + ops[2 * n_terms]
    return v, (v + (-v * pow(p, -1, R) % R) * p) // R


def deepest_lanes(n_terms, p, R, subs, count=4):
    """Canonical dots whose reduced value needs all `subs` subtracts
    (>= subs p): x_i = c_i = p - 1 and k = p - 1 - j, the first j that
    get there.  x = c = k = p - 1 alone does not at secq256r1: its M is
    tiny."""
    lanes = [[p - 1] * (2 * n_terms + 1)]
    for j in range(1, 4096):
        ops = [p - 1] * (2 * n_terms) + [p - 1 - j]
        if reduced_dot(ops, n_terms, p, R)[1] >= subs * p:
            lanes.append(ops)
            if len(lanes) > count:
                break
    return lanes


@pytest.mark.parametrize("n_terms", [2, 3])
@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_dot32_matches_16bit_and_plain(host, prime, n_terms):
    """K1's dot (g++) and the plain dot against the exact integer on the
    canonical lanes, against each other on every lane, and against the
    16-bit dot where one subtract is the field's count."""
    spec, field = field_of(prime)
    L, p = spec.n_limbs, spec.p
    R = 1 << (LIMB_BITS * L)
    subs = field.dot_subs[n_terms]
    rng = np.random.default_rng(61 + n_terms)
    vals = operand_values(spec, rng, 24)
    m = len(vals)
    n_canon = sum(v < p for v in vals)
    assert all(v < p for v in vals[:n_canon])
    # each lane draws its operands, coefficients and constant row from the
    # pool (odd lanes the rest from its canonical values); the first
    # operand and coefficient run over every pair; then the lanes of
    # deepest_lanes, p - 1 everywhere first
    pick = rng.integers(0, m, size=(2 * n_terms + 1, m * m))
    pick[:, 1::2] = rng.integers(0, n_canon, size=pick[:, 1::2].shape)
    pick[0] = np.repeat(np.arange(m), m)
    pick[n_terms] = np.tile(np.arange(m), m)
    lanes = [[vals[k] for k in col] for col in pick.T] \
        + deepest_lanes(n_terms, p, R, subs)
    n = len(lanes)
    xs = np.stack([planes([ops[t] for ops in lanes], L)
                   for t in range(n_terms)]
                  + [np.zeros((L, n), np.uint32)])
    cs = np.stack([planes([ops[n_terms + t] for ops in lanes], L)
                   for t in range(n_terms + 1)])
    out16, out32 = np.zeros((L, n), np.uint32), np.zeros((L, n), np.uint32)
    host.host_dot(L, n_terms, _ptr(xs), _ptr(cs), _ptr(out16), _ptr(out32),
                  n, *_consts(field))
    cols = sum(field.product_cols64(as_t(xs[t]), as_t(cs[t]))
               for t in range(n_terms))
    cols[:L] += as_t(cs[n_terms])
    np.testing.assert_array_equal(
        out32, field.mont_reduce_dot64(cols, n_terms).numpy())
    if subs == 1:
        np.testing.assert_array_equal(out32, out16)
    # the exact value on every lane of canonical operands: (sum x c + k)
    # R^-1 mod p; the reduced value before the subtracts stays below
    # (subs + 1) p, and lanes reach subs p where the field allows
    R_inv = pow(R, -1, p)
    n_canonical, deepest = 0, 0
    for e, ops in enumerate(lanes):
        if max(ops) >= p:
            continue
        v, reduced = reduced_dot(ops, n_terms, p, R)
        got = sum(int(out32[i, e]) << (LIMB_BITS * i) for i in range(L))
        assert got == v * R_inv % p, f"lane {e}"
        assert reduced < (subs + 1) * p
        deepest = max(deepest, reduced // p)
        n_canonical += 1
    assert n_canonical > n // 4
    assert deepest == subs


def test_dot_subtractions_host_matches_python(host):
    """dot32.cuh's count of subtracts (K1's launch computes it from p)
    equals ops/field.dot_subtractions at every prime, and at odd moduli
    of 2 and 8 words from R / 16 up to R - 1, where the count grows."""
    moduli = {4: [], 16: []}
    for prime in PRIMES:
        spec = field_spec(prime)
        moduli[spec.n_limbs].append(spec.p)
    rng = np.random.default_rng(66)
    for L in moduli:
        R = 1 << (LIMB_BITS * L)
        moduli[L] += [R - 1, R - 3, R // 2 + 1, R // 2 - 1, R // 3 | 1,
                      R // 4 + 1, R // 4 - 1, R // 16 + 1]
        moduli[L] += [int.from_bytes(rng.bytes(2 * L), "little") | 1
                      | (R >> 4) for _ in range(16)]
    seen = set()
    for L, ps in moduli.items():
        for p in ps:
            p16 = np.asarray(ints_to_limbs([p], L)[0], np.uint32)
            for n_terms in (2, 3):
                want = dot_subtractions(p, n_terms, LIMB_BITS * L)
                assert host.host_dot_subs(L, n_terms, _ptr(p16)) == want, \
                    (L, hex(p), n_terms)
                assert 1 <= want <= n_terms
                seen.add(want)
    assert seen == {1, 2, 3}
    counts = {prime: TorchField(field_spec(prime)).dot_subs
              for prime in PRIMES}
    assert counts["secq256r1"] == counts["goldilocks"] == {2: 2, 3: 3}
    assert counts["bls12381"] == {2: 1, 3: 2}
    for prime in ("bn128", "grumpkin", "pallas", "vesta", "bls12377"):
        assert counts[prime] == {2: 1, 3: 1}


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
