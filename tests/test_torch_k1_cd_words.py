"""K1's K1c and K1d opcodes in 32-bit words (ops/cuda/wide32.cuh and
dot32.cuh's mod_sub32), on the CPU.

The headers are plain C++ on 32- and 64-bit integers, so g++ builds them
for the host here, beside their 16-bit versions in field.cuh and wide.cuh
(kept as these host oracles), through the CUDA-qualifier shim of
test_torch_segments.py.  Each word version takes the operands packed two
16-bit limbs a word (pack32) and its result is unpacked again, so it is
compared limb for limb with its 16-bit version and with the plain PyTorch
version of ops/wide.py, for bn128, secq256r1 and goldilocks:

- the modular subtract (sub, sub_c, csub_c);
- the comparisons and booleans by the p/2 sign rule, and the nonzero test
  of select, lnot, nsel_w and lnot_w;
- band, bor, bxor and bnot with their one conditional subtract;
- both shifts at counts 0, 1, 15, 16, 17, 31, 32, 33, bits - 1, bits, 16L
  and beyond;
- the widening of a narrow int32, nband_w's word and the long division;

on the edge operands 0, 1, p - 1, p/2, p/2 + 1 (and 2^253 on the 256-bit
primes) and seeded canonical values, every pair of them.  The goldilocks
product as one 64-bit word (gl_mul64) and the add in two words are held
against wide.cuh's gl_mul and field.cuh's mod_add<4> on 10^5 seeded pairs
of 64-bit operands and every pair of the edges 0, 1, 2^32 - 1, 2^32,
2^63 and p - 1, and against a*b mod p.  Comparisons are exact.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch.field.primes import LIMB_BITS, field_spec
from circom_tpu_torch.ops import wide
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_torch_segments import SHIM

ROOT = Path(__file__).resolve().parents[1]
PRIMES = ("bn128", "secq256r1", "goldilocks")
CMPS = ("eq", "neq", "lt", "le", "gt", "ge", "land", "lor")
BITOPS = ("band", "bor", "bxor", "bnot")

HOST_SRC = """\
#include "cuda_runtime.h"
#include "dot32.cuh"
#include "wide.cuh"
#include "wide32.cuh"

using namespace ctpu;

// The field's constants: 16-bit limbs (p, half, mask, q) for the 16-bit
// versions, the same packed into words for the word versions.
template <int L>
struct Consts {
  static constexpr int N = L / 2;
  FieldConsts fc;
  WideConsts wc;
  uint32_t p[N], half[N], mask[N], q[N];
  Consts(const uint32_t* p16, const uint32_t* half16, const uint32_t* mask16,
         const uint32_t* q16, int bits) : fc(), wc() {
    for (int i = 0; i < L; ++i) {
      fc.p[i] = p16[i];
      wc.half[i] = half16[i];
      wc.mask[i] = mask16[i];
      wc.q[i] = q16[i];
    }
    wc.bits = bits;
    pack32<L>(p16, 1, p);
    pack32<L>(half16, 1, half);
    pack32<L>(mask16, 1, mask);
    pack32<L>(q16, 1, q);
  }
};

#define CONSTS_ARGS const uint32_t *p16, const uint32_t *half16, \\
    const uint32_t *mask16, const uint32_t *q16, int bits
#define CONSTS Consts<L> k(p16, half16, mask16, q16, bits)
// F<L>(args...) for the runtime L
#define BY_L(F, ...) if (L == 4) F<4>(__VA_ARGS__); else F<16>(__VA_ARGS__)

// lane e's limbs of the (L, n) planes x
template <int L>
void limbs_of(const uint32_t* x, long long n, long long e, uint32_t (&v)[L]) {
  for (int i = 0; i < L; ++i) v[i] = x[i * n + e];
}
template <int L>
void put(const uint32_t (&v)[L], uint32_t* out, long long n, long long e) {
  for (int i = 0; i < L; ++i) out[i * n + e] = v[i];
}

// sub: a - b (csub_c is the same with the operands swapped)
template <int L>
void sub_lanes(const uint32_t* a, const uint32_t* b, uint32_t* out16,
               uint32_t* out32, long long n, CONSTS_ARGS) {
  constexpr int N = L / 2;
  CONSTS;
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L], y[L], r[L], xw[N], yw[N], rw[N];
    limbs_of<L>(a, n, e, x);
    limbs_of<L>(b, n, e, y);
    mod_sub<L>(x, y, r, k.fc);
    put<L>(r, out16, n, e);
    pack32<L>(a + e, n, xw);
    pack32<L>(b + e, n, yw);
    mod_sub32<N>(xw, yw, k.p, rw);
    unpack32<L>(rw, out32 + e, n);
  }
}

template <int L, int C>
void cmp_one(const uint32_t* a, const uint32_t* b, uint32_t* out16,
             uint32_t* out32, long long n, const Consts<L>& k) {
  constexpr int N = L / 2;
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L], y[L], xw[N], yw[N];
    limbs_of<L>(a, n, e, x);
    limbs_of<L>(b, n, e, y);
    pack32<L>(a + e, n, xw);
    pack32<L>(b + e, n, yw);
    out16[e] = cmp_wide<L, C>(x, y, k.wc);
    out32[e] = cmp32<N, C>(xw, yw, k.half);
  }
}

// comparison c (the order of WordCmp) and, for c = 8, the nonzero test
template <int L>
void cmp_lanes(int c, const uint32_t* a, const uint32_t* b, uint32_t* out16,
               uint32_t* out32, long long n, CONSTS_ARGS) {
  constexpr int N = L / 2;
  CONSTS;
  switch (c) {
    case 0: cmp_one<L, 0>(a, b, out16, out32, n, k); break;
    case 1: cmp_one<L, 1>(a, b, out16, out32, n, k); break;
    case 2: cmp_one<L, 2>(a, b, out16, out32, n, k); break;
    case 3: cmp_one<L, 3>(a, b, out16, out32, n, k); break;
    case 4: cmp_one<L, 4>(a, b, out16, out32, n, k); break;
    case 5: cmp_one<L, 5>(a, b, out16, out32, n, k); break;
    case 6: cmp_one<L, 6>(a, b, out16, out32, n, k); break;
    case 7: cmp_one<L, 7>(a, b, out16, out32, n, k); break;
    default:
      for (long long e = 0; e < n; ++e) {
        uint32_t x[L], xw[N];
        limbs_of<L>(a, n, e, x);
        pack32<L>(a + e, n, xw);
        out16[e] = nonzero<L>(x);
        out32[e] = nonzero32<N>(xw);
      }
  }
}

// band, bor, bxor, bnot (op 0..3) as interp.cu ran them in 16-bit limbs
// and as it runs them in words
template <int L>
void bitop_lanes(int op, const uint32_t* a, const uint32_t* b,
                 uint32_t* out16, uint32_t* out32, long long n,
                 CONSTS_ARGS) {
  constexpr int N = L / 2;
  CONSTS;
  for (long long e = 0; e < n; ++e) {
    uint32_t x[L], y[L], r[L], xw[N], yw[N], rw[N];
    limbs_of<L>(a, n, e, x);
    limbs_of<L>(b, n, e, y);
    for (int i = 0; i < L; ++i)
      r[i] = op == 0 ? x[i] & y[i] : op == 1 ? x[i] | y[i]
             : op == 2 ? x[i] ^ y[i] : x[i] ^ k.wc.mask[i];
    if (op != 0) cond_sub<L>(r, 0, k.fc);
    put<L>(r, out16, n, e);
    pack32<L>(a + e, n, xw);
    pack32<L>(b + e, n, yw);
    if (op == 0) bitop32<N, 0>(xw, yw, k.p, rw);
    else if (op == 1) bitop32<N, 1>(xw, yw, k.p, rw);
    else if (op == 2) bitop32<N, 2>(xw, yw, k.p, rw);
    else bnot32<N>(xw, k.mask, k.p, rw);
    unpack32<L>(rw, out32 + e, n);
  }
}

// shl_kw / shr_kw by count: the 16-bit shift reads the limbs in place,
// the word shift reads the packed words in place
template <int L, bool LEFT>
void shift_one(int count, const uint32_t* a, uint32_t* out16,
               uint32_t* out32, long long n, const Consts<L>& k) {
  constexpr int N = L / 2;
  for (long long e = 0; e < n; ++e) {
    uint32_t r[L], xw[N], rw[N];
    shift_w<L, LEFT>(a + e, n, count, r, k.fc, k.wc);
    put<L>(r, out16, n, e);
    pack32<L>(a + e, n, xw);
    shift32<N, LEFT>([&](int i) { return xw[i]; }, count, k.p, k.mask, rw);
    unpack32<L>(rw, out32 + e, n);
  }
}

template <int L>
void shift_lanes(int left, int count, const uint32_t* a, uint32_t* out16,
                 uint32_t* out32, long long n, CONSTS_ARGS) {
  CONSTS;
  if (left) shift_one<L, true>(count, a, out16, out32, n, k);
  else shift_one<L, false>(count, a, out16, out32, n, k);
}

// widen: int32 values -> field elements
template <int L>
void widen_lanes(const int32_t* v, uint32_t* out16, uint32_t* out32,
                 long long n, CONSTS_ARGS) {
  constexpr int N = L / 2;
  CONSTS;
  for (long long e = 0; e < n; ++e) {
    uint32_t r[L], rw[N];
    widen<L>(v[e], r, k.wc);
    put<L>(r, out16, n, e);
    widen32<N>(v[e], k.q, rw);
    unpack32<L>(rw, out32 + e, n);
  }
}

// nband_w: limbs 0 and 1 ANDed with a bank row's, and word 0 ANDed with
// the row's word 0
template <int L>
void nband_lanes(const uint32_t* a, const uint32_t* c16, int32_t* out16,
                 int32_t* out32, long long n) {
  constexpr int N = L / 2;
  uint32_t cw[N];
  pack32<L>(c16, 1, cw);
  for (long long e = 0; e < n; ++e) {
    uint32_t xw[N];
    pack32<L>(a + e, n, xw);
    out16[e] = (int32_t)((a[e] & c16[0]) | ((a[n + e] & c16[1]) << 16));
    out32[e] = (int32_t)(xw[0] & cw[0]);
  }
}

template <int L>
void idiv_lanes(const uint32_t* a, const uint32_t* b, uint32_t* out16,
                uint32_t* out32, long long n, CONSTS_ARGS) {
  constexpr int N = L / 2;
  CONSTS;
  for (long long e = 0; e < n; ++e) {
    uint32_t y[L], r[L], xw[N], yw[N], rw[N];
    limbs_of<L>(b, n, e, y);
    idiv<L>(a + e, n, y, r, k.wc);
    put<L>(r, out16, n, e);
    pack32<L>(a + e, n, xw);
    pack32<L>(b + e, n, yw);
    idiv32<N>([&](int i) { return xw[i]; }, yw, k.wc.bits, rw);
    unpack32<L>(rw, out32 + e, n);
  }
}

extern "C" {
void host_sub(int L, const uint32_t* a, const uint32_t* b, uint32_t* out16,
              uint32_t* out32, long long n, CONSTS_ARGS) {
  BY_L(sub_lanes, a, b, out16, out32, n, p16, half16, mask16, q16, bits);
}
void host_cmp(int L, int c, const uint32_t* a, const uint32_t* b,
              uint32_t* out16, uint32_t* out32, long long n, CONSTS_ARGS) {
  BY_L(cmp_lanes, c, a, b, out16, out32, n, p16, half16, mask16, q16, bits);
}
void host_bitop(int L, int op, const uint32_t* a, const uint32_t* b,
                uint32_t* out16, uint32_t* out32, long long n, CONSTS_ARGS) {
  BY_L(bitop_lanes, op, a, b, out16, out32, n, p16, half16, mask16, q16,
                    bits);
}
void host_shift(int L, int left, int count, const uint32_t* a,
                uint32_t* out16, uint32_t* out32, long long n, CONSTS_ARGS) {
  BY_L(shift_lanes, left, count, a, out16, out32, n, p16, half16, mask16,
                    q16, bits);
}
void host_widen(int L, const int32_t* v, uint32_t* out16, uint32_t* out32,
                long long n, CONSTS_ARGS) {
  BY_L(widen_lanes, v, out16, out32, n, p16, half16, mask16, q16, bits);
}
void host_nband(int L, const uint32_t* a, const uint32_t* c16,
                int32_t* out16, int32_t* out32, long long n) {
  BY_L(nband_lanes, a, c16, out16, out32, n);
}
void host_idiv(int L, const uint32_t* a, const uint32_t* b, uint32_t* out16,
               uint32_t* out32, long long n, CONSTS_ARGS) {
  BY_L(idiv_lanes, a, b, out16, out32, n, p16, half16, mask16, q16, bits);
}

// goldilocks: a*b by gl_mul (16-bit limbs) and gl_mul64, a + b by
// mod_add<4> and mod_add32<2>; operands as 64-bit words
void host_gl(const uint64_t* a, const uint64_t* b, uint64_t* mul16,
             uint64_t* mul64, uint64_t* add16, uint64_t* add32,
             long long n) {
  FieldConsts fc = {};
  const uint64_t p = GOLDILOCKS_P;
  for (int i = 0; i < 4; ++i) fc.p[i] = (uint32_t)(p >> (16 * i)) & 0xFFFF;
  const uint32_t pw[2] = {(uint32_t)p, (uint32_t)(p >> 32)};
  for (long long e = 0; e < n; ++e) {
    uint32_t x[4], y[4], r[4], s[4];
    for (int i = 0; i < 4; ++i) {
      x[i] = (uint32_t)(a[e] >> (16 * i)) & 0xFFFF;
      y[i] = (uint32_t)(b[e] >> (16 * i)) & 0xFFFF;
    }
    gl_mul(x, y, r, fc);
    mod_add<4>(x, y, s, fc);
    mul16[e] = add16[e] = 0;
    for (int i = 0; i < 4; ++i) {
      mul16[e] |= (uint64_t)r[i] << (16 * i);
      add16[e] |= (uint64_t)s[i] << (16 * i);
    }
    mul64[e] = gl_mul64(a[e], b[e]);
    const uint32_t xw[2] = {(uint32_t)a[e], (uint32_t)(a[e] >> 32)};
    const uint32_t yw[2] = {(uint32_t)b[e], (uint32_t)(b[e] >> 32)};
    uint32_t t[2];
    mod_add32<2>(xw, yw, pw, t);
    add32[e] = t[0] | ((uint64_t)t[1] << 32);
  }
}
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """wide32.cuh, dot32.cuh and their 16-bit versions built by g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build wide32.cuh for the host")
    tmp = tmp_path_factory.mktemp("wide32")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "wide32_host.cpp").write_text(HOST_SRC)
    so = tmp / "wide32_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
         "-I", str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"),
         "-o", str(so), str(tmp / "wide32_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(str(so))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


class Field:
    """A prime's TorchField, its constant limbs as host arrays and the
    edge operands of the word opcodes."""

    def __init__(self, prime):
        self.spec = spec = field_spec(prime)
        self.f = TorchField(spec)
        self.L, self.p = spec.n_limbs, spec.p
        self.bits = self.p.bit_length()
        self.consts = [np.asarray(v, np.uint32) for v in (
            self.f.p_list, self.f.half_list, self.f.mask_list,
            self.f.q_list)]
        p = self.p
        self.edges = [0, 1, p - 1, p // 2, p // 2 + 1] + (
            [1 << 253] if self.L == 16 else [])

    def args(self):
        return [_ptr(c) for c in self.consts] + [ctypes.c_int(self.bits)]

    def values(self, n_random, seed):
        rng = np.random.default_rng(seed)
        return self.edges + [int.from_bytes(rng.bytes(40), "little") % self.p
                             for _ in range(n_random)]


def planes(values, L):
    """ints -> (L, n) uint32 limb planes."""
    return np.ascontiguousarray(ints_to_limbs(values, L).T)


def pairs(F, n_random, seed):
    """(a, b) planes over every pair of F.values(n_random, seed)."""
    vals = F.values(n_random, seed)
    a = planes([x for x in vals for _ in vals], F.L)
    b = planes([y for _ in vals for y in vals], F.L)
    return a, b


def t64(a):
    return torch.from_numpy(a.astype(np.int64))


def out_pair(shape, dtype=np.uint32):
    return np.zeros(shape, dtype), np.zeros(shape, dtype)


@pytest.mark.parametrize("prime", PRIMES)
def test_mod_sub32_matches_16bit_and_plain(host, prime):
    F = Field(prime)
    a, b = pairs(F, 16, 81)
    n = a.shape[1]
    out16, out32 = out_pair(a.shape)
    host.host_sub(F.L, _ptr(a), _ptr(b), _ptr(out16), _ptr(out32),
                  ctypes.c_longlong(n), *F.args())
    np.testing.assert_array_equal(out32, out16)
    np.testing.assert_array_equal(out32, F.f.sub64(t64(a), t64(b)).numpy())
    got = [sum(int(out32[i, e]) << (LIMB_BITS * i) for i in range(F.L))
           for e in range(n)]
    want = [(int(x) - int(y)) % F.p for x, y in zip(
        _ints(a, F.L), _ints(b, F.L))]
    assert got == want


def _ints(x, L):
    return [sum(int(x[i, e]) << (LIMB_BITS * i) for i in range(L))
            for e in range(x.shape[1])]


@pytest.mark.parametrize("prime", PRIMES)
def test_comparisons_and_nonzero_match_16bit_and_plain(host, prime):
    F = Field(prime)
    a, b = pairs(F, 12, 82)
    n = a.shape[1]
    for c, op in enumerate(CMPS + ("nonzero",)):
        out16, out32 = out_pair((n,))
        host.host_cmp(F.L, c, _ptr(a), _ptr(b), _ptr(out16), _ptr(out32),
                      ctypes.c_longlong(n), *F.args())
        np.testing.assert_array_equal(out32, out16, err_msg=op)
        if op == "nonzero":
            want = wide.nonzero(t64(a)).numpy()
        else:
            want = wide.emit(F.f, op, t64(a), t64(b))[0].numpy()
        np.testing.assert_array_equal(out32, want, err_msg=op)
        assert 0 < int(out32.sum()) < n or op == "nonzero"


@pytest.mark.parametrize("prime", PRIMES)
def test_bit_ops_match_16bit_and_plain(host, prime):
    F = Field(prime)
    a, b = pairs(F, 12, 83)
    n = a.shape[1]
    for k, op in enumerate(BITOPS):
        out16, out32 = out_pair(a.shape)
        host.host_bitop(F.L, k, _ptr(a), _ptr(b), _ptr(out16), _ptr(out32),
                        ctypes.c_longlong(n), *F.args())
        np.testing.assert_array_equal(out32, out16, err_msg=op)
        np.testing.assert_array_equal(
            out32, wide.emit(F.f, op, t64(a), t64(b)).numpy(), err_msg=op)
        assert all(v < F.p for v in _ints(out32, F.L))


def shift_counts(F):
    return sorted({0, 1, 15, 16, 17, 31, 32, 33, F.bits - 1, F.bits,
                   16 * F.L - 1, 16 * F.L, 16 * F.L + 5, 1000})


@pytest.mark.parametrize("left", [True, False], ids=["shl", "shr"])
@pytest.mark.parametrize("prime", PRIMES)
def test_shifts_match_16bit_and_plain(host, prime, left):
    F = Field(prime)
    a = planes(F.values(40, 84), F.L)
    n = a.shape[1]
    for count in shift_counts(F):
        out16, out32 = out_pair(a.shape)
        host.host_shift(F.L, int(left), count, _ptr(a), _ptr(out16),
                        _ptr(out32), ctypes.c_longlong(n), *F.args())
        np.testing.assert_array_equal(out32, out16, err_msg=str(count))
        np.testing.assert_array_equal(
            out32, wide.shift_w(F.f, t64(a), count, left).numpy(),
            err_msg=str(count))


@pytest.mark.parametrize("prime", PRIMES)
def test_widen_matches_16bit_and_plain(host, prime):
    F = Field(prime)
    rng = np.random.default_rng(85)
    v = np.concatenate([
        np.asarray([-2 ** 31, -2 ** 31 + 1, -65536, -65535, -1, 0, 1, 65535,
                    65536, 2 ** 31 - 1], np.int64),
        rng.integers(-2 ** 31, 2 ** 31, size=300)]).astype(np.int32)
    n = len(v)
    out16, out32 = out_pair((F.L, n))
    host.host_widen(F.L, _ptr(v), _ptr(out16), _ptr(out32),
                    ctypes.c_longlong(n), *F.args())
    np.testing.assert_array_equal(out32, out16)
    np.testing.assert_array_equal(
        out32, wide.widen64(F.f, torch.from_numpy(v)).numpy())
    assert _ints(out32, F.L) == [int(x) % F.p for x in v]


@pytest.mark.parametrize("prime", PRIMES)
def test_nband_w_word_matches_16bit_and_plain(host, prime):
    F = Field(prime)
    a = planes(F.values(40, 86), F.L)
    n = a.shape[1]
    for c in F.edges + [0xFFFFFFFF, 0x8000FFFF, 0x12345678]:
        crow = np.ascontiguousarray(ints_to_limbs([c % F.p], F.L)[0])
        out16, out32 = out_pair((n,), np.int32)
        host.host_nband(F.L, _ptr(a), _ptr(crow), _ptr(out16), _ptr(out32),
                        ctypes.c_longlong(n))
        np.testing.assert_array_equal(out32, out16)
        want = wide.band_w(t64(a), t64(crow[:, None]))
        np.testing.assert_array_equal(out32, want.numpy())


@pytest.mark.parametrize("prime", PRIMES)
def test_idiv32_matches_16bit_and_plain(host, prime):
    F = Field(prime)
    a, b = pairs(F, 8, 87)
    n = a.shape[1]
    out16, out32 = out_pair(a.shape)
    host.host_idiv(F.L, _ptr(a), _ptr(b), _ptr(out16), _ptr(out32),
                   ctypes.c_longlong(n), *F.args())
    np.testing.assert_array_equal(out32, out16)
    np.testing.assert_array_equal(
        out32, wide.idiv64(F.f, t64(a), t64(b)).numpy())
    assert _ints(out32, F.L) == [x // y if y else 0 for x, y in zip(
        _ints(a, F.L), _ints(b, F.L))]


GL_EDGES = (0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
            field_spec("goldilocks").p - 1)


@pytest.mark.parametrize("operands", ["random", "edges"])
def test_goldilocks_word_product_and_add(host, operands):
    """gl_mul64 and mod_add32<2> against gl_mul and mod_add<4> bit for bit,
    and against a*b mod p and (a + b) mod p on canonical operands: 10^5
    seeded pairs of 64-bit operands (canonical and not), or every pair of
    the edges."""
    p = field_spec("goldilocks").p
    if operands == "random":
        rng = np.random.default_rng(88)
        a = rng.integers(0, 2 ** 64, size=100_000, dtype=np.uint64)
        b = rng.integers(0, 2 ** 64, size=100_000, dtype=np.uint64)
        a[:50_000] %= np.uint64(p)
        b[:50_000] %= np.uint64(p)
    else:
        a = np.asarray([x for x in GL_EDGES for _ in GL_EDGES], np.uint64)
        b = np.asarray([y for _ in GL_EDGES for y in GL_EDGES], np.uint64)
    n = len(a)
    mul16, mul64, add16, add32 = (np.zeros(n, np.uint64) for _ in range(4))
    host.host_gl(_ptr(a), _ptr(b), _ptr(mul16), _ptr(mul64), _ptr(add16),
                 _ptr(add32), ctypes.c_longlong(n))
    np.testing.assert_array_equal(mul64, mul16)
    np.testing.assert_array_equal(add32, add16)
    for x, y, m, s in zip(a.tolist(), b.tolist(), mul64.tolist(),
                          add32.tolist()):
        assert m == x * y % p
        if x < p and y < p:
            assert s == (x + y) % p
