"""Kernel KC's coefficient classes, row sums and in-place windows
(ops/cuda/check.cu, backend/checker.py), on the CPU.

check.cu is built by g++ for the host (the fixture `kchost` of
test_torch_check_kernel.py: the launch replaced by a loop over the 2-D
grid and the lanes, atomicMin by a plain minimum) and called through the
checker's own argument list (`kc_args`) on CPU tensors:

- the class of each coefficient at the edges (1, p - 1, 2, p - 2,
  2^32 - 1, p - (2^32 - 1), 2^32, p - 2^32 and 0) at every field KC is
  built for, in the checker's entries too, and KC on rows of each;
- the worst case of the accumulators (circuits/sources.kc_extreme_r1cs)
  at L = 4 (goldilocks), 16 (bn128, secq256r1) and 24 (the base field of
  BLS12-381): every wire -1 (canonical, and as the largest k p - 1 below
  R), or R - 1, coefficients at each class's largest in both signs, rows
  of 61 wide and 228 small terms, a C of 4,096 small terms, empty A, B
  and C;
- the headroom check that replaces any run-time test in the kernel, at
  its exact edge, and the refusal of a row beyond it;
- random rows of mixed classes (random_r1cs(classes=True)), good and
  corrupted lanes;
- windows of a wider batch read in place with its batch stride, against
  the plain route on contiguous copies of the same lanes, and on another
  device one launch a batch (a window only where `lanes=` caps it).

The plain route (`first_violated_plain`) is KC's oracle, and on the
extreme and mixed systems at bn128 and goldilocks the JAX checker's
verdicts equal it too.  Every comparison is exact: tolerance 0 on the
first violated rows.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend import checker as checker_mod
from circom_tpu_torch.backend.checker import (KC_BLOCKS, KC_SMALL, KC_UNIT,
                                              KC_WIDE, R1CSChecker, kc_class,
                                              kc_headroom, kc_window)
from circom_tpu_torch.circuits.sources import kc_extreme_r1cs, random_r1cs
from circom_tpu_torch.field.primes import LIMB_BITS, FieldSpec, field_spec
from circom_tpu_torch.ops import build
from test_torch_check_kernel import (BLS12381_Q, as_tensor, host_first,
                                     kchost)  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parents[1]
PRIMES = ["goldilocks", "bn128", "bls12381", "secq256r1", "bls12381_base"]


def spec_of(name):
    return FieldSpec(name, BLS12381_Q) if name == "bls12381_base" \
        else field_spec(name)


def edges(p):
    """(coefficient, its class, neg, |c|) at the class boundaries."""
    w = (1 << 32) - 1
    return [(1, KC_UNIT, False, 1), (p - 1, KC_UNIT, True, 1),
            (2, KC_SMALL, False, 2), (p - 2, KC_SMALL, True, 2),
            (w, KC_SMALL, False, w), (p - w, KC_SMALL, True, w),
            (w + 1, KC_WIDE, False, w + 1), (p - w - 1, KC_WIDE, True, w + 1),
            (0, KC_SMALL, False, 0)]


def entry_classes(checker, mi):
    """(column, class, neg) of every entry of matrix mi, row by row."""
    ptr, ent = checker.kc[mi]
    N = checker.field.L // 2
    words = ent.view(torch.int32).numpy().view(np.uint32).tolist()
    out, k = [], 0
    while k < int(ptr[-1]):
        e = words[k]
        out.append((e >> 3, (e >> 1) & 3, bool(e & 1)))
        k += {KC_WIDE: 1 + N, KC_SMALL: 2, KC_UNIT: 1}[(e >> 1) & 3]
    return out


def kc_vs_plain(lib, checker, z):
    """KC built for the host against the plain route on z; returns the
    first violated rows."""
    want = checker.first_violated_plain(as_tensor(z))
    got = host_first(lib, checker, z)
    assert got.tolist() == want.tolist()
    return want


def jax_first(rows, n_wires, spec, z):
    ok, first = jax.jit(JaxChecker(rows, n_wires, jax_field_spec(spec.name))
                        .check_detailed)(z)
    return np.where(np.asarray(ok), len(rows), np.asarray(first)).tolist()


@pytest.mark.parametrize("prime", PRIMES)
def test_class_edges(kchost, prime):
    """kc_class at the edges; the checker's entries carry those classes;
    KC on a row a coefficient (z2 = c z1, lanes corrupted) equals the
    plain route."""
    spec = spec_of(prime)
    p, L = spec.p, spec.n_limbs
    cases = edges(p)
    for c, cls, neg, m in cases:
        assert kc_class(c, p) == (cls, neg, m)
    rng = np.random.default_rng(5)
    B = 6
    x = [int(v) % p for v in rng.integers(0, 1 << 62, size=B)]
    # wire 0 = 1, wire 1 = x; row j: (c_j x) * 1 = w_{2+j}
    rows = [({1: c}, {0: 1}, {2 + j: 1}) for j, (c, *_) in enumerate(cases)]
    vals = [[1] * B, x] + [[c * v % p for v in x] for c, *_ in cases]
    vals[2 + 4][1] ^= 1          # lane 1 fails at row 4, lane 4 at row 7
    vals[2 + 7][4] = (vals[2 + 7][4] + 1) % p
    z = np.array([[[(v >> (LIMB_BITS * k)) & 0xFFFF for v in w]
                   for k in range(L)] for w in vals], np.uint32)
    checker = R1CSChecker(rows, len(vals), spec, device="cpu")
    assert [(col, cls, neg) for col, cls, neg in entry_classes(checker, 0)] \
        == [(1, cls, neg) for _c, cls, neg, _m in cases]
    assert kc_vs_plain(kchost, checker, z).tolist() == \
        [len(rows), 4, len(rows), len(rows), 7, len(rows)]


EXTREME = ["goldilocks", "bn128", "secq256r1", "bls12381_base"]


@pytest.fixture(scope="module")
def extreme():
    return {name: kc_extreme_r1cs(spec_of(name), 16) for name in EXTREME}


@pytest.mark.parametrize("blocks", [KC_BLOCKS, 3])
@pytest.mark.parametrize("prime", EXTREME)
def test_extreme_rows(kchost, extreme, monkeypatch, prime, blocks):
    """The accumulators' worst case: lanes at -1 hold every row, canonical
    or not; R - 1 fails at row 0; lane 3 + j fails at row j % 8; KC equals
    the plain route with one row a block and with 3 chunks."""
    monkeypatch.setattr(checker_mod, "KC_BLOCKS", blocks)
    spec = spec_of(prime)
    rows, z = extreme[prime]
    checker = R1CSChecker(rows, z.shape[0], spec, device="cpu")
    first = kc_vs_plain(kchost, checker, z).tolist()
    assert first == [8, 8, 0] + [j % 8 for j in range(13)]
    # the classes the rows were built to hold, each in both signs
    seen = {(cls, neg) for mi in range(3)
            for _c, cls, neg in entry_classes(checker, mi)}
    assert seen == {(c, n) for c in (KC_UNIT, KC_SMALL, KC_WIDE)
                    for n in (False, True)}


@pytest.mark.parametrize("prime", ["goldilocks", "bn128"])
def test_extreme_rows_plain_matches_jax(extreme, prime):
    spec = spec_of(prime)
    rows, z = extreme[prime]
    checker = R1CSChecker(rows, z.shape[0], spec, device="cpu")
    assert checker.first_violated_plain(as_tensor(z)).tolist() == \
        jax_first(rows, z.shape[0], spec, z)


def sums(rows, mi, p, L):
    """(stored wide sum, small and unit sum, has wide terms) of each row
    of matrix mi, as kc_matrix adds them."""
    shift = pow(2, 32 * (L // 2 - 1), p)
    out = []
    for row in rows:
        cls = [kc_class(c, p) for c in row[mi].values()]
        out.append((sum(m * shift % p for k, _n, m in cls if k == KC_WIDE),
                    sum(m for k, _n, m in cls if k != KC_WIDE),
                    any(k == KC_WIDE for k, _n, _m in cls)))
    return out


@pytest.mark.parametrize("prime", PRIMES)
def test_headroom_edge(extreme, prime):
    """kc_headroom is check.cu's bound, (R - 1) S < 2^(32 J) p at the least
    depth J = KC_J (N - 1 + KC_J with wide terms), at its exact edge on
    each path; the extreme rows sit far inside it (a factor 2^16 at
    least), so no row is split."""
    spec = spec_of(prime)
    p, L = spec.p, spec.n_limbs
    N, R, J = L // 2, 1 << (LIMB_BITS * L), checker_mod.KC_J
    # without wide terms: S below 2^(32J) p / (R - 1)
    s = ((p << (32 * J)) - 1) // (R - 1)
    assert kc_headroom(p, L, 0, s, False)
    assert not kc_headroom(p, L, 0, s + 1, False)
    assert s > 1 << 60
    # with wide terms: K = N - 1 + J words, small terms at word N - 1
    K = N - 1 + J
    w = ((p << (32 * K)) - 1) // (R - 1)
    assert kc_headroom(p, L, w, 0, True)
    assert not kc_headroom(p, L, w + 1, 0, True)
    assert w > p << 31
    s_w = w >> (32 * (N - 1))
    assert kc_headroom(p, L, 0, s_w, True)
    assert not kc_headroom(p, L, 0, s_w + 1, True)
    if prime in extreme:
        rows, _z = extreme[prime]
        for mi in range(3):
            for wide_sum, narrow_sum, wide in sums(rows, mi, p, L):
                assert kc_headroom(p, L, wide_sum << 16, narrow_sum << 16,
                                   wide)


def test_headroom_refusal_and_depths(monkeypatch):
    """check.cu reduces a row sum without wide terms by KC_J words, C's by
    twice as many beside two reduced factors, and checker.KC_J is that
    least depth; with no word of reduction (KC_J = 0) a row of one unit
    term is beyond the headroom (R - 1 > p), and the checker refuses it."""
    src = (ROOT / "circom_tpu_torch/ops/cuda/check.cu").read_text()
    j = int(re.search(r"constexpr int KC_J = (\d+);", src).group(1))
    assert "row_sum<L, KC_J>" in src and "row_sum<L, 2 * KC_J>" in src
    assert checker_mod.KC_J == j
    spec = field_spec("bn128")
    rows = [({1: 1}, {1: 1}, {2: 1})]
    R1CSChecker(rows, 3, spec, device="cpu")
    monkeypatch.setattr(checker_mod, "KC_J", 0)
    with pytest.raises(ValueError, match="row 0 of matrix A"):
        R1CSChecker(rows, 3, spec, device="cpu")


def corrupt(z, k, n_rows_wires, seed):
    """Flip a bit of a limb of one wire past the inputs in every 3rd lane
    (k lanes at most)."""
    rng = np.random.default_rng(seed)
    z = z.copy()
    lanes = list(range(1, z.shape[-1], 3))[:k]
    for lane in lanes:
        w = int(rng.integers(z.shape[0] - n_rows_wires, z.shape[0]))
        z[w, int(rng.integers(z.shape[1])), lane] ^= 1 << int(
            rng.integers(16))
    return z, lanes


@pytest.mark.parametrize("prime", PRIMES)
def test_mixed_classes(kchost, prime):
    """Random rows whose coefficients fall evenly in the six classes (every
    row sum of A and B mixes them), good and corrupted lanes: KC equals
    the plain route, and the plain route the JAX checker (bn128,
    goldilocks)."""
    spec = spec_of(prime)
    rows, z = random_r1cs(spec, 8, 30, 9, 24, seed=17, classes=True)
    bad, lanes = corrupt(z, 6, 30, 18)
    checker = R1CSChecker(rows, z.shape[0], spec, device="cpu")
    assert kc_vs_plain(kchost, checker, z).tolist() == [30] * 24
    first = kc_vs_plain(kchost, checker, bad).tolist()
    assert all(k in lanes for k, f in enumerate(first) if f < 30)
    assert sum(f < 30 for f in first) >= 4
    cls = entry_classes(checker, 0) + entry_classes(checker, 1)
    assert {c for _w, c, _n in cls} == {KC_UNIT, KC_SMALL, KC_WIDE}
    if prime in ("bn128", "goldilocks"):
        assert first == jax_first(rows, z.shape[0], spec, bad)


@pytest.mark.parametrize("prime", ["goldilocks", "bn128", "bls12381_base"])
def test_window_in_place(kchost, prime):
    """A window z[..., s:s + n] of a wider batch, passed as it is (its
    pointer at lane s, its batch stride beside its lane count), equals
    the plain route on a contiguous copy of the same lanes."""
    spec = spec_of(prime)
    rows, z = random_r1cs(spec, 8, 30, 9, 20, seed=23, classes=True)
    bad, _lanes = corrupt(z, 7, 30, 24)
    checker = R1CSChecker(rows, z.shape[0], spec, device="cpu")
    whole = as_tensor(bad)
    for s, e in ((0, 7), (5, 13), (13, 20), (19, 20)):
        view = whole[..., s:e]
        assert kc_window(view, spec.n_limbs) and not view.is_contiguous()
        assert view.stride() == (spec.n_limbs * 20, 20, 1)
        first = torch.full((e - s,), checker.n_rows, dtype=torch.int32)
        rc = kchost.ctpu_r1cs_check(*checker_mod.kc_args(checker, view,
                                                         first, None))
        assert rc == 0
        want = checker.first_violated_plain(view.contiguous())
        assert first.tolist() == want.tolist()
    assert not kc_window(whole[..., ::2], spec.n_limbs)


@pytest.mark.parametrize("lanes, windows", [(None, [(20, 20)]),
                                            (8, [(8, 20), (8, 20),
                                                 (4, 20)])])
def test_card_windows_in_place(monkeypatch, lanes, windows):
    """On another device the check launches KC once a batch, or once a
    window where `lanes=` caps it, each window a view of the batch (its
    pointer, lane count and batch stride as passed); the CPU keeps its
    contiguous slices of the byte budget."""
    spec = field_spec("bn128")
    rows, z = random_r1cs(spec, 4, 10, 4, 20, seed=29)
    cpu = R1CSChecker(rows, z.shape[0], spec, device="cpu", lanes=lanes)
    assert cpu.lanes == (lanes or checker_mod.CPU_LANES)
    port = cpu.for_device("meta")
    calls = []
    monkeypatch.setattr(build, "library", lambda name: type(
        "Lib", (), {"ctpu_r1cs_check": f"{name}.ctpu_r1cs_check"}))
    monkeypatch.setattr(build, "launch",
                        lambda name, fn, dev, *a: calls.append(a))
    monkeypatch.setattr(build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(R1CSChecker, "first_violated_plain", None)
    zm = as_tensor(z).to("meta")
    out = list(port.verdicts(zm))
    assert len(out) == len(windows)
    assert [(a[2], a[3]) for a in calls] == windows
    # a batch not in KC's layout is made contiguous once, then windowed
    calls.clear()
    list(port.verdicts(zm.transpose(0, 1).contiguous().transpose(0, 1)))
    assert [(a[2], a[3]) for a in calls] == windows
