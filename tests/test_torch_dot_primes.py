"""The interpreter's lazy dots (dot2_c, dot3_c) at each of the eight
fields that `--prime` takes.

A dot row computes V = sum x_i c_i + k over n <= 3 terms and reduces it
once: (V + M p) / R, then subtracts p as often as the field needs
(ops/field.dot_subtractions: S_n = 1 where n p is well below R; S_2 = 2
and S_3 = 3 at secq256r1, whose p is just under R = 2^256, and S_3 = 2
at bls12381).  One subtract left wrong witnesses at secq256r1.

- Poseidon2 (circuits/gen_poseidon.generate((2,), prime=...)) through
  WitnessProgram(..., device="cpu", mode="interp") (the plain K1 and K2),
  batch 8: the edge lanes (0, 0), (1, p - 1), (p - 1, p - 1), (p // 2,
  p // 2 + 1), then the four lanes of a seeded pool of 64 whose dots
  reach the most multiples of p before their subtracts (at secq256r1 at
  least 2p).  Every lane equals the port's host calculator and the JAX
  package's (`compile_source(...).witness_host`, its own compile at the
  field) and passes the R1CS check.  At secq256r1 the JAX package's scan
  path gives the same witness on four of those lanes.  (The JAX
  package's interpreter subtracts once, so at these rows the port does
  not match it: its host calculator and scan path are the reference.)
- MerkleInclusion(2) at every field: tests/test_torch_merkle_primes.py.
- Every dot row of Poseidon2's and MerkleInclusion(2)'s plans, read off
  the plan's constant bank with operands up to p - 1: the largest value
  its reduction can leave is below (S_n + 1) p; at secq256r1 188 of
  Poseidon2's 190 rows can reach 2p, at the other fields none.
- circuits/sources.ks_tapes() (the tapes chip_smoke.py runs KS on at
  every field) are test_torch_scan's TAPES and pow_div.

Comparisons are exact: field elements are integers.
"""

import random
from functools import lru_cache

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend.interp import TorchInterpreter, split_inputs
from circom_tpu_torch.backend.interp_ref import run_plan
from circom_tpu_torch.circuits.sources import (ks_tapes, merkle_source,
                                               poseidon2_source)
from circom_tpu_torch.convert import OPCODES
from circom_tpu_torch.field.primes import LIMB_BITS, PRIMES, field_spec
from circom_tpu_torch.ops.field import TorchField, as_i64
from circom_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
from test_torch_scan import POW_DIV_SRC, TAPES
import test_torch_shared as shared

B = 8
POOL = 64          # random lanes the deepest dots are picked from
JAX_LANES = 4
SOURCES = {"poseidon2": poseidon2_source, "merkle2": lambda _p:
           merkle_source(2)}


@lru_cache(maxsize=None)
def compiled(name, prime):
    """(the port's compile, its WitnessProgram on the interpreter, the JAX
    package's compile) of a circuit at a field, built once a run
    (test_torch_shared)."""
    src = SOURCES[name](prime)
    cc, _tape, prog = shared.program(src, prime, mode="interp")
    assert isinstance(prog.interp, TorchInterpreter)
    return cc, prog, shared.circuit(src, prime, package="jax")[0]


class DepthField(TorchField):
    """TorchField that records, for each lane, the most multiples of p
    that a lazy dot's reduced value held before its subtracts."""

    def mont_reduce_dot64(self, cols, n_terms):
        limbs, top = self._redc64(cols)
        v = np.concatenate([limbs.numpy(), top.numpy()[None]])
        depth = [limbs_to_int(v[:, e]) // self.p for e in range(v.shape[1])]
        self.depth = np.maximum(self.depth, depth)
        return super().mont_reduce_dot64(cols, n_terms)


def limb_rows(cols, L):
    """Input columns (ints) -> uint32 (n_inputs, L, lanes)."""
    return np.stack([ints_to_limbs(c, L).T.copy() for c in cols])


def deepest_lanes(prog, p, n, seed):
    """(columns a, b of the n lanes of a seeded pool of POOL whose dots
    reach the most multiples of p, those depths), by the plain
    executor."""
    rng = random.Random(seed)
    pool = [[rng.randrange(p) for _ in range(POOL)] for _ in range(2)]
    plan = prog.interp.plan
    field = DepthField(prog.spec)
    field.depth = np.zeros(POOL, np.int64)
    x = torch.from_numpy(limb_rows(pool, plan.L).view(np.int32)) \
        .view(torch.uint32)
    run_plan(plan, field, *(as_i64(t) for t in split_inputs(plan, x)))
    order = np.argsort(-field.depth, kind="stable")[:n]
    return [[c[e] for e in order] for c in pool], field.depth[order]


def witness_ints(wit, lane, n):
    got = wit.view(torch.int32).numpy().view(np.uint32)
    return [limbs_to_int(got[i, :, lane]) for i in range(n)]


def check_lanes(cc, cc_j, prog, cols, to_map):
    """Every lane of the run equals the port's and the JAX package's host
    calculators and passes the R1CS check; returns the input rows."""
    x = limb_rows(cols, prog.spec.n_limbs)
    wit = prog.run(x)
    for lane in range(len(cols[0])):
        ins = to_map([c[lane] for c in cols])
        host = list(cc.witness_host(ins))
        assert witness_ints(wit, lane, len(host)) == host, f"lane {lane}"
        assert list(cc_j.witness_host(ins)) == host, f"JAX, lane {lane}"
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], prog.spec,
                          device="cpu")
    assert bool(checker.check(wit).all())
    return x, wit


@pytest.mark.parametrize("prime", list(PRIMES))
def test_poseidon2_at_every_prime(prime):
    cc, prog, cc_j = compiled("poseidon2", prime)
    p = prog.spec.p
    edges = [(0, 0), (1, p - 1), (p - 1, p - 1), (p // 2, p // 2 + 1)]
    deep, depth = deepest_lanes(prog, p, B - len(edges),
                                PRIMES[prime] % 1000003)
    cols = [[e[i] for e in edges] + deep[i] for i in range(2)]
    # the deepest dots need every subtract the field gives them, never
    # more; at secq256r1 one subtract would not do
    subs = prog.field.dot_subs
    assert depth.max() <= max(subs.values())
    if prime == "secq256r1":
        assert depth.min() >= 2
    x, wit = check_lanes(cc, cc_j, prog, cols,
                         lambda v: {"inputs": v})
    if prime != "secq256r1":
        return
    scan = JaxProgram(cc_j.build_tape()[0], jax_field_spec(prime),
                      unroll_threshold=0, mode="scan",
                      input_ranges=cc_j.input_range_hints())
    lanes = slice(B - JAX_LANES, B)
    want = np.asarray(scan.run(x[..., lanes].copy()))
    got = wit.view(torch.int32).numpy().view(np.uint32)[..., lanes]
    np.testing.assert_array_equal(got, want)


def dot_rows(plan, p, L):
    """(n, the largest value its reduction leaves before the subtracts)
    of every dot row of a plan, operands up to p - 1."""
    R = 1 << (LIMB_BITS * L)
    bank = [limbs_to_int(row) for row in plan.cbank.astype(np.int64)]
    assert max(bank) < p
    out = []
    for op, _ia, _ib, _ic, _dst, _em, aux in plan.table.tolist():
        name = OPCODES[op]
        if name not in ("dot2_c", "dot3_c"):
            continue
        n = int(name[3])
        v = sum((p - 1) * bank[aux + k] for k in range(n)) + bank[aux + n]
        out.append((n, (v + (R - 1) * p) // R))
    return out


@pytest.mark.parametrize("prime", list(PRIMES))
def test_dot_rows_stay_below_their_subtracts(prime):
    """The plan's dot rows, worst case, against the field's counts."""
    spec = field_spec(prime)
    p, L = spec.p, spec.n_limbs
    subs = TorchField(spec).dot_subs
    over = {}
    for name in SOURCES:
        rows = dot_rows(compiled(name, prime)[1].interp.plan, p, L)
        if prime == "goldilocks":    # its products are K1c's gmul
            assert rows == []
            continue
        assert rows
        for n, worst in rows:
            assert worst < (subs[n] + 1) * p
        over[name] = (sum(worst >= 2 * p for _n, worst in rows), len(rows),
                      max(worst for _n, worst in rows) / p)
    if prime == "secq256r1":
        n_over, n_rows, top = over["poseidon2"]
        assert (n_over, n_rows) == (188, 190) and 3 < top < 3.1
        assert over["merkle2"][0] > 0
    elif prime != "goldilocks":
        assert all(v[0] == 0 for v in over.values())


def test_ks_tapes_are_the_scan_tests():
    """circuits/sources.ks_tapes() holds test_torch_scan's TAPES and
    pow_div, which test_torch_scan_kernel holds KS to on the CPU."""
    assert ks_tapes() == dict(TAPES, pow_div=POW_DIV_SRC)
