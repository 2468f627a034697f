"""The port's interpreter on the fused-backend circuits, against the JAX
package and the host calculator.

The circuits of test_fused.py (mixed comparisons and bit ops, wide shifts,
the narrow bit circuit, range-hinted inputs, the regrouped narrow sum,
emission chunking and multi-call paging, the split-sum bit decomposition),
the bigint-div and stdlib comparator circuits, and two circuits written to
reach the remaining opcodes run through the port's compiler, planner and
plain executor at goldilocks and at bn128, batch 3, inputs made from a
seed with numpy.  Each witness must equal, bit for bit, the JAX
WitnessProgram's scan path on the CPU (plain jnp) and the host calculator;
at goldilocks also the JAX interpreter kernel run eagerly in Pallas
interpret mode, and the JAX planner's tables run by the port's executor.
Each case asserts the K1c/K1d opcodes its plan holds; with the unit plan
of the wide comparisons, which no planned circuit emits, the file reaches
every opcode of K1c and K1d.
"""

import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.backend.interp import InterpreterProgram as JaxInterp
from circom_tpu.backend.jax_backend import DomainTape as JaxDomainTape
from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.backend.ranges import narrow_nodes as jax_narrow_nodes
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops.limb_emit import LimbEmitter
from circom_tpu_torch.backend.domain import DomainTape
from circom_tpu_torch.backend.dynops import lower_dynamic_ops
from circom_tpu_torch.backend.interp import TorchInterpreter
from circom_tpu_torch.backend.interp_plan import InterpreterPlan
from circom_tpu_torch.backend.interp_ref import run_plan
from circom_tpu_torch.backend.ranges import narrow_nodes
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                               comparator_inputs,
                                               comparators_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import (CMP_OPS, K1C_OPCODES, K1D_OPCODES,
                                      plan_from_arrays, unit_arrays,
                                      unit_inputs)
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.field import GOLDILOCKS_P, TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_fused import BITSUM_SRC, MIXED_SRC

PRIMES = ("goldilocks", "bn128")
BATCH = 3
PLAN_KEYS = ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
             "mat_loads", "nmat_loads", "wit_src", "win_of", "nin_of", "K",
             "KN", "n_regs", "n_nregs", "n_chunks", "calls", "opset_n",
             "opset_w")

WIDE_SHIFTS_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal output o1;
  signal output o2;
  o1 <-- a >> 3;
  o2 <-- a << 5;
  o1 * 0 === 0;
  o2 * 0 === 0;
}
component main = T();
"""

NARROW_BITS_SRC = """
pragma circom 2.0.0;
template T() {
  signal input x;
  signal output o1;
  signal output o2;
  signal output o3;
  signal b[4];
  b[0] <-- x & 1;
  b[1] <-- (x >> 1) & 1;
  b[2] <-- (x >> 2) & 1;
  b[3] <-- (x >> 3) & 1;
  for (var i = 0; i < 4; i++) { b[i] * (b[i] - 1) === 0; }
  o1 <== b[0] + b[1] - 2*b[0]*b[1];
  o2 <== b[2] * (b[0] + b[1] - 2*o1) + o1;
  o3 <-- (b[3] != 0) ? o1 : o2;
  o3 * 0 === 0;
}
component main = T();
"""

RANGE_HINTED_SRC = """
pragma circom 2.0.0;
template T() {
  signal input b[4];
  signal output o[4];
  for (var i = 0; i < 4; i++) { b[i] * (b[i] - 1) === 0; }
  for (var i = 0; i < 4; i++) {
    o[i] <== b[i] + b[(i+1)%4] - 2*b[i]*b[(i+1)%4];
  }
}
component main = T();
"""

NARROW_SUM_SRC = """
pragma circom 2.0.0;
template T() {
  signal input x;
  signal output o;
  signal b[40];
%s
  o <== %s;
}
component main = T();
""" % ("\n".join(f"  b[{i}] <-- (x >> {i}) & 1;\n"
                 f"  b[{i}] * (b[{i}] - 1) === 0;" for i in range(40)),
       " + ".join(f"b[{i}] * {1 << (i % 34)}" for i in range(40)))

MULTI_CALL_SRC = """
pragma circom 2.0.0;
template T() { signal input x; signal output y[4];
  y[0] <== x * x + 1;
  y[1] <== y[0] * x + 2;
  y[2] <== y[1] * y[0];
  y[3] <== y[2] * x - y[1];
}
component main = T();
"""

# the rest of K1d's wide-lane opcodes: shl_kw, bnot, sub_c, csub_c,
# lnot_w, idiv and the *_ww comparisons of two wide values
WIDE_OPS_SRC = """
pragma circom 2.0.0;
template WideOps() {
  signal input a;
  signal input b;
  signal output o[12];
  o[0] <-- a << 5;
  o[1] <-- ~a;
  o[2] <-- a - 7;
  o[3] <-- !a;
  o[4] <-- a == b;
  o[5] <-- a <= b;
  o[6] <-- a > b;
  o[7] <-- a >= b;
  o[8] <-- a && b;
  o[9] <-- a || b;
  o[10] <-- a \\ b;
  o[11] <-- 7 - a;
  for (var i = 0; i < 12; i++) { o[i] * 0 === 0; }
}
component main = WideOps();
"""

# the rest of K1d's narrow-result opcodes, on bit inputs (narrow by their
# constraints) and one wide input w
NARROW_OPS_SRC = """
pragma circom 2.0.0;
template NarrowOps() {
  signal input x[4];
  signal input w;
  signal output n[16];
  for (var i = 0; i < 4; i++) { x[i] * (x[i] - 1) === 0; }
  n[0] <-- x[0] - x[1];
  n[1] <-- x[0] ? x[1] : x[2];
  n[2] <-- (x[0] + x[1] + x[2]) \\ (x[3] + 1);
  n[3] <-- !x[0];
  n[4] <-- x[0] == x[1];
  n[5] <-- x[0] != x[1];
  n[6] <-- x[0] < x[1];
  n[7] <-- x[0] <= x[1];
  n[8] <-- x[0] > x[1];
  n[9] <-- x[0] >= x[1];
  n[10] <-- x[0] && x[1];
  n[11] <-- x[0] || x[1];
  n[12] <-- w ? x[1] : x[2];
  n[13] <-- (x[0] + x[1]) * 3 - x[2] * 5;
  n[14] <-- w & 255;
  n[15] <-- w * x[0];
  for (var i = 0; i < 16; i++) { n[i] * 0 === 0; }
}
component main = NarrowOps();
"""

NN = {f"{o}_nn" for o in CMP_OPS}
WW = {f"{o}_ww" for o in CMP_OPS}

# name -> (source, the K1c/K1d opcodes of its plan at goldilocks, and at
# bn128); goldilocks' plain products are gmul and gmul_c where bn128 has
# Montgomery muls
CMP_GL = {"add", "csub_c", "mul_c", "mul_one", "nband_w", "neq_ww", "select",
          "shr_kw", "sub", "widen"}
CASES = {
    "mixed": (MIXED_SRC,
              {"add", "band", "bor", "bxor", "csub_c", "gmul", "lt_ww",
               "neq_ww", "select", "sub", "widen"},
              {"add", "band", "bor", "bxor", "csub_c", "lt_ww", "neq_ww",
               "select", "sub", "widen"}),
    "wide_shifts": (WIDE_SHIFTS_SRC, {"shl_kw", "shr_kw"},
                    {"shl_kw", "shr_kw"}),
    "narrow_bits": (NARROW_BITS_SRC,
                    {"nband_w", "neq_nn", "nsel", "nsub", "shr_kw"},
                    {"nband_w", "neq_nn", "nsel", "nsub", "shr_kw"}),
    "range_hinted": (RANGE_HINTED_SRC, {"nsub"}, {"nsub"}),
    "narrow_sum": (NARROW_SUM_SRC,
                   {"add", "gmul_c", "nband_w", "shr_kw", "widen"},
                   {"add", "mul_c", "nband_w", "shr_kw", "widen"}),
    "multi_call": (MULTI_CALL_SRC, {"gmul", "sub"}, {"sub"}),
    "bitsum": (BITSUM_SRC,
               {"add", "gmul", "gmul_c", "nband_w", "shr_kw", "sub"},
               {"add", "mul_c", "mul_one", "nband_w", "shr_kw", "sub"}),
    "bigdiv": (BIGINT_DIV_SRC, {"gmul", "idiv", "sub"}, {"idiv", "sub"}),
    "comparators": (None, CMP_GL | {"gmul"}, CMP_GL - {"mul_one"} | {"nsub"}),
    "wide_ops": (WIDE_OPS_SRC,
                 {"bnot", "csub_c", "idiv", "lnot_w", "shl_kw", "sub_c"}
                 | (WW - {"lt_ww", "neq_ww"}),
                 {"bnot", "csub_c", "idiv", "lnot_w", "shl_kw", "sub_c"}
                 | (WW - {"lt_ww", "neq_ww"})),
    "narrow_ops": (NARROW_OPS_SRC,
                   NN | {"gmul", "lnot_n", "nband_w", "nidiv", "nsel",
                         "nsel_w", "nsub", "widen"},
                   NN | {"lnot_n", "nband_w", "nidiv", "nsel", "nsel_w",
                         "nsub", "widen"}),
}
# the wide-result comparisons and lnot: the planner always gives a
# comparison a narrow result (*_nn, *_ww, lnot_n, lnot_w)
UNPLANNED = set(CMP_OPS) | {"lnot"}


def source(name, package):
    if name == "comparators":
        root = Path(__file__).resolve().parents[1]
        return comparators_source(
            (root / package / "circuits/stdlib.circom").read_text())
    return CASES[name][0]


def inputs(name, prime, n_inputs, hints):
    """Input columns (ints) of one case, batch 3, from a seed."""
    spec = field_spec(prime)
    rng = np.random.default_rng(zlib.crc32(f"{name}-{prime}".encode()))
    if name == "comparators":
        # 64-bit operands; goldilocks' p is below 2^64, so they are reduced
        x = comparator_inputs(BATCH, 5, 4)
        return [[sum(int(x[i, k, b]) << (16 * k) for k in range(4)) % spec.p
                 for b in range(BATCH)] for i in range(2)]
    cols = []
    for i in range(n_inputs):
        if i in hints or name == "bitsum":
            cols.append([int(v) for v in rng.integers(0, 2, size=BATCH)])
        else:
            v = [int.from_bytes(rng.bytes(32), "little") % spec.p
                 for _ in range(BATCH)]
            if i == 0:
                v[0] = spec.p - 1       # the sign edge of the comparisons
            cols.append(v)
    return cols


@pytest.fixture(scope="module")
def runs():
    """case -> everything a test of it needs, built once per module."""
    cache = {}

    def get(name, prime):
        if (name, prime) not in cache:
            cache[name, prime] = _build(name, prime)
        return cache[name, prime]
    return get


def _build(name, prime):
    cc_ref = jax_compile(source(name, "circom_tpu"), prime=prime)
    tape_ref, _ = cc_ref.build_tape()
    hints = cc_ref.input_range_hints()
    cc = compile_source(source(name, "circom_tpu_torch"), prime=prime)
    tape, _ = cc.build_tape()
    spec = field_spec(prime)
    if name == "multi_call":
        # two emissions a chunk and four steps a call: the JAX kernel pages
        # its tables over several calls, the port runs the chunks in one
        nset, rng = narrow_nodes(tape)
        dt = DomainTape(tape, narrow=nset,
                        plain_field=spec.p == GOLDILOCKS_P, node_rng=rng)
        plan = InterpreterPlan(dt, spec, chunk_emits=2, max_call_steps=4)
        nset_r, rng_r = jax_narrow_nodes(tape_ref)
        dt_r = JaxDomainTape(tape_ref, narrow=nset_r,
                             plain_field=spec.p == GOLDILOCKS_P,
                             node_rng=rng_r)
        fused = JaxInterp(dt_r, jax_field_spec(prime), chunk_emits=2,
                          max_call_steps=4)
        assert len(fused.calls) > 1 and plan.n_chunks >= 3
        prog = TorchInterpreter(plan_from_arrays(plan.plan_arrays(), "cpu"),
                                TorchField(spec))
        run = prog._run
    else:
        wp = WitnessProgram(tape, spec, device="cpu", input_ranges=hints)
        plan, run = wp.plan, wp.run
        fused = None
    cols = inputs(name, prime, tape.n_inputs, hints)
    x = np.stack([ints_to_limbs(c, spec.n_limbs).T.copy() for c in cols])
    scan = JaxProgram(tape_ref, jax_field_spec(prime), unroll_threshold=0,
                      mode="scan", input_ranges=hints)
    return dict(cc=cc_ref, tape=tape_ref, hints=hints, plan=plan, run=run,
                fused=fused, cols=cols, x=x, want=np.asarray(scan.run(x)))


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def limbs_to_ints(a):
    return [[sum(int(a[i, k, b]) << (16 * k) for k in range(a.shape[1]))
             for b in range(a.shape[2])] for i in range(a.shape[0])]


def plan_opcodes(plan):
    arrays = plan.plan_arrays()
    names = list(arrays["opset_n"]) + list(arrays["opset_w"])
    return {names[k] for k in arrays["table"][:int(arrays["r_s0"][-1]), 0]}


def check_witness(r, name, prime):
    """The port's witness equals the JAX scan path's and the host
    calculator's; the plan holds exactly the case's K1c/K1d opcodes."""
    got = u32(r["run"](r["x"]))
    np.testing.assert_array_equal(got, r["want"])
    wit = limbs_to_ints(got)
    for b in range(BATCH):
        host = list(r["cc"].witness_host(_input_map(name, r, b)))
        assert [row[b] for row in wit[:len(host)]] == host
    want_ops = CASES[name][1 if prime == "goldilocks" else 2]
    k1cd = plan_opcodes(r["plan"]) & set(K1C_OPCODES + K1D_OPCODES)
    assert k1cd == want_ops, sorted(k1cd)


@pytest.mark.parametrize("name", list(CASES))
def test_witness_matches_jax_scan_and_host(runs, name):
    """At goldilocks; tests/test_torch_fused_bn128.py runs bn128."""
    check_witness(runs(name, "goldilocks"), name, "goldilocks")


def _input_map(name, r, b):
    """The host calculator's input map of lane b."""
    vals = [c[b] for c in r["cols"]]
    names = {"mixed": ["a", "b"], "wide_shifts": ["a"], "bigdiv": ["a", "b"],
             "comparators": ["a", "b"], "wide_ops": ["a", "b"],
             "narrow_bits": ["x"], "narrow_sum": ["x"], "multi_call": ["x"]}
    if name in names:
        return dict(zip(names[name], vals))
    if name == "range_hinted":
        return {"b": vals}
    if name == "bitsum":
        return {"a": vals[:8], "b": vals[8:]}
    return {"x": vals[:4], "w": vals[4]}      # narrow_ops


# the cases held against the JAX kernel in Pallas interpret mode (about 7 s
# each on the CPU): between them every K1c and K1d opcode a plan can hold
INTERPRET_CASES = ("mixed", "bigdiv", "wide_ops", "narrow_ops",
                   "comparators", "narrow_sum")


@pytest.mark.parametrize("name", INTERPRET_CASES)
def test_goldilocks_matches_jax_interpreter_kernel(runs, name):
    """The JAX interpreter kernel in Pallas interpret mode on the CPU, and
    its planner's tables through the port's executor."""
    r = runs(name, "goldilocks")
    fused = r["fused"] or JaxProgram(
        r["tape"], jax_field_spec("goldilocks"), unroll_threshold=0,
        mode="interp", input_ranges=r["hints"]).fused
    want = np.asarray(fused._run(r["x"]))
    np.testing.assert_array_equal(want, r["want"])
    arrays = {k: getattr(fused, k) for k in PLAN_KEYS}
    interp = TorchInterpreter(plan_from_arrays(arrays, "cpu"),
                              TorchField(field_spec("goldilocks")))
    np.testing.assert_array_equal(u32(interp._run(r["x"])), want)


@pytest.mark.parametrize("prime", PRIMES)
def test_unplanned_wide_comparisons_match_limb_emitter(prime):
    """The wide-result comparisons and lnot, which the planner never
    emits, in a unit plan through the port's executor against the JAX
    LimbEmitter on edge and random operands."""
    spec = field_spec(prime)
    L = spec.n_limbs
    arrays, cases = unit_arrays(spec.p, L, sorted(UNPLANNED))
    plan = plan_from_arrays(arrays, "cpu")
    x_w, x_n = unit_inputs(spec.p, L, 400, 9)
    bank, _ = run_plan(plan, TorchField(spec),
                       torch.from_numpy(x_w.astype(np.int64)),
                       torch.from_numpy(x_n.astype(np.int64)))
    em = LimbEmitter(jax_field_spec(prime))
    zero = jnp.zeros((400,), jnp.uint32)
    for t, (op, _aux) in enumerate(cases):
        rows = em.emit(op, lambda k, i: jnp.asarray(x_w[k, i]), None, zero)
        want = np.stack([np.asarray(jnp.broadcast_to(v, (400,)))
                         for v in rows])
        np.testing.assert_array_equal(
            bank[plan.wd_src[list(plan.wd_idx).index(t)]].numpy(),
            want.astype(np.int64), err_msg=op)


def test_file_reaches_every_k1c_and_k1d_opcode():
    reached = set(UNPLANNED)
    for ops_gl, ops_bn in ((c[1], c[2]) for c in CASES.values()):
        reached |= ops_gl | ops_bn
    assert reached == set(K1C_OPCODES) | set(K1D_OPCODES)
