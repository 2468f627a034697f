"""The port's copied host modules against the JAX package's originals.

circom_tpu_torch carries verbatim copies of the host compiler (it imports
nothing of circom_tpu); these tests hold each copy to its original, the
port's compiler output to the reference's, and the port's interpreter
plan to the JAX planner's, table for table.
"""

from pathlib import Path

import ast

import numpy as np
import pytest

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.circuits.gen_poseidon import generate as jax_generate
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.dynops import lower_dynamic_ops
from circom_tpu_torch.backend.torch_backend import build_plan
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                               comparators_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import plan_from_arrays
from circom_tpu_torch.field.primes import field_spec
from test_bitpack import WORD_SRC

ROOT = Path(__file__).resolve().parents[1]

COPIES = [
    "field/__init__.py", "field/primes.py", "field/hostfield.py",
    "utils/__init__.py", "utils/reports.py",
    "frontend/__init__.py", "frontend/archive.py", "frontend/ast.py",
    "frontend/lexer.py", "frontend/parser.py", "frontend/sugar.py",
    "analysis/__init__.py", "analysis/checks.py", "analysis/reach.py",
    "analysis/type_check.py", "analysis/unknown_known.py",
    "compiler/__init__.py", "compiler/algebra.py", "compiler/dag.py",
    "compiler/executor.py", "compiler/pipeline.py", "compiler/simplify.py",
    "compiler/values.py",
    "emit/__init__.py", "emit/binfmt.py", "emit/inputs.py",
    "emit/json_out.py",
    "ops/__init__.py", "ops/limbs.py",
    "backend/__init__.py", "backend/tape.py", "backend/plan.py",
    "backend/ranges.py", "backend/bitpack.py", "backend/dynops.py",
    "backend/artifacts.py",
    "circuits/__init__.py", "circuits/gen_poseidon.py",
    "circuits/sha256.circom", "circuits/stdlib.circom",
    "circuits/mimc.circom", "circuits/merkle.circom",
    "circuits/poseidon.circom", "circuits/gen_mimc.py",
    "native/tapeval.cpp",
]

# the keys of InterpreterPlan.plan_arrays(), read off the JAX
# InterpreterProgram as attributes
PLAN_KEYS = ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
             "mat_loads", "nmat_loads", "wit_src", "win_of", "nin_of", "K",
             "KN", "n_regs", "n_nregs", "n_chunks", "calls", "opset_n",
             "opset_w")

MIXED_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal input b;
  signal output o1;
  signal output o2;
  signal output o3;
  signal inter;
  inter <== a * b + 3;
  o1 <== inter * inter + a;
  o2 <-- a < b ? (a ^ b) + 5 : (a | b) - (a & b);
  o3 <-- (o2 != 0) ? a - inter : -b + inter;
  o2 * 0 === 0;
  o3 * 0 === 0;
}
component main = T();
"""


def poseidon2_src(gen, prime):
    return gen((2,), prime=prime) + "\ncomponent main = Poseidon2();\n"


def sha256_src(package):
    return (ROOT / package / "circuits/sha256.circom").read_text() \
        + "\ncomponent main = Sha256Block();\n"


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    orig = (ROOT / "circom_tpu" / rel).read_text()
    copy = (ROOT / "circom_tpu_torch" / rel).read_text()
    assert copy == orig, f"circom_tpu_torch/{rel} differs from its original"


def test_domain_tape_is_the_reference_class():
    """backend/domain.py holds DomainTape as jax_backend.py has it."""
    orig = (ROOT / "circom_tpu/backend/jax_backend.py").read_text()
    copy = (ROOT / "circom_tpu_torch/backend/domain.py").read_text()
    body = orig[orig.index("class DomainTape"):orig.index("class WitnessProgram")]
    assert body.rstrip() in copy


def test_poseidon2_r1cs_and_tape_match(tmp_path):
    ref = jax_compile(poseidon2_src(jax_generate, "bn128"))
    port = compile_source(poseidon2_src(generate, "bn128"))
    ref.write_r1cs(str(tmp_path / "ref.r1cs"))
    port.write_r1cs(str(tmp_path / "port.r1cs"))
    assert (tmp_path / "ref.r1cs").read_bytes() == \
        (tmp_path / "port.r1cs").read_bytes()
    (t_ref, l_ref), (t_port, l_port) = ref.build_tape(), port.build_tape()
    assert t_port.ops == t_ref.ops
    assert t_port.args == t_ref.args
    assert t_port.imms == t_ref.imms
    assert l_port == l_ref


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.fixture(scope="module")
def planned():
    """case -> (JAX InterpreterProgram, port InterpreterPlan), each built
    once per module (SHA256 takes ~50 s for both packages)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _plan_both(case)
        return cache[case]
    return get


def _plan_both(case):
    name, prime = case.split("-")
    if name == "poseidon2":
        src_ref, src_port = (poseidon2_src(jax_generate, prime),
                             poseidon2_src(generate, prime))
    elif name == "sha256":
        src_ref, src_port = sha256_src("circom_tpu"), \
            sha256_src("circom_tpu_torch")
    elif name == "cmp":
        src_ref = comparators_source(
            (ROOT / "circom_tpu/circuits/stdlib.circom").read_text())
        src_port = comparators_source()
    else:
        src_ref = src_port = {"mixed": MIXED_SRC, "word": WORD_SRC,
                              "bigdiv": BIGINT_DIV_SRC}[name]
    cc_ref = jax_compile(src_ref, prime=prime)
    tape_ref, _ = cc_ref.build_tape()
    jp = JaxProgram(tape_ref, jax_field_spec(prime), unroll_threshold=0,
                    mode="interp",
                    input_ranges=cc_ref.input_range_hints()).fused
    cc = compile_source(src_port, prime=prime)
    tape, _ = cc.build_tape()
    _dt, plan = build_plan(lower_dynamic_ops(tape), field_spec(prime),
                           cc.input_range_hints())
    return jp, plan


@pytest.mark.parametrize("case", ["poseidon2-bn128", "poseidon2-goldilocks",
                                  "mixed-goldilocks", "word-goldilocks",
                                  "sha256-bn128", "bigdiv-bn128",
                                  "cmp-bn128"])
def test_plan_arrays_match_jax_planner(case, planned):
    jp, plan = planned(case)
    arrays = plan.plan_arrays()
    assert set(arrays) == set(PLAN_KEYS)
    for key in PLAN_KEYS:
        assert _same(arrays[key], getattr(jp, key)), key
    assert plan.mixed_layout() == jp.mixed_layout()


def test_bigint_div_source_is_bench_py_s():
    """circuits/sources.py's BIGINT_DIV_SRC is bench.py's, read with ast
    (importing bench.py would run its JAX set-up)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    ref = [ast.literal_eval(n.value) for n in tree.body
           if isinstance(n, ast.Assign)
           and getattr(n.targets[0], "id", "") == "BIGINT_DIV_SRC"]
    assert ref == [BIGINT_DIV_SRC]


@pytest.mark.parametrize("case", ["poseidon2-goldilocks", "bigdiv-bn128",
                                  "cmp-bn128"])
def test_k1cd_plans_convert_from_both_planners(case, planned):
    """plan_from_arrays takes the plans of the K1c/K1d paths from the
    port's planner and from the JAX one, into the same device plan."""
    jp, plan = planned(case)
    a = plan_from_arrays(plan.plan_arrays(), "cpu")
    b = plan_from_arrays({k: getattr(jp, k) for k in PLAN_KEYS}, "cpu")
    for name in ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
                 "nw_src", "wd_src", "consts"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.opcodes == b.opcodes and len(a.parts) >= 2
