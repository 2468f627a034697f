"""The port's interpreter against the JAX package and the host calculator.

The JAX interpreter plan is carried across with plan_from_arrays and run
by the port's plain executor (backend/interp_ref.py) at batch 4; the
witness must equal, bit for bit, both the JAX WitnessProgram's scan path
on the CPU (plain jnp, no Pallas) and the host calculator.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.circuits.gen_poseidon import generate as jax_generate
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.interp import TorchInterpreter
from circom_tpu_torch.backend.interp_ref import run_plan
from circom_tpu_torch.backend.plan import UnsupportedTapeOp
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import OPCODES, plan_from_arrays
from circom_tpu_torch.field.primes import FieldSpec, field_spec
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import limbs_to_int

ROOT = Path(__file__).resolve().parents[1]
PLAN_KEYS = ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
             "mat_loads", "nmat_loads", "wit_src", "win_of", "nin_of", "K",
             "KN", "n_regs", "n_nregs", "n_chunks", "calls", "opset_n",
             "opset_w")
BATCH = 4


def poseidon2_src(gen):
    return gen((2,)) + "\ncomponent main = Poseidon2();\n"


@pytest.fixture(scope="module")
def poseidon2():
    """JAX program, its CPU scan-path witness and the inputs, batch 4."""
    cc = jax_compile(poseidon2_src(jax_generate))
    tape, _ = cc.build_tape()
    spec = jax_field_spec("bn128")
    rng = np.random.default_rng(11)
    cols = [[int.from_bytes(rng.bytes(32), "little") % spec.p
             for _ in range(BATCH)] for _ in range(tape.n_inputs)]
    jp = JaxProgram(tape, spec, unroll_threshold=0)
    x = jp.encode_inputs(cols)
    scan = JaxProgram(tape, spec, unroll_threshold=0, mode="scan")
    want = np.asarray(scan.run(x))
    return cc, jp, cols, x, want


def to_np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def test_jax_plan_through_plain_executor(poseidon2):
    cc, jp, cols, x, want = poseidon2
    arrays = {k: getattr(jp.fused, k) for k in PLAN_KEYS}
    spec = field_spec("bn128")
    interp = TorchInterpreter(plan_from_arrays(arrays, "cpu"),
                              TorchField(spec))
    got = to_np(interp._run(x))
    assert got.shape == want.shape == (jp.n_witness, spec.n_limbs, BATCH)
    np.testing.assert_array_equal(got, want)
    for b in range(BATCH):
        host = list(cc.witness_host({"inputs": [c[b] for c in cols]}))
        assert [limbs_to_int(got[i, :, b]) for i in range(len(host))] == host


def test_port_program_matches(poseidon2):
    """The port's own compiler + planner + executor, end to end."""
    _cc, _jp, _cols, x, want = poseidon2
    cc = compile_source(poseidon2_src(generate))
    prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device="cpu")
    out = prog.run(x)
    assert out.dtype == torch.uint32 and out.device.type == "cpu"
    np.testing.assert_array_equal(to_np(out), want)
    dec = prog.decode_outputs(out)
    assert dec == [[limbs_to_int(want[i, :, b]) for b in range(BATCH)]
                   for i in range(want.shape[0])]


def test_trailing_redc_and_written_rows(poseidon2):
    """Flagged rows come out canonical; every witness row is written."""
    _cc, jp, _cols, x, _want = poseidon2
    arrays = {k: getattr(jp.fused, k) for k in PLAN_KEYS}
    plan = plan_from_arrays(arrays, "cpu")
    spec = field_spec("bn128")
    assert int(plan.mont_tab.sum()) == jp.fused.n_mont_rows > 0
    x_w = torch.from_numpy(x.view(np.int32))[plan.win_order].to(torch.int64)
    x_n = torch.zeros((0, BATCH), dtype=torch.int64)
    bank, bank_n = run_plan(plan, TorchField(spec), x_w, x_n)
    assert bank_n.shape == (plan.n_chunks, BATCH)   # KN = 0: dump rows
    written = set(plan.written_rows().tolist())
    assert set(plan.wd_src.tolist()) <= written
    for r in plan.wd_src.tolist():
        for b in range(BATCH):
            assert limbs_to_int(bank[r, :, b].tolist()) < spec.p


def test_opcode_numbering_matches_kernel():
    src = (ROOT / "circom_tpu_torch/ops/cuda/interp.cu").read_text()
    enum = dict((name.lower(), int(v)) for name, v in
                re.findall(r"OP_([A-Z0-9_]+) = (\d+)", src))
    assert {op: OPCODES.index(op) for op in OPCODES} == enum
    # K1a's 6 wide opcodes, K1b's 13 narrow ones, K1c's 3 and K1d's 46
    assert len(enum) == 68


def planner_vocabulary():
    """Every opcode the port's planner can emit, read off
    backend/interp_plan.py: the opcode of each `steps.append((op, ...))`
    and of each call of its emit_n1 / emit_n2 / emit_n2i helpers, where
    an opcode is a string, a dict of strings indexed by the tape op, a
    comparison plus "_nn" / "_ww", f"dot{n}_c", or one of the names the
    planner dispatches by (the tape op `op`, its constant variant `ops_c`,
    its narrow form `nop`).  An emission in any other form fails the
    test, so a new one is not missed."""
    from circom_tpu_torch.backend import interp_plan as ip

    tree = ast.parse(Path(ip.__file__).read_text())
    dicts = {}      # name -> values of a dict-subscript assignment
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Subscript) \
                and isinstance(node.value.value, ast.Dict):
            dicts[node.targets[0].id] = {v.value for v in
                                         node.value.value.values}
    names = {"op": ip._VV_OPS | set(ip._C_VARIANTS),
             "ops_c": set(ip._C_VARIANTS.values()), **dicts}

    def resolve(e):
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return {e.value}
        if isinstance(e, ast.Subscript) and isinstance(e.value, ast.Dict):
            return {v.value for v in e.value.values}
        if isinstance(e, ast.BinOp) and isinstance(e.right, ast.Constant):
            return {o + e.right.value for o in ip._CMP}
        if isinstance(e, ast.JoinedStr) and ast.unparse(e) == \
                "f'dot{n}_c'":
            return {"dot2_c", "dot3_c"}
        if isinstance(e, ast.Name) and e.id in names:
            return names[e.id]
        raise AssertionError(f"unknown opcode form: {ast.unparse(e)}")

    vocab, sites = set(), 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "append" and \
                isinstance(f.value, ast.Name) and f.value.id == "steps":
            arg = node.args[0]
            if not isinstance(arg, ast.Tuple):
                raise AssertionError(f"unknown step: {ast.unparse(arg)}")
            vocab |= resolve(arg.elts[0])
        elif isinstance(f, ast.Name) and f.id in ("emit_n1", "emit_n2",
                                                  "emit_n2i"):
            if not (isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "op"):
                vocab |= resolve(node.args[0])
        else:
            continue
        sites += 1
    assert sites > 50
    return vocab


def test_planner_vocabulary_is_inside_the_kernel():
    """convert.OPCODES covers every opcode the planner can emit, so
    plan_from_arrays refuses nothing the planner produces."""
    vocab = planner_vocabulary()
    assert {"gmul", "idiv", "shl_kw", "nsel_w", "lt_ww", "eq_nn", "widen",
            "dot3_c", "nrotr"} <= vocab
    assert vocab <= set(OPCODES), sorted(vocab - set(OPCODES))
    assert vocab == set(OPCODES)     # and the kernel has no other opcode


@pytest.mark.parametrize("prime", ["goldilocks", "bn128"])
def test_opcodes_outside_k1a_raise(prime):
    """Mixed comparisons and wide bit ops lie outside K1a and K1b; K1d
    runs them, equal to the host calculator.  An opcode outside the whole
    kernel (one a newer planner might emit) is still refused by name."""
    src = """
    pragma circom 2.0.0;
    template T() {
      signal input a;
      signal input b;
      signal output o;
      o <-- a < b ? (a ^ b) + 5 : (a | b) - (a & b);
      o * 0 === 0;
    }
    component main = T();
    """
    cc = compile_source(src, prime=prime)
    spec = field_spec(prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu")
    assert {"band", "bor", "bxor", "lt_ww", "select", "widen"} \
        <= prog.interp.plan.opcodes
    rng = np.random.default_rng(31)
    cols = [[int(v) % spec.p for v in rng.integers(0, 2 ** 62, size=3)]
            + [spec.p - 1] for _ in range(2)]
    got = prog.decode_outputs(prog.run(prog.encode_inputs(cols)))
    for b in range(4):
        host = list(cc.witness_host({"a": cols[0][b], "b": cols[1][b]}))
        assert [row[b] for row in got] == host
    arrays = prog.plan.plan_arrays()
    arrays["opset_w"] = ["bfrob" if op == "bxor" else op
                         for op in arrays["opset_w"]]
    with pytest.raises(UnsupportedTapeOp,
                       match="outside the interpreter kernel K1: bfrob"):
        plan_from_arrays(arrays, "cpu")


def test_goldilocks_poseidon2_is_refused_by_name():
    """Goldilocks' folded products (K1c) run on goldilocks, equal to the
    host calculator, and are refused by name on another 4-limb field."""
    src = poseidon2_src(lambda t: generate(t, prime="goldilocks"))
    cc = compile_source(src, prime="goldilocks")
    tape, _ = cc.build_tape()
    spec = field_spec("goldilocks")
    prog = WitnessProgram(tape, spec, device="cpu")
    assert {"gmul", "gmul_c"} <= prog.interp.plan.opcodes
    cols = [[3, spec.p - 1], [2 ** 63 + 7, 12345]]
    got = prog.decode_outputs(prog.run(prog.encode_inputs(cols)))
    for b in range(2):
        host = list(cc.witness_host({"inputs": [cols[0][b], cols[1][b]]}))
        assert [row[b] for row in got] == host
    other = TorchField(FieldSpec("p64", 2 ** 64 - 59))
    with pytest.raises(UnsupportedTapeOp, match="gmul, gmul_c"):
        TorchInterpreter(prog.interp.plan, other)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tape, _ = compile_source(poseidon2_src(generate)).build_tape()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WitnessProgram(tape, field_spec("bn128"))


@pytest.mark.parametrize("column, value", [(1, 10_000), (4, -1), (5, 99)])
def test_plan_with_index_out_of_range_is_refused(poseidon2, column, value):
    """The kernel trusts the tables, so convert checks every index."""
    _cc, jp, _cols, _x, _want = poseidon2
    arrays = {k: getattr(jp.fused, k) for k in PLAN_KEYS}
    arrays["table"] = arrays["table"].copy()
    arrays["table"][7, column] = value
    with pytest.raises(ValueError, match="out of range"):
        plan_from_arrays(arrays, "cpu")
