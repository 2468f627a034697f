"""The port's interpreter against the JAX package and the host calculator.

The JAX interpreter plan is carried across with plan_from_arrays and run
by the port's plain executor (backend/interp_ref.py) at batch 4; the
witness must equal, bit for bit, both the JAX WitnessProgram's scan path
on the CPU (plain jnp, no Pallas) and the host calculator.
"""

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
from circom_tpu_torch.field.primes import field_spec
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
    assert len(enum) == 19   # K1a's 6 wide opcodes and K1b's 13 narrow ones


@pytest.mark.parametrize("prime", ["goldilocks", "bn128"])
def test_opcodes_outside_k1a_raise(prime):
    """Mixed comparisons and wide bit ops are in neither K1a nor K1b: the
    port names them instead of running anything."""
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
    tape, _ = compile_source(src, prime=prime).build_tape()
    with pytest.raises(UnsupportedTapeOp, match="K1a wide, K1b narrow") as e:
        WitnessProgram(tape, field_spec(prime), device="cpu")
    for op in ("band", "bor", "bxor", "lt_ww", "select", "widen"):
        assert op in str(e.value)


def test_goldilocks_poseidon2_is_refused_by_name():
    """Goldilocks' folded products (K1c) are not in the port yet."""
    src = poseidon2_src(lambda t: generate(t, prime="goldilocks"))
    tape, _ = compile_source(src, prime="goldilocks").build_tape()
    with pytest.raises(UnsupportedTapeOp, match="gmul, gmul_c"):
        WitnessProgram(tape, field_spec("goldilocks"), device="cpu")


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
