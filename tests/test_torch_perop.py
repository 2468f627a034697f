"""The port's per-op path and backend choice against the JAX package.

- TorchField's per-op library (neg, mul_norm, pow/inv/div, the signed
  comparisons, booleans, bit ops, constant shifts, idiv, imod, select)
  against JaxField on seeded operands with the edges 0, 1, p - 1, p // 2
  and p // 2 + 1, full and broadcast (a constant (L, 1) operand).
- The straight-line executor (WitnessProgram mode "scan" at the default
  threshold) against the JAX WitnessProgram's scan path
  (unroll_threshold=0) and its straight-line `_run_ssa` (the default) on
  small circuits, and the per-op executors against the host calculator
  on bigint-div + Num2Bits(254) (straight-line) and 16 x Num2Bits(254)
  (the scan) over bn128, the two full-width tapes both fused backends
  refuse.  tests/test_torch_scan.py holds the scan against JAX's.
- Backend choice: the port sends each tape to the backend the JAX package
  sends it to (type of `fused`, and `unroll`).
- The entry point writes a Num2Bits(254) witness whose .wtns bytes equal
  the host calculator's.

Comparisons are exact: field elements are integers.
"""

import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops.jfield import JaxField
from circom_tpu_torch.backend.artifacts import save_program
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                               bigdiv_num2bits_source,
                                               num2bits_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.emit.binfmt import write_wtns
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs
from circom_tpu_torch.witness import main as torch_witness
from test_fused import MIXED_SRC
from test_torch_fused import WIDE_OPS_SRC, WIDE_SHIFTS_SRC

ROOT = Path(__file__).resolve().parents[1]
PRIMES = ("bn128", "goldilocks")
B = 32


def operands(prime, seed):
    """Two operand batches uint32 (L, B): every pair of the edges first,
    then random values."""
    p = field_spec(prime).p
    edges = [0, 1, p - 1, p // 2, p // 2 + 1]
    rng = np.random.default_rng(seed)
    x = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(2 * B)]
    a, b = x[:B], x[B:]
    for k in range(len(edges) ** 2):
        a[k], b[k] = edges[k % 5], edges[(k // 5) % 5]
    L = field_spec(prime).n_limbs
    return (ints_to_limbs(a, L).T.copy(), ints_to_limbs(b, L).T.copy())


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) \
        .view(torch.uint32)


BINARY = ("mul_norm", "div_mont", "eq", "neq", "lt", "le", "gt", "ge",
          "bool_and", "bool_or", "bit_and", "bit_or", "bit_xor", "idiv",
          "imod")
UNARY = ("neg", "bool_not", "complement", "inv_mont")


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("op", BINARY + UNARY + ("select",))
def test_field_op_matches_jaxfield(prime, op):
    tf, jf = TorchField(field_spec(prime)), JaxField(jax_field_spec(prime))
    a, b = operands(prime, zlib.crc32(f"{op}-{prime}".encode()))
    c = b[:, 7:8]                 # a constant column (L, 1), broadcast
    if op in UNARY:
        cases = [(a,), (b,)]
    elif op == "select":
        cases = [(a, b, a[:, ::-1]), (c, a, b), (a, c, b)]
    else:
        cases = [(a, b), (b, a), (a, c), (c, a)]
    for args in cases:
        want = np.asarray(getattr(jf, op)(*args))
        got = u32(getattr(tf, op)(*[tensor(x) for x in args]))
        np.testing.assert_array_equal(
            np.broadcast_to(got, want.shape), want,
            err_msg=f"{op} {[x.shape for x in args]}")


@pytest.mark.parametrize("prime", PRIMES)
def test_shifts_and_pow_match_jaxfield(prime):
    tf, jf = TorchField(field_spec(prime)), JaxField(jax_field_spec(prime))
    a, _ = operands(prime, 3)
    bits = field_spec(prime).p.bit_length()
    for k in (0, 1, 15, 16, 17, 31, 32, 33, bits - 1):
        for name in ("shift_r_const", "shift_l_const"):
            np.testing.assert_array_equal(
                u32(getattr(tf, name)(tensor(a), k)),
                np.asarray(getattr(jf, name)(a, k)), err_msg=f"{name} {k}")
    for e in (0, 1, 2, 5, 255, 2 ** 40 + 3):
        np.testing.assert_array_equal(
            np.broadcast_to(u32(tf.pow_mont(tensor(a), e)), a.shape),
            np.asarray(jf.pow_mont(a, e)), err_msg=f"pow {e}")


def _inputs(prime, n_inputs, hints, batch, seed):
    spec = field_spec(prime)
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n_inputs):
        if i in hints:
            cols.append([int(v) for v in rng.integers(0, 2, size=batch)])
        else:
            v = [int.from_bytes(rng.bytes(32), "little") % spec.p
                 for _ in range(batch)]
            v[0] = spec.p - 1
            cols.append(v)
    return cols


SMALL = {"mixed": MIXED_SRC, "wide_shifts": WIDE_SHIFTS_SRC,
         "bigdiv": BIGINT_DIV_SRC, "wide_ops": WIDE_OPS_SRC}


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("name", list(SMALL))
def test_perop_matches_jax_scan_and_ssa(prime, name):
    src = SMALL[name]
    cc_ref = jax_compile(src, prime=prime)
    hints = cc_ref.input_range_hints()
    cc = compile_source(src, prime=prime)
    wp = WitnessProgram(cc.build_tape()[0], field_spec(prime), device="cpu",
                        mode="scan", input_ranges=hints)
    assert wp.fused is None and wp.perop is not None
    cols = _inputs(prime, wp.n_inputs, hints, 3, zlib.crc32(name.encode()))
    if name in ("bigdiv", "wide_ops"):
        cols[1][1] = 0            # idiv(a, 0) = 0, mod(a, 0) = a
    x = wp.encode_inputs(cols)
    got = u32(wp.run(x))
    tape_ref = cc_ref.build_tape()[0]
    for threshold in (0, 4096):   # the scan, then _run_ssa
        jp = JaxProgram(tape_ref, jax_field_spec(prime), mode="scan",
                        unroll_threshold=threshold, input_ranges=hints)
        assert jp.unroll == bool(threshold)
        np.testing.assert_array_equal(got, np.asarray(jp.run(x)),
                                      err_msg=f"threshold {threshold}")


def host_check(cc, wp, cols, input_map):
    wit = u32(wp.run(wp.encode_inputs(cols)))
    for lane in range(len(cols[0])):
        host = list(cc.witness_host(input_map([c[lane] for c in cols])))
        got = [sum(int(wit[i, k, lane]) << (16 * k)
                   for k in range(wit.shape[1])) for i in range(len(host))]
        assert got == host, lane


def test_perop_bigdiv_num2bits_matches_host():
    """a \\ b, a % b and Num2Bits(254) of the quotient over bn128: idiv
    keeps it off the segments, so the auto mode takes the per-op path."""
    cc = compile_source(bigdiv_num2bits_source())
    wp = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                        device="cpu")
    assert wp.fused is None and wp.unroll
    p = field_spec("bn128").p
    cols = [[p - 1, 12345], [3, p - 2]]
    host_check(cc, wp, cols, lambda v: {"a": v[0], "b": v[1]})


def test_perop_16_num2bits_matches_host():
    """16 x Num2Bits(254) over bn128: above the segments' max_cost and,
    at 9,415 ops, above the default unroll threshold, so on the scan, as
    in the JAX package; every node scheduled, the dead sums included."""
    cc = compile_source(num2bits_source(254, 16))
    wp = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                        device="cpu")
    assert wp.fused is None and not wp.unroll and wp.perop is None
    assert len(wp.dt.ops) == 9415
    assert (wp.scan.sched.n_steps, wp.scan.sched.n_regs) == (1366, 4344)
    p = field_spec("bn128").p
    cols = [[p - 1 - k, (1 << 253) + k] for k in range(16)]
    host_check(cc, wp, cols, lambda v: {"a": v})


CHOICE = {
    "poseidon2": lambda std: generate((2,)) + "\ncomponent main = "
                                              "Poseidon2();\n",
    "num2bits128": lambda std: num2bits_source(128, 1, std),
    "num2bits254": lambda std: num2bits_source(254, 1, std),
    "bigdiv_num2bits": bigdiv_num2bits_source,
    "num2bits254x16": lambda std: num2bits_source(254, 16, std),
}
WANT = {"poseidon2": ("InterpreterProgram", "TorchInterpreter"),
        "num2bits128": ("InterpreterProgram", "TorchInterpreter"),
        "num2bits254": ("SegmentedProgram", "SegmentedProgram"),
        "bigdiv_num2bits": ("NoneType", "NoneType"),
        "num2bits254x16": ("NoneType", "NoneType")}


@pytest.mark.parametrize("name", list(CHOICE))
def test_backend_choice_matches_jax(name):
    stdlib = (ROOT / "circom_tpu/circuits/stdlib.circom").read_text()
    cc_ref = jax_compile(CHOICE[name](stdlib))
    hints = cc_ref.input_range_hints()
    jp = JaxProgram(cc_ref.build_tape()[0], jax_field_spec("bn128"),
                    input_ranges=hints)
    stdlib = (ROOT / "circom_tpu_torch/circuits/stdlib.circom").read_text()
    cc = compile_source(CHOICE[name](stdlib))
    wp = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                        device="cpu", input_ranges=hints)
    assert (type(jp.fused).__name__, type(wp.fused).__name__) == WANT[name]
    assert wp.unroll == jp.unroll


def test_forced_modes_raise_on_refused_tapes():
    from circom_tpu_torch.backend.plan import UnsupportedTapeOp

    cc = compile_source(bigdiv_num2bits_source())
    tape = cc.build_tape()[0]
    spec = field_spec("bn128")
    with pytest.raises(UnsupportedTapeOp, match="interpreter planner"):
        WitnessProgram(tape, spec, device="cpu", mode="interp")
    with pytest.raises(UnsupportedTapeOp, match="idiv"):
        WitnessProgram(tape, spec, device="cpu", mode="segments")
    wp = WitnessProgram(tape, spec, device="cpu", mode="scan")
    narrow, wide = wp.run_mixed(wp.encode_inputs([[7], [2]]))
    assert narrow.shape == (0, 1) and wide.shape[0] == wp.n_witness
    assert wp.mixed_layout() == ([], list(range(wp.n_witness)))


def test_entry_point_num2bits254_matches_host(tmp_path):
    """python -m circom_tpu_torch.witness --device cpu on a Num2Bits(254)
    artifact (the segments) writes the host calculator's .wtns bytes."""
    cc = compile_source(num2bits_source(254, 1))
    art = tmp_path / "n2b.tpu.json"
    save_program(cc, str(art))
    p = cc.p
    batch = [{"a": [v]} for v in (0, 1, p - 1, (1 << 253) + 5)]
    inp = tmp_path / "inputs.json"
    inp.write_text(json.dumps(batch))
    assert torch_witness([str(art), str(inp), "-o", str(tmp_path / "out"),
                          "--device", "cpu"]) == 0
    for bi, raw in enumerate(batch):
        ref = tmp_path / f"ref.{bi}.wtns"
        write_wtns(str(ref), p, list(cc.witness_host(raw)))
        assert (tmp_path / "out" / f"n2b.{bi}.wtns").read_bytes() == \
            ref.read_bytes()
