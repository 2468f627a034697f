"""The port's scan executor (backend/scan.py) against the JAX package's
scan path (backend/jax_backend.py WitnessProgram at unroll_threshold=0).

- Tables: `schedule` gives the JAX program's scan tables and lists,
  element for element, at 1, 8 and 64 slots, on test_torch_perop's small
  tapes, bigint-div + Num2Bits(254) and 4 x Num2Bits(32), over bn128
  and goldilocks.
- Witness: the port's scan equals the JAX scan at batch 3, lanes with
  idiv(a, 0) and a / 0 included, at every slot count.
- Dynamic branches: the per-slot shifts and power equal JAX's `_branch`
  at per-slot counts and exponents.
- Refusal: both packages refuse an immediate >= 2^31.
- Choice: `unroll` and the executor equal JAX's for each entry point's
  constructor call and for the default threshold.
- Mesh: `for_device` plans nothing again, and the scan split over
  [cpu] * 2 equals the unsharded run.

Comparisons are exact (tolerance 0): field elements are integers.
"""

import functools
import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops.jfield import JaxField
from circom_tpu_torch.backend import torch_backend
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (bigdiv_num2bits_source,
                                               num2bits_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.parallel.mesh import gather, make_mesh, shard_program
from test_torch_perop import (CHOICE, ROOT, SMALL, _inputs, operands,
                              tensor, u32)

PRIMES = ("bn128", "goldilocks")
POW_DIV_SRC = """
pragma circom 2.0.0;
template PowDiv() {
    signal input a;
    signal input b;
    signal output o[6];
    o[0] <-- a ** 5;
    o[1] <-- a / b;
    o[2] <-- a % b;
    o[3] <-- a ** 65537;
    o[4] <-- (a * b) ** 3;
    o[5] <-- a ** 2147483647;
}
component main = PowDiv();
"""
TAPES = dict(SMALL, bigdiv_num2bits=bigdiv_num2bits_source(),
             num2bits32x4=num2bits_source(32, 4))
# the tapes whose second input divides
DIVIDES = ("bigdiv", "wide_ops", "bigdiv_num2bits", "pow_div")


@functools.lru_cache(maxsize=None)
def compiled(name, prime):
    """(JAX compile, port compile, input range hints) of a tape."""
    src = POW_DIV_SRC if name == "pow_div" else TAPES[name]
    cc_ref = jax_compile(src, prime=prime)
    return cc_ref, compile_source(src, prime=prime), \
        cc_ref.input_range_hints()


def programs(name, prime, **kw):
    cc_ref, cc, hints = compiled(name, prime)
    jp = JaxProgram(cc_ref.build_tape()[0], jax_field_spec(prime),
                    input_ranges=hints, **kw)
    wp = WitnessProgram(cc.build_tape()[0], field_spec(prime), device="cpu",
                        input_ranges=hints, **kw)
    return jp, wp


@pytest.mark.parametrize("slots", (1, 8, 64))
@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("name", list(TAPES))
def test_schedule_matches_jax_tables(name, prime, slots):
    jp, wp = programs(name, prime, unroll_threshold=0, mode="scan",
                      slots=slots)
    s = wp.scan.sched
    assert len(s.tables) == len(jp.tables) == 7
    for got, want in zip(s.tables, jp.tables):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s.out_regs, jp.out_regs)
    assert s.const_loads == jp.const_loads
    assert s.input_loads == jp.input_loads
    assert s.out_dups == jp.out_dups
    assert s.load_outputs == jp.load_outputs
    assert (s.n_regs, s.n_steps, s.branch_ops, s.n_witness) == \
        (jp.n_regs, jp.n_steps, jp.branch_ops, jp.n_witness)


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("name", list(TAPES) + ["pow_div"])
def test_scan_witness_matches_jax_scan(name, prime):
    """Batch 3; where the second input divides, lane 1 divides by 0
    (idiv(a, 0) = 0, mod(a, 0) = a, a / 0 = 0)."""
    jp, wp = programs(name, prime, unroll_threshold=0, mode="scan")
    assert wp.scan is not None and wp.perop is None and not wp.unroll
    cols = _inputs(prime, wp.n_inputs, compiled(name, prime)[2], 3,
                   zlib.crc32(name.encode()))
    if name in DIVIDES:
        cols[1][1] = 0
    x = wp.encode_inputs(cols)
    want = np.asarray(jp.run(x))
    for slots in (1, 8, 64):
        wp = programs(name, prime, unroll_threshold=0, mode="scan",
                      slots=slots)[1]
        np.testing.assert_array_equal(u32(wp.run(x)), want,
                                      err_msg=f"slots {slots}")


def slot_operands(prime, n_slots):
    """(S, L, B) operands, each slot its own seeded batch with the edges."""
    return np.stack([operands(prime, 100 + s)[0] for s in range(n_slots)])


@pytest.mark.parametrize("prime", PRIMES)
def test_dynamic_branches_match_jax(prime):
    """shr_k, shl_k and pow_k with a count or exponent a slot, against
    JAX's `_branch` (which reads only its program's JaxField); pow_dyn
    also against pow_mont slot by slot."""
    tf, jf = TorchField(field_spec(prime)), JaxField(jax_field_spec(prime))
    branch = functools.partial(JaxProgram._branch, SimpleNamespace(jf=jf))
    bits = field_spec(prime).p.bit_length()
    counts = np.array([0, 1, 15, 16, 17, 31, 32, 33, bits - 1], np.int64)
    a = slot_operands(prime, len(counts))
    k = torch.as_tensor(counts)
    for op, mine in (("shr_k", tf.shift_r_dyn), ("shl_k", tf.shift_l_dyn)):
        want = np.asarray(branch(op)(a, a, a, jnp.asarray(counts,
                                                          jnp.uint32)))
        np.testing.assert_array_equal(u32(mine(tensor(a), k)), want,
                                      err_msg=op)
    exps = np.array([0, 1, 2, 5, 2 ** 31 - 1], np.int64)
    a = slot_operands(prime, len(exps))
    want = np.asarray(branch("pow_k")(a, a, a, jnp.asarray(exps, jnp.uint32)))
    got = u32(tf.pow_dyn(tensor(a), torch.as_tensor(exps)))
    np.testing.assert_array_equal(got, want)
    for s, e in enumerate(exps):
        np.testing.assert_array_equal(
            got[s], np.broadcast_to(u32(tf.pow_mont(tensor(a[s]), int(e))),
                                    a[s].shape), err_msg=f"pow {e}")


BIG_IMM_SRC = """
pragma circom 2.0.0;
template Big() {
    signal input a;
    signal output o;
    o <-- a ** 2147483648;
}
component main = Big();
"""


@pytest.mark.parametrize("prime", PRIMES)
def test_large_immediate_refused_by_both(prime):
    for make, compile_ in ((lambda t: JaxProgram(
            t, jax_field_spec(prime), unroll_threshold=0, mode="scan"),
            jax_compile), (lambda t: WitnessProgram(
                t, field_spec(prime), device="cpu", unroll_threshold=0,
                mode="scan"), compile_source)):
        tape = compile_(BIG_IMM_SRC, prime=prime).build_tape()[0]
        assert 2 ** 31 in tape.imms
        with pytest.raises(NotImplementedError, match="immediate too large"):
            make(tape)


# each entry point's constructor call: the CLI and witness.py (range
# hints), parallel/multihost.py, entry.py's flagship, and the default
ENTRY_CALLS = {
    "cli_witness": dict(unroll_threshold=0, hints=True),
    "multihost": dict(unroll_threshold=0, mode="scan"),
    "entry": dict(unroll_threshold=0),
    "default": dict(),
}


def executor(prog):
    """The executor a program runs on its accelerator: the fused backend,
    else the straight-line path, else the scan."""
    if prog.fused is not None:
        return type(prog.fused).__name__.replace("TorchInterpreter",
                                                 "InterpreterProgram")
    return "straight-line" if prog.unroll else "scan"


@pytest.mark.parametrize("call", list(ENTRY_CALLS))
@pytest.mark.parametrize("name", list(CHOICE))
def test_executor_choice_matches_jax(name, call):
    kw = dict(ENTRY_CALLS[call])
    stdlib = (ROOT / "circom_tpu/circuits/stdlib.circom").read_text()
    cc_ref = jax_compile(CHOICE[name](stdlib))
    if kw.pop("hints", False):
        kw["input_ranges"] = cc_ref.input_range_hints()
    jp = JaxProgram(cc_ref.build_tape()[0], jax_field_spec("bn128"), **kw)
    stdlib = (ROOT / "circom_tpu_torch/circuits/stdlib.circom").read_text()
    wp = WitnessProgram(compile_source(CHOICE[name](stdlib)).build_tape()[0],
                        field_spec("bn128"), device="cpu", **kw)
    assert wp.unroll == jp.unroll
    assert executor(wp) == executor(jp)
    # the scan is planned at construction exactly where JAX plans it
    assert (wp.scan is not None) == (jp.fused is None and not jp.unroll)
    assert (wp.perop is not None) == (jp.fused is None and jp.unroll)
    if wp.scan is not None:
        assert wp.scan.sched.n_steps == jp.n_steps


def test_scan_for_device_and_mesh_match_unsharded(monkeypatch):
    """bigint-div + Num2Bits(254)/goldilocks on the scan: the copy for
    another device ("meta") reuses the schedule with every planner
    stubbed to fail, and the batch split over [cpu] * 2 gives the
    unsharded witness."""
    _, wp = programs("bigdiv_num2bits", "goldilocks", unroll_threshold=0,
                     mode="scan")
    assert wp.scan is not None
    cols = _inputs("goldilocks", wp.n_inputs, {}, 4, 11)
    cols[1][2] = 0
    x = wp.encode_inputs(cols)
    want = u32(wp.run(x))

    def refuse(*a, **k):
        raise AssertionError("planned again")
    for name in ("schedule", "ScanProgram", "PerOpProgram", "domain_tape",
                 "lower_dynamic_ops"):
        monkeypatch.setattr(torch_backend, name, refuse)
    meta = torch.device("meta")
    twin = wp.for_device("meta")
    assert twin.scan is not wp.scan and twin.scan.sched is wp.scan.sched
    assert twin.scan.init.device == meta
    assert all(t.device == meta for t in twin.scan.idx.values())
    assert all(t.device == meta for step in twin.scan.steps
               for t in (*step[1], *step[2:]))
    assert wp.scan.init.device.type == "cpu"
    shards = shard_program(wp, make_mesh(devices=["cpu"] * 2))(x)
    assert len(shards) == 2
    np.testing.assert_array_equal(u32(gather(shards)), want)
