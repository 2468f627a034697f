"""The port's narrow int32 lane against the JAX package.

The plain versions of the 13 narrow opcodes of kernel K1b, of the bit
unpack of K3 and of the widening (circom_tpu_torch/ops/narrow.py) must
equal, bit for bit, the jnp expressions of the JAX interpreter kernel
(circom_tpu/backend/interp.py `nbranch`, `_unpack_bits`, `_widen_narrow`),
on random int32 values with the ±2^31 edges and the shift counts
{0, 1, 31, 32, 33, -1}.  The port's interpreter on the word-packed test
circuits of test_bitpack.py must equal the JAX interpreter run eagerly in
interpret mode (goldilocks, batch 8).  Every comparison is exact.
"""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.backend.interp import InterpreterProgram, _unpack_bits
from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu_torch.backend.interp import TorchInterpreter
from circom_tpu_torch.backend.interp_ref import gather_n_rows, run_plan
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import (K1B_OPCODES, narrow_unit_arrays,
                                      plan_from_arrays)
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
from circom_tpu_torch.ops.narrow import NARROW_OPS, unpack_bits, widen_narrow
from test_bitpack import NWORD_SRC, WORD_SRC

COUNTS = (0, 1, 31, 32, 33, -1)
EDGES = (-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 1)
PLAN_KEYS = ("table", "r_op", "r_s0", "rstarts", "cbank", "mont_tab",
             "mat_loads", "nmat_loads", "wit_src", "win_of", "nin_of", "K",
             "KN", "n_regs", "n_nregs", "n_chunks", "calls", "opset_n",
             "opset_w")
BATCH = 8


def int32_values(seed, n=200):
    v = np.random.default_rng(seed).integers(-2 ** 31, 2 ** 31, size=n)
    v[:len(EDGES)] = EDGES
    return v.astype(np.int32)


def jax_narrow(op, na, nb, aux):
    """The narrow branch of the JAX interpreter kernel, written out from
    `nbranch` (na, nb int32 arrays; aux an int32 scalar, as read from the
    step table)."""
    if op == "ncopy":
        return na
    if op == "nmul":
        return na * nb
    if op == "nadd":
        return na + nb
    if op == "nband":
        return na & nb
    if op == "nbor":
        return na | nb
    if op == "nbxor":
        return na ^ nb
    if op == "nshl":
        return na << aux
    if op == "nshr":
        return na >> aux
    if op == "nshru":
        return (na.astype(jnp.uint32) >> aux.astype(jnp.uint32)) \
            .astype(jnp.int32)
    if op == "nxbit":
        return ((na.astype(jnp.uint32) >> aux.astype(jnp.uint32))
                & 1).astype(jnp.int32)
    if op == "nmshl":
        return (na & nb) << aux
    if op == "nmshru":
        return ((na & nb).astype(jnp.uint32) >> aux.astype(jnp.uint32)) \
            .astype(jnp.int32)
    assert op == "nrotr"
    ua = na.astype(jnp.uint32)
    r = aux.astype(jnp.uint32)
    return ((ua >> r) | (ua << (np.uint32(32) - r))).astype(jnp.int32)


@pytest.mark.parametrize("op", K1B_OPCODES)
def test_narrow_op_matches_jax_kernel(op):
    a, b = int32_values(1), int32_values(2)[::-1].copy()
    for s in COUNTS:
        want = np.asarray(jax_narrow(op, jnp.asarray(a), jnp.asarray(b),
                                     jnp.int32(s)))
        got = NARROW_OPS[op](torch.from_numpy(a).long(),
                             torch.from_numpy(b).long(), s)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"{op} by {s}")


def test_unpack_bits_matches_jax():
    rows = int32_values(3, 6 * 40).reshape(6 * 5, 8)
    shifts = np.asarray([COUNTS[i % 6] if i % 7 else -5
                         for i in range(len(rows))], np.int32)
    want = np.asarray(_unpack_bits(jnp.asarray(rows), shifts))
    got = unpack_bits(torch.from_numpy(rows).long(), torch.from_numpy(shifts))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("prime", ["bn128", "goldilocks"])
def test_widen_narrow_matches_jax(prime):
    spec = field_spec(prime)
    v = int32_values(4, 64).reshape(8, 8)
    fake = SimpleNamespace(L=spec.n_limbs, xt=SimpleNamespace(p=spec.p))
    want = np.asarray(InterpreterProgram._widen_narrow(
        fake, jnp.asarray(v)[:, None, :]))[:, :, 0, :]
    got = widen_narrow(torch.from_numpy(v), spec.p, spec.n_limbs)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy()
                                  .view(np.uint32), want)
    for i, j in ((0, 0), (3, 5), (7, 7)):
        assert limbs_to_int(got[i, :, j].tolist()) == int(v[i, j]) % spec.p


def test_unit_plan_through_plain_executor():
    """narrow_unit_arrays: one step per opcode and shift count, each row
    equal to the JAX expression."""
    arrays, cases = narrow_unit_arrays(4)
    plan = plan_from_arrays(arrays, "cpu")
    a, b = int32_values(5, 64), int32_values(6, 64)
    x_n = torch.from_numpy(np.stack([a, b])).long()
    _bank, bank_n = run_plan(plan, TorchField(field_spec("goldilocks")),
                             torch.zeros((0, 4, 64), dtype=torch.int64), x_n)
    for t, (op, s) in enumerate(cases):
        want = np.asarray(jax_narrow(op, jnp.asarray(a), jnp.asarray(b),
                                     jnp.int32(s)))
        np.testing.assert_array_equal(bank_n[t].numpy(), want,
                                      err_msg=f"{op} by {s}")


def test_gather_n_rows_reads_bank_and_inputs():
    rng = np.random.default_rng(7)
    bank_n = torch.from_numpy(int32_values(8, 5 * 16).reshape(5, 16))
    x_n = torch.from_numpy(int32_values(9, 3 * 16).reshape(3, 16))
    src = torch.from_numpy(rng.integers(0, 8, size=40).astype(np.int32))
    shift = torch.from_numpy(np.asarray(COUNTS * 7, np.int32)[:40])
    got = gather_n_rows(bank_n, x_n, src, shift)
    both = np.concatenate([bank_n.numpy(), x_n.numpy()])
    want = np.asarray(_unpack_bits(jnp.asarray(both[src.numpy()]),
                                   shift.numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- the interpreter on word-packed circuits, against the JAX one ----------

@pytest.fixture(scope="module", params=["word", "nword"])
def packed(request):
    """(port program, JAX program, inputs, JAX mixed and full witnesses)
    for one of test_bitpack's circuits at goldilocks, batch 8; the JAX
    interpreter runs eagerly in interpret mode."""
    src = {"word": WORD_SRC, "nword": NWORD_SRC}[request.param]
    cc = jax_compile(src, prime="goldilocks")
    tape, _ = cc.build_tape()
    jp = JaxProgram(tape, jax_field_spec("goldilocks"), unroll_threshold=0,
                    mode="interp", input_ranges=cc.input_range_hints())
    rng = random.Random(41)
    cols = [[rng.randrange(2) for _ in range(BATCH)]
            for _ in range(tape.n_inputs)]
    x = np.asarray(jp.encode_inputs(cols))
    narrow, wide = (np.asarray(a) for a in jp.fused._run_mixed(x))
    full = np.asarray(jp.fused._run(x))
    pc = compile_source(src, prime="goldilocks")
    prog = WitnessProgram(pc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu", input_ranges=pc.input_range_hints())
    return prog, jp, x, narrow, wide, full


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def test_run_mixed_matches_jax(packed):
    prog, jp, x, narrow, wide, _full = packed
    got_n, got_w = prog.run_mixed(x)
    assert got_n.dtype == torch.int32 and got_w.dtype == torch.uint32
    np.testing.assert_array_equal(got_n.numpy(), narrow)
    np.testing.assert_array_equal(u32(got_w), wide)
    assert prog.mixed_layout() == tuple(jp.fused.mixed_layout())


def test_run_matches_jax(packed):
    prog, _jp, x, _narrow, _wide, full = packed
    np.testing.assert_array_equal(u32(prog.run(x)), full)


def test_jax_plan_through_plain_executor(packed):
    _prog, jp, x, narrow, wide, full = packed
    arrays = {k: getattr(jp.fused, k) for k in PLAN_KEYS}
    interp = TorchInterpreter(plan_from_arrays(arrays, "cpu"),
                              TorchField(field_spec("goldilocks")))
    got_n, got_w = interp._run_mixed(x)
    np.testing.assert_array_equal(got_n.numpy(), narrow)
    np.testing.assert_array_equal(u32(got_w), wide)
    np.testing.assert_array_equal(u32(interp._run(x)), full)


def test_two_limb_input_rows(packed):
    """All-narrow input sets take (n, 2, B) rows: the same mixed witness
    as the full-limb rows."""
    prog, _jp, x, narrow, wide, _full = packed
    got_n, got_w = prog.run_mixed(x[:, :2].copy())
    np.testing.assert_array_equal(got_n.numpy(), narrow)
    np.testing.assert_array_equal(u32(got_w), wide)


# -- every wit_src kind ----------------------------------------------------

def test_input_and_const_witness_rows():
    """No repo circuit plans input or const witness rows (every witness is
    an emission row), so hand-edited plans show each kind: wide and
    narrow input rows and const rows, in run and in run_mixed."""
    spec = field_spec("bn128")
    L, p = spec.n_limbs, spec.p
    tf = TorchField(spec)
    # wide inputs: Poseidon2/bn128
    cc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu")
    arrays = prog.plan.plan_arrays()
    arrays["wit_src"] = list(arrays["wit_src"])
    consts = {2: 12345, 3: p - 1, 5: 12345}
    arrays["wit_src"][1] = ("input", 1)
    for w, v in consts.items():
        arrays["wit_src"][w] = ("const", v)
    interp = TorchInterpreter(plan_from_arrays(arrays, "cpu"), tf)
    rng = np.random.default_rng(17)
    cols = [[int(v) for v in rng.integers(0, 2 ** 62, size=3)]
            for _ in range(prog.n_inputs)]
    x = prog.encode_inputs(cols)
    base = u32(prog.run(x))
    got = u32(interp._run(x))
    np.testing.assert_array_equal(got[1], x[1])
    for w, v in consts.items():
        assert [limbs_to_int(got[w, :, b]) for b in range(3)] == [v] * 3
    keep = [w for w in range(len(base)) if w not in (1, 2, 3, 5)]
    np.testing.assert_array_equal(got[keep], base[keep])
    narrow, wide = interp._run_mixed(x)
    assert narrow.shape == (0, 3)
    np.testing.assert_array_equal(u32(wide), got)
    # narrow inputs: WORD_SRC's bit inputs
    pc = compile_source(WORD_SRC, prime="goldilocks")
    gspec = field_spec("goldilocks")
    wprog = WitnessProgram(pc.build_tape()[0], gspec, device="cpu",
                           input_ranges=pc.input_range_hints())
    arrays = wprog.plan.plan_arrays()
    arrays["wit_src"] = list(arrays["wit_src"])
    arrays["wit_src"][4] = ("input", 40)
    arrays["wit_src"][6] = ("const", 7)
    interp = TorchInterpreter(plan_from_arrays(arrays, "cpu"),
                              TorchField(gspec))
    rng = random.Random(5)
    cols = [[rng.randrange(2) for _ in range(BATCH)]
            for _ in range(wprog.n_inputs)]
    x = wprog.encode_inputs(cols)
    base = u32(wprog.run(x))
    got = u32(interp._run(x))
    np.testing.assert_array_equal(got[4], x[40])
    np.testing.assert_array_equal(got[6], np.broadcast_to(
        ints_to_limbs([7], gspec.n_limbs).T, got[6].shape))
    keep = [w for w in range(len(base)) if w not in (4, 6)]
    np.testing.assert_array_equal(got[keep], base[keep])
    narrow, wide = interp._run_mixed(x)
    n_idx, w_idx = interp.mixed_layout()
    assert w_idx == [6] and 4 in n_idx
    np.testing.assert_array_equal(narrow[n_idx.index(4)].numpy(),
                                  np.asarray(cols[40], np.int32))
    np.testing.assert_array_equal(u32(wide)[0], got[6])
    np.testing.assert_array_equal(
        narrow[[n_idx.index(w) for w in keep]].numpy(),
        wprog.run_mixed(x)[0].numpy()[[wprog.mixed_layout()[0].index(w)
                                       for w in keep]])
