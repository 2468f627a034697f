"""The port's plain versions of K1c and K1d against the JAX package.

The wide ops of ops/wide.py must equal, bit for bit, the JAX package's
LimbEmitter (ops/limb_emit.py: `emit`, `gl_mul`, `emit_mul`) run as jnp
on the CPU; the shifts and the long division equal the host field's
(HostField.shift_l / shift_r, integer division); the K1d narrow ops equal
the jnp expressions of the JAX kernel's `nbranch`.  Operands are the edge
values of convert.wide_edges / NARROW_EDGES and random ones.  The unit
plan of every K1c and K1d opcode runs through the plain executor and each
row is held against the same references.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.field.hostfield import HostField
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops.limb_emit import LimbEmitter
from circom_tpu_torch.backend.interp_ref import run_plan
from circom_tpu_torch.convert import (BANK_B, K1C_OPCODES, K1D_OPCODES,
                                      NARROW_EDGES, plan_from_arrays,
                                      unit_arrays, unit_inputs, unit_shifts,
                                      wide_edges)
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops import wide
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import int_to_limbs, limbs_to_int
from circom_tpu_torch.ops.narrow import NARROW_OPS, nsel

PRIMES = ("goldilocks", "bn128")
B = 400   # 343 lanes of edge triples, then random ones


def operands(prime, seed=3):
    spec = field_spec(prime)
    x_w, x_n = unit_inputs(spec.p, spec.n_limbs, B, seed)
    return x_w, x_n


def i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def ints(limbs):
    """(L, B) limbs -> list of ints."""
    a = np.asarray(limbs)
    return [limbs_to_int(a[:, b]) for b in range(a.shape[1])]


def rd_of(*ops):
    """LimbEmitter's operand reader over (L, B) uint32 arrays (a bank row
    is an (L, 1) array broadcast to the batch)."""
    ops = [jnp.broadcast_to(jnp.asarray(o, jnp.uint32), (o.shape[0], B))
           for o in ops]
    return lambda k, i: ops[k][i]


def jax_wide(spec, op, x, y=None, z=None):
    """The JAX kernel's wide result of op on (L, B) uint32 operands."""
    em = LimbEmitter(jax_field_spec(spec.name))
    zero = jnp.zeros((B,), jnp.uint32)
    args = [a for a in (x, y, z) if a is not None]
    if op in ("gmul", "gmul_c"):
        rows = em.gl_mul(rd_of(*args), zero)
    elif op in ("mul_c", "mul_one"):
        rows = em.emit_mul(rd_of(*args), zero)
    else:
        rows = em.emit(op, rd_of(*args), None, zero)
    return np.stack([np.asarray(jnp.broadcast_to(r, (B,))) for r in rows])


def jax_narrow(op, na, nb, nc):
    """The JAX kernel's `nbranch` for K1d's narrow-operand ops."""
    if op == "nsub":
        return na - nb
    if op == "nsel":
        return jnp.where(na != 0, nb, nc)
    if op == "nidiv":
        return jnp.where(nb == 0, 0, na // jnp.where(nb == 0, 1, nb))
    if op == "lnot_n":
        return jnp.where(na == 0, 1, 0)
    base = op[:-3]
    m = {"eq": na == nb, "neq": na != nb, "lt": na < nb, "le": na <= nb,
         "gt": na > nb, "ge": na >= nb, "land": (na != 0) & (nb != 0),
         "lor": (na != 0) | (nb != 0)}[base]
    return jnp.where(m, 1, 0)


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("op", wide.EMIT_OPS)
def test_emit_op_matches_limb_emitter(prime, op):
    spec = field_spec(prime)
    x_w, _ = operands(prime)
    got = wide.emit(TorchField(spec), op, *(i64(a) for a in x_w))
    want = jax_wide(spec, op, *x_w)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gl_mul_matches_limb_emitter_and_reaches_every_fixup():
    """The t2 = 1 select-add is reached by operands near p.  t2 = -1 and
    t3 = 1 cannot occur for 16-bit limbs: the folded value is
    P0 + H0·2^32 - H0 - H1 >= -2^33 > -p (P0 the low 64 bits of the
    product, H0 and H1 the next two 32-bit words), and after t2 = 1 the
    remainder is below 2^38, far from 2^64 - 2^32.  Their branches are
    kept, as the JAX code keeps them."""
    spec = field_spec("goldilocks")
    f = TorchField(spec)
    x_w, _ = operands("goldilocks", seed=4)
    near = [(18446744069414304471, 18446744069414557501),
            (18446744069414508297, 18446744069414300544),
            (18446744069413677931, 18446744069414577835),
            (2 ** 48, 2 ** 48), (2 ** 32 - 1, 2 ** 32 + 1)]
    for k, (a, b) in enumerate(near):
        x_w[0, :, 343 + k] = int_to_limbs(a, 4)
        x_w[1, :, 343 + k] = int_to_limbs(b, 4)
    got, t2, t3 = wide.gl_mul64(f, i64(x_w[0]), i64(x_w[1]), carries=True)
    np.testing.assert_array_equal(
        got.numpy(), jax_wide(spec, "gmul", x_w[0], x_w[1]))
    assert set(t2.tolist()) == {0, 1} and set(t3.tolist()) == {0}
    xs, ys = ints(x_w[0]), ints(x_w[1])
    assert ints(got.numpy()) == [a * b % spec.p for a, b in zip(xs, ys)]


@pytest.mark.parametrize("prime", PRIMES)
def test_shift_w_matches_host_field(prime):
    spec = field_spec(prime)
    f, hf = TorchField(spec), HostField(jax_field_spec(prime))
    x_w, _ = operands(prime, seed=5)
    xs = ints(x_w[0])
    for count in unit_shifts(spec.n_limbs):
        for left in (True, False):
            got = wide.shift_w(f, i64(x_w[0]), count, left)
            want = [hf.shift_l(x, count) if left else hf.shift_r(x, count)
                    for x in xs]
            assert ints(got.numpy()) == want, (count, left)


@pytest.mark.parametrize("prime", PRIMES)
def test_idiv_matches_host_division(prime):
    spec = field_spec(prime)
    x_w, _ = operands(prime, seed=6)
    x_w[1, :, -3:] = 0     # and random dividends over 0
    got = wide.idiv64(TorchField(spec), i64(x_w[0]), i64(x_w[1]))
    want = [a // b if b else 0 for a, b in zip(ints(x_w[0]), ints(x_w[1]))]
    assert ints(got.numpy()) == want


@pytest.mark.parametrize("prime", PRIMES)
def test_widen64_is_the_signed_value_mod_p(prime):
    spec = field_spec(prime)
    _, x_n = operands(prime)
    got = wide.widen64(TorchField(spec), i64(x_n[0]))
    assert ints(got.numpy()) == [int(v) % spec.p for v in x_n[0]]


@pytest.mark.parametrize("op", ["nsub", "nsel", "nidiv", "lnot_n"]
                         + [f"{o}_nn" for o in ("eq", "neq", "lt", "le",
                                                "gt", "ge", "land", "lor")])
def test_narrow_k1d_op_matches_jax_kernel(op):
    _, x_n = operands("bn128", seed=7)
    x_n[1, 130:140] = 0    # nidiv's guard, against random dividends
    want = np.asarray(jax_narrow(op, *(jnp.asarray(v) for v in x_n)))
    a, b, c = (i64(v) for v in x_n)
    got = nsel(a, b, c) if op == "nsel" else NARROW_OPS[op](a, b, 0)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_nidiv_edges_pinned():
    """jnp's int32 `//` floors, and INT32_MIN // -1 wraps; C truncates and
    leaves the second undefined."""
    a = np.asarray([-2 ** 31, -7, 7, -7, 0, 2 ** 31 - 1, 5], np.int32)
    b = np.asarray([-1, 2, -2, -2, -3, -1, 0], np.int32)
    want = [-2 ** 31, -4, -4, 3, 0, -2 ** 31 + 1, 0]
    assert np.asarray(jax_narrow("nidiv", jnp.asarray(a), jnp.asarray(b),
                                 None)).tolist() == want
    assert NARROW_OPS["nidiv"](i64(a), i64(b), 0).tolist() == want


def unit_reference(spec, op, aux, x_w, x_n):
    """The JAX / host value of one unit-plan step on the unit inputs."""
    L = spec.n_limbs
    x, y, z = x_w
    crow = np.repeat(int_to_limbs(wide_edges(spec.p)[aux], L)[:, None], B,
                     1) if op in BANK_B or op == "nband_w" else None
    hf = HostField(jax_field_spec(spec.name))
    if op in ("gmul", "add") or op in wide.EMIT_OPS:
        return jax_wide(spec, op, x, y, z)
    if op in ("gmul_c", "mul_c"):
        return jax_wide(spec, op, x, crow)
    if op == "sub_c":
        return jax_wide(spec, "sub", x, crow)
    if op == "csub_c":
        return jax_wide(spec, "sub", crow, x)
    if op == "mul_one":
        return jax_wide(spec, op, x, np.repeat(int_to_limbs(1, L)[:, None],
                                                B, 1))
    if op in ("shl_kw", "shr_kw"):
        f = hf.shift_l if op == "shl_kw" else hf.shift_r
        vals = [f(v, aux) for v in ints(x)]
    elif op == "idiv":
        vals = [a // b if b else 0 for a, b in zip(ints(x), ints(y))]
    elif op == "widen":
        vals = [int(v) % spec.p for v in x_n[0]]
    else:
        na, nb, nc = (jnp.asarray(v) for v in x_n)
        if op == "nsel_w":
            return np.asarray(jnp.where(jnp.asarray((x != 0).any(0)), nb, nc))
        if op == "lnot_w":
            return np.where((x != 0).any(0), 0, 1)
        if op == "nband_w":
            v = (x[0] & crow[0]) | ((x[1] & crow[1]) << 16)
            return v.astype(np.uint32).view(np.int32)
        if op.endswith("_ww"):
            return jax_wide(spec, op[:-3], x, y)[0]
        return np.asarray(jax_narrow(op, na, nb, nc))
    return np.stack([int_to_limbs(v, L) for v in vals], 1)


@pytest.mark.parametrize("prime", PRIMES)
def test_unit_plan_through_plain_executor(prime):
    """One step per K1c/K1d opcode (and bank row, and shift count) through
    run_plan: each emitted row equals its reference."""
    spec = field_spec(prime)
    ops = K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks" else ("add",))
    arrays, cases = unit_arrays(spec.p, spec.n_limbs, ops)
    plan = plan_from_arrays(arrays, "cpu")
    assert plan.opcodes == set(ops)
    x_w, x_n = operands(prime, seed=8)
    bank, bank_n = run_plan(plan, TorchField(spec), i64(x_w), i64(x_n))
    n_idx, w_idx = (list(v) for v in (plan.nw_idx, plan.wd_idx))
    for t, (op, aux) in enumerate(cases):
        want = unit_reference(spec, op, aux, x_w, x_n)
        if t in n_idx:
            got = bank_n[plan.nw_src[n_idx.index(t)]]
        else:
            got = bank[plan.wd_src[w_idx.index(t)]]
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"{op} {aux}")


def test_narrow_edges_cover_the_int32_extremes():
    assert set(NARROW_EDGES) >= {-2 ** 31, 2 ** 31 - 1, -1, 0, 1}
