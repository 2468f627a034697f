"""TorchField and the field-kernel wrappers against the JAX field library.

Inputs are random canonical limb planes from numpy's default_rng; field
elements are integers, so every comparison is exact (tolerance 0).  The
JAX side runs on the CPU: JaxField's plain XLA path at every prime, and the
Pallas kernels of pallas_field in interpret mode at goldilocks (L = 4;
bn128 in interpret mode takes minutes per multiply).  The CUDA kernels
themselves are held against TorchField on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.ops import pallas_field
from circom_tpu.ops.jfield import JaxField
from circom_tpu_torch.field.primes import LIMB_BITS, field_spec
from circom_tpu_torch.ops import field_kernels as fk
from circom_tpu_torch.ops.field import TorchField

PRIMES = ["bn128", "goldilocks", "bls12381"]


def canonical(rng, prime, shape):
    """Random canonical elements, uint32 limbs (..., L, B)."""
    spec = field_spec(prime)
    L = spec.n_limbs
    top = spec.p >> (LIMB_BITS * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return x


def to_np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def operands(prime, seed=0, n=3, b=5):
    rng = np.random.default_rng(seed)
    L = field_spec(prime).n_limbs
    a = canonical(rng, prime, (n, L, b))
    c = canonical(rng, prime, (n, L, b))
    # edge values: 0, 1 and p - 1 in the first lanes
    p = field_spec(prime).p
    for lane, v in enumerate((0, 1, p - 1)):
        for i in range(L):
            a[0, i, lane] = (v >> (LIMB_BITS * i)) & 0xFFFF
    return a, c


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_jaxfield(prime, op):
    a, b = operands(prime)
    jf = JaxField(jax_field_spec(prime))
    tf = TorchField(field_spec(prime))
    want = np.asarray(getattr(jf, op)(a, b))
    got = getattr(tf, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(to_np(got), want)
    # the wrapper's CPU path is the same plain version
    got_w = getattr(fk, op)(tf, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(to_np(got_w), want)


@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("op", ["to_mont", "from_mont", "is_zero"])
def test_unary_ops_match_jaxfield(prime, op):
    a, _ = operands(prime, seed=1)
    jf = JaxField(jax_field_spec(prime))
    tf = TorchField(field_spec(prime))
    want = np.asarray(getattr(jf, op)(a))
    got = getattr(tf, op)(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy() if op == "is_zero"
                                  else to_np(got), want)


@pytest.mark.parametrize("prime", PRIMES)
def test_mont_reduce_cols_matches_jaxfield(prime):
    """Wide, uncarried column sums as the R1CS checker makes them."""
    rng = np.random.default_rng(2)
    L = field_spec(prime).n_limbs
    cols = rng.integers(0, 1 << 22, size=(4, L + 2, 6), dtype=np.uint32)
    cols[:, L:] = 0
    jf = JaxField(jax_field_spec(prime))
    tf = TorchField(field_spec(prime))
    want = np.asarray(jf.mont_reduce_cols(cols))
    np.testing.assert_array_equal(
        to_np(tf.mont_reduce_cols(torch.from_numpy(cols))), want)


def test_to_mont_broadcast_wrapper():
    """fk.to_mont multiplies by R^2 broadcast over (N, L, B)."""
    a, _ = operands("bn128", seed=3)
    tf = TorchField(field_spec("bn128"))
    jf = JaxField(jax_field_spec("bn128"))
    np.testing.assert_array_equal(to_np(fk.to_mont(tf, torch.from_numpy(a))),
                                  np.asarray(jf.to_mont(a)))


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_matches_pallas_kernels_in_interpret_mode(op):
    """The Pallas kernels themselves (interpret mode) at goldilocks."""
    rng = np.random.default_rng(4)
    a = canonical(rng, "goldilocks", (2, 4, 8))
    b = canonical(rng, "goldilocks", (2, 4, 8))
    make = {"mont_mul": pallas_field.make_mont_mul,
            "add": pallas_field.make_add, "sub": pallas_field.make_sub}[op]
    want = np.asarray(make(jax_field_spec("goldilocks"), interpret=True)(a, b))
    tf = TorchField(field_spec("goldilocks"))
    got = getattr(tf, op)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(to_np(got), want)


def test_wrapper_rejects_mixed_devices():
    tf = TorchField(field_spec("goldilocks"))
    a = torch.zeros((1, 4, 8), dtype=torch.uint32)
    with pytest.raises(ValueError):
        fk.mont_mul(tf, a, torch.zeros((1, 4, 8), dtype=torch.uint32,
                                       device="meta"))
