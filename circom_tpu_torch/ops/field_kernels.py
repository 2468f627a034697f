"""Wrappers of the elementwise field kernels (ops/cuda/field_ops.cu).

K5 `mont_mul` replaces the JAX package's Pallas CIOS kernel
(ops/pallas_field.py make_mont_mul); K6 `add` / `sub` replace make_add /
make_sub.  Operands are uint32 limb tensors (..., L, B) that broadcast
against each other (a coefficient column (N, L, 1) against (N, L, B), a
constant (L, 1) against anything).

A CUDA tensor launches the kernel, or raises; a CPU tensor takes the plain
version in TorchField, which the kernels are held against bit for bit.
"""

import torch

from . import build
from .build import library, ll_array, stream_ptr, u32_array
from .field import TorchField, as_u32

_OPS = {"mont_mul": 0, "add": 1, "sub": 2}


def _elementwise(name, field: TorchField, a, b):
    if a.device.type == "cpu" and b.device.type == "cpu":
        return getattr(field, name)(a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dtype != torch.uint32 or b.dtype != torch.uint32:
        raise TypeError(f"{name}: uint32 limb tensors required, got "
                        f"{a.dtype} and {b.dtype}")
    L = field.L
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if len(shape) < 2 or shape[-2] != L:
        raise ValueError(f"{name}: shape {tuple(shape)} is not (..., {L}, B)")
    B = shape[-1]
    N = 1
    for d in shape[:-2]:
        N *= d
    a3 = a.broadcast_to(shape).reshape(N, L, B)
    b3 = b.broadcast_to(shape).reshape(N, L, B)
    out = torch.empty((N, L, B), dtype=torch.uint32, device=a.device)
    if N * B:
        launch(name, field, a3, b3, out)
    return out.reshape(shape)


def launch(name, field: TorchField, a, b, out):
    """Launch K5 or K6 on prepared operands, without checks: a and b
    uint32 (N, L, B) views on the card (strides 0 where they broadcast),
    out a contiguous uint32 (N, L, B) with N, B > 0."""
    N, L, B = out.shape
    build.launch(name, library("field_ops").ctpu_field_elementwise,
                 out.device, _OPS[name], L, a.data_ptr(),
                 ll_array(a.stride()), b.data_ptr(), ll_array(b.stride()),
                 out.data_ptr(), N, B, u32_array(field.p_list), field.n0inv,
                 field.n0inv32, stream_ptr(out.device))


def mont_mul(field: TorchField, a, b):
    """a·b·R^-1 mod p (K5)."""
    return _elementwise("mont_mul", field, a, b)


def add(field: TorchField, a, b):
    """(a + b) mod p (K6)."""
    return _elementwise("add", field, a, b)


def sub(field: TorchField, a, b):
    """(a - b) mod p (K6)."""
    return _elementwise("sub", field, a, b)


def to_mont(field: TorchField, a):
    """a·R mod p, as mont_mul by R^2 (K5)."""
    return mont_mul(field, a, as_u32(field.R2_limbs))


def from_mont(field: TorchField, a):
    """a·R^-1 mod p, as mont_mul by 1 (K5)."""
    return mont_mul(field, a, as_u32(field.one_limbs))
