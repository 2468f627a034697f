"""circom-tpu-torch: the circom witness generator on PyTorch and CUDA."""

from .compiler.executor import register_extern  # noqa: F401
