"""Matmul-precision control: ModelConfig.matmul_precision onto torch's switches.

The JAX package maps the knob onto `jax.default_matmul_precision`, where the
TPU's default runs float32 products as bf16 passes. The card's analogue is
TF32. PyTorch keeps two separate switches for it, and their defaults
differ: cuBLAS matmuls default to full float32
(`torch.backends.cuda.matmul.allow_tf32 = False`) while cuDNN convolutions
default to TF32 (`torch.backends.cudnn.allow_tf32 = True`). So the scope
sets BOTH, every time, and restores both on exit:

  "default" | "high" | "tensorfloat32" | "bfloat16"  -> TF32 allowed
  "highest" | "float32"                              -> TF32 off (exact parity)

Only float32 operands are affected; bf16 compute is bf16 either way.
"""
from __future__ import annotations

import contextlib

import torch

_TF32 = {"default": True, "high": True, "tensorfloat32": True,
         "bfloat16": True, "highest": False, "float32": False}


@contextlib.contextmanager
def precision_scope(name: str | None):
    """Set both TF32 switches for the body of the `with`, then restore."""
    name = "default" if name is None else name
    if name not in _TF32:
        raise ValueError(f"matmul_precision {name!r}; expected one of "
                         f"{tuple(_TF32)}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = _TF32[name]
    torch.backends.cudnn.allow_tf32 = _TF32[name]
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
