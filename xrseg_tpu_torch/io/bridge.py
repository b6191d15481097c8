"""JAX params pytree -> the port's torch state: the one place that knows both
layouts.

The JAX package's params are nested dicts and lists of arrays (numpy, or
anything `np.asarray` takes): conv weights HWIO under "w", biases under
"b", and the Proto's transposed-conv weight [kH, kW, in, out] under
"up_w". The port's modules carry the same names in the same nesting
(xrseg_tpu_torch/models/layers.py), so a pytree path becomes a state-dict
key by joining its parts with dots; only the leaves change layout:

  "w"    HWIO [kH,kW,I,O]  -> "weight" OIHW [O,I,kH,kW]   (3, 2, 0, 1)
  "b"                       -> "bias"
  "up_w" [kH,kW,I,O]        -> "up_w" [I,O,kH,kW]          (2, 3, 0, 1)
  "up_b"                    -> "up_b"
  "lin_w" [1280, nc], "lin_b" (the classify head's linear layer) keep
  their names and layout
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models.yolo11 import (YOLO11, refuse_arch,
                                           yolo11_for_state)

_LEAVES = {"w": ("weight", (3, 2, 0, 1)), "b": ("bias", None),
           "up_w": ("up_w", (2, 3, 0, 1)), "up_b": ("up_b", None),
           "lin_w": ("lin_w", None), "lin_b": ("lin_b", None)}


def jax_dims(leaf: str, ndim: int) -> tuple:
    """For a port parameter named `leaf` ("weight", "up_w", "bias", ...)
    of `ndim` dims: the JAX leaf's dim behind each of its dims (OIHW
    "weight" -> (3, 2, 0, 1): its dim 0 is JAX's dim 3, the output
    channels)."""
    for name, perm in _LEAVES.values():
        if name == leaf and perm is not None:
            return perm
    return tuple(range(ndim))


def state_dict_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """Flatten a JAX params (sub)tree into a torch state dict (float32)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            if not path or path[-1] not in _LEAVES:
                raise KeyError(f"unexpected params leaf {'.'.join(path)!r}")
            name, perm = _LEAVES[path[-1]]
            a = np.asarray(node).astype(np.float32)
            if perm is not None:
                a = a.transpose(perm)
            out[".".join(path[:-1] + [name])] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(tree, [])
    return out


def params_from_jax(tree: Any, cfg: ModelConfig) -> YOLO11:
    """The JAX package's params for `cfg` -> a YOLO11 module (on the CPU)
    computing the same function. Every parameter must be present and no
    extra one may be (strict load). Class branches take the tree's width
    (models/yolo11.yolo11_for_state: a transferred checkpoint's)."""
    refuse_arch(cfg, "the JAX bridge")
    return yolo11_for_state(cfg, state_dict_from_jax(tree))
