"""Fused mask synthesis + box crop (K4), its wrapper and its plain version.

The CUDA source is xrseg_tpu_torch/csrc/mask_synth_crop.cu (a warp per
tile of 32 pixels of one mask row, each pixel's prototypes in
registers, coefficients and box bounds in shared memory, and nothing but
zero stores for an instance whose box the tile does not meet); it
replaces the TPU kernel
xrseg_tpu/ops/pallas_kernels.py `mask_synth_crop_pallas` (K4).

  mask_synth_crop_cuda   coefs [D,nm], protos [h,w,nm], boxes [D,4] (cx, cy,
                         w, h in input pixels) -> masks [D,h,w] f32; an
                         optional leading batch dim on all three stands for
                         the JAX vmap and runs in one launch

As in the JAX package, K4 is a standalone function: the frame pipeline
keeps the unfused formulation (ops/masks.py), so no path of build_pipeline
launches it.

A wrapper given CPU tensors runs the plain version (mask_synth_crop_torch
= crop_masks(synthesize_masks(...))); given CUDA tensors it launches the
kernel or raises. The wrapper counts its launches in ops/launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.ops import masks as mask_ops


def mask_synth_crop_torch(coefs: torch.Tensor, protos: torch.Tensor,
                          boxes_xywh: torch.Tensor,
                          mask_hw: Tuple[int, int] = (160, 160),
                          input_size: Tuple[int, int] = (640, 640)
                          ) -> torch.Tensor:
    """K4's plain version: crop_masks(synthesize_masks(coefs, protos))."""
    _check_shapes(coefs, protos, boxes_xywh, mask_hw)
    return mask_ops.crop_masks(mask_ops.synthesize_masks(coefs, protos),
                               boxes_xywh.float(), input_size)


def _check_shapes(coefs, protos, boxes, mask_hw) -> None:
    lead = coefs.shape[:-2]
    D, nm = coefs.shape[-2:]
    if coefs.dim() not in (2, 3) or protos.dim() != coefs.dim() + 1 \
            or tuple(protos.shape) != (*lead, *mask_hw, nm) \
            or tuple(boxes.shape) != (*lead, D, 4):
        raise ValueError(
            f"mask_synth_crop takes coefs [(B,)D,nm], protos [(B,)h,w,nm] "
            f"with (h, w) = mask_hw {tuple(mask_hw)} and boxes [(B,)D,4]; got "
            f"{tuple(coefs.shape)}, {tuple(protos.shape)}, "
            f"{tuple(boxes.shape)}")


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "xrseg_mask_synth_crop": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF,
                              _VP, _VP],
    "xrseg_mask_synth_crop_max_d": [_CI],
    "xrseg_mask_synth_crop_nm": [],
}


def _lib() -> ctypes.CDLL:
    return _build.library("mask_synth_crop", _SIGNATURES)


def mask_synth_crop_cuda(coefs: torch.Tensor, protos: torch.Tensor,
                         boxes_xywh: torch.Tensor,
                         mask_hw: Tuple[int, int] = (160, 160),
                         input_size: Tuple[int, int] = (640, 640)
                         ) -> torch.Tensor:
    """K4: coefs [(B,)D,nm], protos [(B,)h,w,nm], boxes [(B,)D,4] f32 ->
    cropped sigmoid masks [(B,)D,h,w] f32."""
    if coefs.device.type == "cpu":
        return mask_synth_crop_torch(coefs, protos, boxes_xywh, mask_hw,
                                     input_size)
    if not coefs.is_cuda:
        raise ValueError(f"mask_synth_crop runs on cuda or cpu tensors, not "
                         f"{coefs.device}")
    _check_shapes(coefs, protos, boxes_xywh, mask_hw)
    tensors = (coefs, protos, boxes_xywh)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("mask_synth_crop needs float32 inputs, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != coefs.device for t in tensors):
        raise ValueError("mask_synth_crop inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mask_synth_crop needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mask_synth_crop reads its inputs 16 bytes at a "
                         "time: each must start on a 16-byte boundary")
    lib = _lib()
    batched = coefs.dim() == 3
    B = coefs.shape[0] if batched else 1
    D, nm = coefs.shape[-2:]
    h, w = mask_hw
    if nm != lib.xrseg_mask_synth_crop_nm():
        raise ValueError(f"the kernel is built for "
                         f"{lib.xrseg_mask_synth_crop_nm()} prototypes, got "
                         f"nm={nm}")
    max_d = lib.xrseg_mask_synth_crop_max_d(_build.device_index(coefs.device))
    if D > max_d:
        raise ValueError(f"D={D} instances exceed the kernel's shared-memory "
                         f"limit of {max_d} on this card")
    out = torch.empty((B, D, h, w), dtype=torch.float32, device=coefs.device)
    # the scale factors as torch rounds them when a float32 tensor is
    # multiplied by a Python float (crop_masks)
    sx = float(np.float32(w / input_size[1]))
    sy = float(np.float32(h / input_size[0]))
    with torch.cuda.device(coefs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xrseg_mask_synth_crop(
            coefs.data_ptr(), protos.data_ptr(), boxes_xywh.data_ptr(), B, D,
            h, w, sx, sy, out.data_ptr(), stream)
    _build.check_launch(lib, err, "mask_synth_crop")
    launches.count("mask_synth_crop_cuda")
    return out if batched else out[0]
