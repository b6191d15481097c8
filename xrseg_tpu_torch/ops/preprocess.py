"""Frame preprocessing: uint8 frames -> normalised model input (NHWC).

Counterpart of xrseg_tpu/ops/preprocess.py. The resize is the separable
2-tap bilinear of `_tap_indices` (half-pixel centres, no antialiasing),
written as two row/column gathers and lerps in the compute dtype, with the
uint8 -> dtype conversion and the 1/255 scale applied first, as the JAX
code does. `F.interpolate` samples differently on downscale, so it is not
used.

mode="stretch" is the reference's ToTensor semantics; mode="letterbox"
pads to the model size with gray 114 (ultralytics semantics).

The gather plan and the 1/255 scale are small constants of the geometry.
They are uploaded once per (geometry, dtype, device) and kept, so a frame
uploads nothing but itself and the host never waits for the card here.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from xrseg_tpu_torch.precision import precision_scope


def _tap_indices(src: int, dst: int):
    """2-tap bilinear gather plan: (idx0, idx1, w1) per output coordinate
    (half-pixel-centre convention)."""
    s = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s0 = np.floor(s).astype(np.int64)
    frac = (s - s0).astype(np.float32)
    i0 = np.clip(s0, 0, src - 1)
    i1 = np.clip(s0 + 1, 0, src - 1)
    return i0, i1, frac


@functools.lru_cache(maxsize=64)
def _taps_on(src: int, dst: int, dtype: torch.dtype, device: torch.device):
    """_tap_indices as tensors on `device` (the weight in `dtype`)."""
    i0, i1, f = _tap_indices(src, dst)
    return (torch.as_tensor(i0, device=device),
            torch.as_tensor(i1, device=device),
            torch.as_tensor(f, device=device).to(dtype))


@functools.lru_cache(maxsize=16)
def _scale_on(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1/255 rounded to `dtype`, on `device`."""
    return torch.tensor(1.0 / 255.0, dtype=dtype, device=device)


def _lerp_axis(x: torch.Tensor, axis: int, src: int, dst: int
               ) -> torch.Tensor:
    i0, i1, f = _taps_on(src, dst, x.dtype, x.device)
    shape = [1] * x.dim()
    shape[axis] = dst
    f = f.reshape(shape)
    return x.index_select(axis, i0) * (1 - f) + x.index_select(axis, i1) * f


def resize_normalize(frames: torch.Tensor, out_hw: Tuple[int, int],
                     dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B,H,W,3] -> dtype [B,oh,ow,3] in [0, 1]."""
    _, H, W, _ = frames.shape
    oh, ow = out_hw
    x = frames.to(dtype) * _scale_on(dtype, frames.device)
    if H != oh:
        x = _lerp_axis(x, 1, H, oh)
    if W != ow:
        x = _lerp_axis(x, 2, W, ow)
    return x


def preprocess(frames: torch.Tensor, out_hw: Tuple[int, int] = (640, 640),
               mode: str = "stretch", dtype=torch.float32) -> torch.Tensor:
    """[B,H,W,3] uint8 (or float 0..255) -> [B,out_h,out_w,3] in [0, 1]."""
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [B,H,W,3] frames, got "
                         f"{tuple(frames.shape)}")
    B, H, W, _ = frames.shape
    oh, ow = out_hw
    if mode == "stretch":
        return resize_normalize(frames, (oh, ow), dtype)
    if mode == "letterbox":
        r, top, left = letterbox_params((H, W), (oh, ow))
        nh, nw = int(round(H * r)), int(round(W * r))
        out = torch.full((B, oh, ow, 3), 114.0 / 255.0, dtype=dtype,
                         device=frames.device)
        out[:, top:top + nh, left:left + nw] = resize_normalize(
            frames, (nh, nw), dtype)
        return out
    raise ValueError(f"unknown preprocess mode {mode!r}")


def _triangle_weights(src: int, dst: int) -> np.ndarray:
    """jax.image.resize's "bilinear" weight matrix [src, dst] in float32
    (its compute_weight_mat with the triangle kernel, antialiased): half-
    pixel centres, the kernel widened by src/dst on an axis that shrinks,
    columns normalised to sum 1, and zero where a sample falls outside
    the input."""
    inv = np.float32(src / dst)
    sample = ((np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None]) \
        / np.maximum(inv, np.float32(1.0))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _triangle_on(src: int, dst: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """_triangle_weights rounded to `dtype` (as JAX casts them to the
    image's), held in float32 on `device`."""
    w = torch.as_tensor(_triangle_weights(src, dst), device=device)
    return w.to(dtype).float()


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """jax.image.resize(x, (B, oh, ow, C), "bilinear") of an NHWC float
    tensor: separable triangle-filter products, antialiased on an axis
    that shrinks (jax's default), accumulated in float32 and rounded to
    x's dtype after each axis; full float32 products (no TF32), as jax
    runs them at Precision.HIGHEST. The test-time augmentation's scaled
    views use it; it is not the frame resize above."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    y = x
    with precision_scope("highest"):
        if H != oh:
            wh = _triangle_on(H, oh, x.dtype, x.device)
            y = torch.einsum("bhwc,hk->bkwc", y.float(), wh).to(x.dtype)
        if W != ow:
            ww = _triangle_on(W, ow, x.dtype, x.device)
            y = torch.einsum("bhwc,wk->bhkc", y.float(), ww).to(x.dtype)
    return y


def letterbox_params(in_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """(scale, pad_top, pad_left) mapping model-space boxes back to the
    original frame in letterbox mode."""
    H, W = in_hw
    oh, ow = out_hw
    r = min(oh / H, ow / W)
    nh, nw = int(round(H * r)), int(round(W * r))
    return r, (oh - nh) // 2, (ow - nw) // 2


def boxes_to_frame_space(boxes_xywh, in_hw, out_hw=(640, 640),
                         mode: str = "stretch") -> np.ndarray:
    """Map model-space cxcywh boxes back to original-frame pixels (numpy)."""
    if isinstance(boxes_xywh, torch.Tensor):
        boxes_xywh = boxes_xywh.detach().cpu().numpy()
    b = np.asarray(boxes_xywh, np.float32).copy()
    H, W = in_hw
    oh, ow = out_hw
    if mode == "stretch":
        b[..., 0] *= W / ow
        b[..., 2] *= W / ow
        b[..., 1] *= H / oh
        b[..., 3] *= H / oh
        return b
    r, top, left = letterbox_params(in_hw, out_hw)
    b[..., 0] = (b[..., 0] - left) / r
    b[..., 1] = (b[..., 1] - top) / r
    b[..., 2] /= r
    b[..., 3] /= r
    return b
