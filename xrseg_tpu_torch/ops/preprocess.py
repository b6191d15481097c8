"""Frame preprocessing: uint8 frames -> normalised model input (NHWC).

Counterpart of xrseg_tpu/ops/preprocess.py. The resize is the separable
2-tap bilinear of `_tap_indices` (half-pixel centres, no antialiasing),
written as two row/column gathers and lerps in the compute dtype, with the
uint8 -> dtype conversion and the 1/255 scale applied first, as the JAX
code does. `F.interpolate` samples differently on downscale, so it is not
used.

mode="stretch" is the reference's ToTensor semantics; mode="letterbox"
pads to the model size with gray 114 (ultralytics semantics).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _tap_indices(src: int, dst: int):
    """2-tap bilinear gather plan: (idx0, idx1, w1) per output coordinate
    (half-pixel-centre convention)."""
    s = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s0 = np.floor(s).astype(np.int64)
    frac = (s - s0).astype(np.float32)
    i0 = np.clip(s0, 0, src - 1)
    i1 = np.clip(s0 + 1, 0, src - 1)
    return i0, i1, frac


def _lerp_axis(x: torch.Tensor, axis: int, src: int, dst: int
               ) -> torch.Tensor:
    i0, i1, f = _tap_indices(src, dst)
    shape = [1] * x.dim()
    shape[axis] = dst
    f = torch.as_tensor(f, device=x.device).to(x.dtype).reshape(shape)
    i0 = torch.as_tensor(i0, device=x.device)
    i1 = torch.as_tensor(i1, device=x.device)
    return x.index_select(axis, i0) * (1 - f) + x.index_select(axis, i1) * f


def resize_normalize(frames: torch.Tensor, out_hw: Tuple[int, int],
                     dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B,H,W,3] -> dtype [B,oh,ow,3] in [0, 1]."""
    _, H, W, _ = frames.shape
    oh, ow = out_hw
    x = frames.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                        device=frames.device)
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
