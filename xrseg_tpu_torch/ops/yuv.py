"""YUV420 (planar I420) -> RGB conversion for camera-format frames
(counterpart of xrseg_tpu/ops/yuv.py).

Camera surfaces deliver YUV_420_888; the pipeline's input_format="yuv420"
takes the three planes and converts on the device, so the host never
touches the pixels twice.

BT.601 full range (the Android default for camera YUV):
  R = Y + 1.402 (V-128)
  G = Y - 0.344136 (U-128) - 0.714136 (V-128)
  B = Y + 1.772 (U-128)
"""
from __future__ import annotations

import numpy as np
import torch


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """y: [B,H,W] uint8; u, v: [B,H/2,W/2] uint8 -> [B,H,W,3] float32 in
    0..255. Chroma is upsampled 2x by nearest neighbour."""
    yf = y.float()
    uf = u.float().repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    vf = v.float().repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return torch.stack([r, g, b], -1).clamp_(0.0, 255.0)


def rgb_to_yuv420_numpy(rgb):
    """Host-side inverse: [B,H,W,3] -> (y, u, v) uint8 planes, chroma
    averaged over 2x2 (test fixture, synthetic camera source)."""
    rgb = np.asarray(rgb, np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) / 1.772 + 128.0
    v = (r - y) / 1.402 + 128.0

    def down(c):
        B, H, W = c.shape
        return c.reshape(B, H // 2, 2, W // 2, 2).mean((2, 4))

    def clip(a):
        return np.clip(np.round(a), 0, 255).astype(np.uint8)

    return clip(y), clip(down(u)), clip(down(v))
