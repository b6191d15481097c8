"""Instance-mask synthesis: coefficients x prototypes -> per-instance masks
(counterpart of xrseg_tpu/ops/masks.py).

The product is a plain matmul (the JAX package leaves it to XLA; kernel K4,
the fused synthesis + crop, is still to be ported, ROADMAP queue 2). As in
the JAX einsum with preferred_element_type=float32, operands of a narrower
mask dtype are multiplied exactly and accumulated in float32.
"""
from __future__ import annotations

import torch


def synthesize_masks(coefs: torch.Tensor, protos: torch.Tensor
                     ) -> torch.Tensor:
    """coefs [...,D,nm] x protos [...,H,W,nm] -> [...,D,H,W] f32 sigmoid
    masks."""
    H, W, nm = protos.shape[-3:]
    flat = protos.reshape(*protos.shape[:-3], H * W, nm).float()
    logits = coefs.float() @ flat.transpose(-1, -2)
    return torch.sigmoid(logits).reshape(*logits.shape[:-1], H, W)


def crop_masks(masks: torch.Tensor, boxes_xywh: torch.Tensor,
               input_size) -> torch.Tensor:
    """Zero mask pixels outside each box: inclusive bounds in mask space
    (pixel centres are integer mask coordinates). masks [...,D,H,W], boxes
    [...,D,4] in input pixels."""
    H, W = masks.shape[-2:]
    sx = W / input_size[1]
    sy = H / input_size[0]
    cx = (boxes_xywh[..., 0] * sx)[..., None, None]
    cy = (boxes_xywh[..., 1] * sy)[..., None, None]
    hw = (boxes_xywh[..., 2] * sx * 0.5)[..., None, None]
    hh = (boxes_xywh[..., 3] * sy * 0.5)[..., None, None]
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)[:, None]
    inside = ((xs >= cx - hw) & (xs <= cx + hw)
              & (ys >= cy - hh) & (ys <= cy + hh))
    return masks * inside


def threshold_masks(masks: torch.Tensor, confidence: float) -> torch.Tensor:
    """Binary mask at the vis/depth confidence gate."""
    return masks > confidence


def synthesize_one_mask(coefs: torch.Tensor, protos: torch.Tensor,
                        index) -> torch.Tensor:
    """One instance's mask for the coefs-only mode: coefs [D,nm], protos
    [H,W,nm], index (int or 0-dim tensor) -> [H,W] f32 sigmoid mask."""
    return torch.sigmoid(protos.float() @ coefs[index].float())
