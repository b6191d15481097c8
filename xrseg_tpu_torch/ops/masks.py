"""Instance-mask synthesis: coefficients x prototypes -> per-instance masks
(counterpart of xrseg_tpu/ops/masks.py).

The product is a plain matmul (the JAX package leaves it to XLA; kernel K4,
the fused synthesis + crop, is ops/mask_kernels.py and stands on no path,
as in the JAX package). As in the JAX einsum with
preferred_element_type=float32, operands of a narrower mask dtype are
multiplied exactly and accumulated in float32.
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
    [H,W,nm], index (int or 0-dim tensor) -> [H,W] f32 sigmoid mask. The
    row is taken with index_select, so an index that lives on the device
    stays there (coefs[index] would read it back to the host)."""
    return torch.sigmoid(protos.float() @ select_row(coefs, index).float())


def select_row(rows: torch.Tensor, index) -> torch.Tensor:
    """rows[index] for an int or a 0-dim integer tensor, without a host
    read of a device index."""
    index = torch.as_tensor(index, device=rows.device).reshape(1)
    return rows.index_select(0, index.long())[0]
