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
import torch.nn.functional as F


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


def upsample_masks(masks: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize [...,D,h,w] -> [...,D,out_h,out_w] f32
    (display-resolution masks; jax.image.resize "bilinear"). Half-pixel
    centres; an axis that shrinks is antialiased (a triangle filter
    widened by the scale) as jax.image.resize does, so antialiasing is on
    whenever any axis shrinks and off for pure upsampling."""
    h, w = masks.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    x = masks.float().reshape(-1, 1, h, w)
    y = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                      antialias=(oh < h or ow < w))
    return y.reshape(*masks.shape[:-2], oh, ow)


def sam_postprocess_masks(masks: torch.Tensor, input_hw, frame_hw,
                          size: int) -> torch.Tensor:
    """Segment Anything's low-resolution logits [..., h, w] -> logits at
    the frame's size [..., H, W], float32 (SAM's postprocess_masks): a
    bilinear resize to the padded input (size x size), the crop to the
    resized frame (input_hw), a bilinear resize to frame_hw; half-pixel
    centres, no antialiasing (both resizes enlarge). A mask is the logit
    above 0."""
    h, w = masks.shape[-2:]
    x = F.interpolate(masks.float().reshape(-1, 1, h, w), size=(size, size),
                      mode="bilinear", align_corners=False)
    x = x[..., :input_hw[0], :input_hw[1]]
    x = F.interpolate(x, size=tuple(frame_hw), mode="bilinear",
                      align_corners=False)
    return x.reshape(*masks.shape[:-2], *x.shape[-2:])


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
