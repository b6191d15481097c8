"""Fixed-shape, class-aware greedy NMS (counterpart of xrseg_tpu/ops/nms.py).

Same contract as the JAX package: max_det greedy select-and-suppress
steps over all candidates (one IoU row per step, no KxK matrix), landing
in a padded max_det slate plus a count. Class awareness shifts each box
by label * _CLASS_OFFSET instead of looping over classes.

Backends:
  "scan"  the plain torch loop (`_select_and_suppress`), on any device;
  "cuda"  the hand-written kernel (ops/nms_kernels.py: K2 for nms_fixed,
          K1 for nms_fixed_batched);
  "auto"  "cuda" for CUDA tensors, "scan" for CPU tensors.
Both are exact greedy NMS and give identical results.
"""
from __future__ import annotations

from typing import Dict

import torch

from xrseg_tpu_torch.ops.nms_kernels import (NEG, as_f32, nms_select_batched_cuda,
                                             nms_select_cuda)

# Separates classes in the shared coordinate space; exceeds any real
# coordinate (inputs are at most a few thousand pixels).
_CLASS_OFFSET = 8192.0


def resolve_backend(backend: str, like: torch.Tensor) -> str:
    if backend == "auto":
        return "cuda" if like.is_cuda else "scan"
    if backend not in ("scan", "cuda"):
        raise ValueError(f"nms backend {backend!r}; expected 'auto', 'scan' "
                         "or 'cuda'")
    return backend


def xywh_to_corners(xywh: torch.Tensor) -> torch.Tensor:
    """cxcywh -> x1y1x2y2."""
    cxy, wh = xywh[..., :2], xywh[..., 2:]
    half = wh * 0.5
    return torch.cat([cxy - half, cxy + half], -1)


def _select_and_suppress(corners: torch.Tensor, scores: torch.Tensor,
                         alive0: torch.Tensor, iou_threshold: float,
                         max_det: int):
    """max_det steps of: pick the best alive candidate, kill its overlaps.

    corners [...,K,4] (class offset applied), scores/alive0 [...,K]; any
    leading batch dims run as independent rows. Returns (indices
    [...,max_det] int32, ok [...,max_det] bool) in selection order."""
    sc = scores.float()
    x1, y1, x2, y2 = corners.float().unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    k_idx = torch.arange(sc.shape[-1], device=sc.device)
    thr = as_f32(iou_threshold)
    masked = torch.where(alive0, sc, -torch.inf)
    idxs, oks = [], []
    for _ in range(max_det):
        i = masked.argmax(-1, keepdim=True)        # first maximum

        def g(v):
            return v.gather(-1, i)

        ok = g(masked) != -torch.inf
        iw = (torch.minimum(x2, g(x2)) - torch.maximum(x1, g(x1))).clamp_min(0)
        ih = (torch.minimum(y2, g(y2)) - torch.maximum(y1, g(y1))).clamp_min(0)
        inter = iw * ih
        union = area + g(area) - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        # the selected candidate leaves the pool too (covers zero-area
        # boxes, whose self-IoU is 0)
        suppress = (iou > thr) | (k_idx == i)
        masked = torch.where(ok & suppress, -torch.inf, masked)
        idxs.append(i[..., 0])
        oks.append(ok[..., 0])
    return torch.stack(idxs, -1).int(), torch.stack(oks, -1)


def class_corners(boxes_xywh, labels, class_aware: bool) -> torch.Tensor:
    corners = xywh_to_corners(boxes_xywh)
    if class_aware:
        corners = corners + labels[..., None].to(corners.dtype) * _CLASS_OFFSET
    return corners


def nms_fixed(boxes_xywh: torch.Tensor, scores: torch.Tensor,
              labels: torch.Tensor, *, iou_threshold: float,
              score_threshold: float, pre_topk: int = 0, max_det: int = 50,
              class_aware: bool = True,
              backend: str = "scan") -> Dict[str, torch.Tensor]:
    """Single-image fixed-shape NMS.

    boxes_xywh [A,4] (input pixels), scores [A] f32, labels [A] int.
    pre_topk: 0 = every anchor is a candidate (exact at any density);
    >0 = compact the above-gate candidates into pre_topk slots (cumsum
    slot assignment, no sort); exact unless more than pre_topk anchors
    clear the gate, in which case the excess is dropped in anchor order.
    Returns the padded slate: indices [max_det] int32, boxes_xywh, scores,
    labels int32, valid bool, count int32 (0-dim).
    """
    A = scores.shape[0]
    alive_full = scores > as_f32(score_threshold)
    if pre_topk and pre_topk < A:
        slot = torch.where(alive_full, alive_full.cumsum(0) - 1, pre_topk)
        slot = slot.clamp_max(pre_topk)    # slot pre_topk is the drop bin

        def compact(x, fill=0):
            out = torch.full((pre_topk + 1,) + tuple(x.shape[1:]), fill,
                             dtype=x.dtype, device=x.device)
            out[slot] = x
            return out[:pre_topk]

        top_scores = compact(scores)
        top_idx = compact(torch.arange(A, dtype=torch.int32,
                                       device=scores.device))
        top_boxes = compact(boxes_xywh)
        top_labels = compact(labels)
        alive0 = compact(alive_full, fill=False)
    else:
        top_scores, top_boxes, top_labels = scores, boxes_xywh, labels
        top_idx = torch.arange(A, dtype=torch.int32, device=scores.device)
        alive0 = alive_full

    corners = class_corners(top_boxes, top_labels, class_aware)
    if resolve_backend(backend, scores) == "cuda":
        masked0 = torch.where(alive0, top_scores.float(), NEG)
        sel, ok = nms_select_cuda(corners.float().contiguous(), masked0,
                                  iou_threshold, max_det)
    else:
        sel, ok = _select_and_suppress(corners, top_scores, alive0,
                                       iou_threshold, max_det)
    return _take_slate(sel, ok, top_idx, top_boxes, top_scores, top_labels)


def _take_slate(sel, ok, top_idx, top_boxes, top_scores, top_labels
                ) -> Dict[str, torch.Tensor]:
    """Selection (indices, ok) [...,D] -> padded output slate [...,D,...];
    invalid rows are zero."""
    safe = torch.where(ok, sel, 0).long()
    nd = safe.dim()

    def take(x):
        extra = (None,) * (x.dim() - nd)
        index = safe[(...,) + extra].expand(*safe.shape, *x.shape[nd:])
        picked = x.gather(nd - 1, index)
        return torch.where(ok[(...,) + extra], picked,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return {
        "indices": take(top_idx.int()),
        "boxes_xywh": take(top_boxes),
        "scores": take(top_scores),
        "labels": take(top_labels.int()),
        "valid": ok,
        "count": ok.sum(-1).int(),
    }


def nms_fixed_batched(boxes_xywh: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, *, iou_threshold: float,
                      score_threshold: float, max_det: int = 50,
                      class_aware: bool = True,
                      backend: str = "scan") -> Dict[str, torch.Tensor]:
    """Batched NMS over [B,A,...] inputs (always full width: no pre_topk).

    backend "cuda" runs ONE kernel launch for the whole batch (K1: one
    block per image); "scan" runs the plain loop over all rows at once.
    Results are identical."""
    B, A = scores.shape
    corners = class_corners(boxes_xywh, labels, class_aware)
    alive = scores > as_f32(score_threshold)
    if resolve_backend(backend, scores) == "cuda":
        masked = torch.where(alive, scores.float(), NEG)
        sel, ok = nms_select_batched_cuda(corners.float().contiguous(),
                                          masked, iou_threshold, max_det)
    else:
        sel, ok = _select_and_suppress(corners, scores, alive,
                                       iou_threshold, max_det)
    idx = torch.arange(A, dtype=torch.int32, device=scores.device)
    return _take_slate(sel, ok, idx.expand(B, A), boxes_xywh, scores, labels)
