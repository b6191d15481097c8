"""Fixed-shape, class-aware greedy NMS (counterpart of xrseg_tpu/ops/nms.py).

Same contract as the JAX package: max_det greedy select-and-suppress
steps over all candidates (one IoU row per step, no KxK matrix), landing
in a padded max_det slate plus a count. Class awareness shifts each box
by label * _CLASS_OFFSET instead of looping over classes. Rotated boxes
(the OBB task) use probIoU as the overlap and shift both centre
coordinates.

Backends:
  "scan"  the plain torch loop (`_select_and_suppress`,
          `_select_and_suppress_rotated`), on any device;
  "cuda"  the hand-written kernel (ops/nms_kernels.py: K2 for nms_fixed,
          K1 for nms_fixed_batched, K3 for nms_fixed_rotated_batched);
  "auto"  "cuda" for CUDA tensors, "scan" for CPU tensors.
Both are exact greedy NMS and give identical results.

The numpy references at the end (probiou_numpy, nms_reference_numpy,
nms_rotated_reference_numpy) are the JAX package's naive host oracles,
copied: eval's rotated AP and the parity reports' oracle use them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xrseg_tpu_torch.ops.nms_kernels import (NEG, PROBIOU_EPS, as_f32,
                                             nms_rotated_batched_cuda,
                                             nms_select_batched_cuda,
                                             nms_select_cuda, probiou_gauss,
                                             rbox_covariance,
                                             rotated_gaussian_rows)

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


# ---------------------------------------------------------------------------
# Rotated boxes (OBB task): probIoU select-and-suppress
# ---------------------------------------------------------------------------

def _gauss(xywhr: torch.Tensor):
    a, b, c = rbox_covariance(xywhr)
    return xywhr[..., 0], xywhr[..., 1], a, b, c, (a * b - c * c).clamp_min(0)


def probiou(obb1: torch.Tensor, obb2: torch.Tensor,
            eps: float = PROBIOU_EPS) -> torch.Tensor:
    """Elementwise/broadcast probIoU of rotated boxes [...,5] -> [...]:
    one minus the Hellinger distance of the boxes' Gaussian embeddings
    (the overlap ultralytics' rotated NMS uses)."""
    return probiou_gauss(*_gauss(obb1.float()), *_gauss(obb2.float()), eps)


def probiou_row(box: torch.Tensor, boxes: torch.Tensor,
                eps: float = PROBIOU_EPS) -> torch.Tensor:
    """probIoU of one rotated box [5] against many [K,5] -> [K]."""
    return probiou(box[None] if box.dim() == 1 else box, boxes, eps)


def class_shifted(boxes_xywhr: torch.Tensor, labels: torch.Tensor,
                  class_aware: bool) -> torch.Tensor:
    """Float32 rotated boxes with label * _CLASS_OFFSET added to cx and cy
    (far-apart Gaussians: probIoU ~ 0 across classes)."""
    bx = boxes_xywhr.float()
    if not class_aware:
        return bx
    off = labels.float()[..., None] * _CLASS_OFFSET
    return torch.cat([bx[..., :2] + off, bx[..., 2:]], -1)


def _select_and_suppress_rotated(shifted: torch.Tensor, scores: torch.Tensor,
                                 alive0: torch.Tensor, iou_threshold: float,
                                 max_det: int):
    """The JAX scan path's loop: shifted [...,K,5], scores/alive0 [...,K] ->
    (indices, ok) [...,max_det]. Each box's Gaussian terms are computed
    once; each step takes one probIoU row of the selected box."""
    x, y, a, b, c, det = _gauss(shifted)
    k_idx = torch.arange(scores.shape[-1], device=scores.device)
    thr = as_f32(iou_threshold)
    masked = torch.where(alive0, scores.float(), -torch.inf)
    idxs, oks = [], []
    for _ in range(max_det):
        i = masked.argmax(-1, keepdim=True)        # first maximum

        def g(v):
            return v.gather(-1, i)

        ok = g(masked) != -torch.inf
        iou = probiou_gauss(g(x), g(y), g(a), g(b), g(c), g(det),
                            x, y, a, b, c, det)
        suppress = (iou > thr) | (k_idx == i)
        masked = torch.where(ok & suppress, -torch.inf, masked)
        idxs.append(i[..., 0])
        oks.append(ok[..., 0])
    return torch.stack(idxs, -1).int(), torch.stack(oks, -1)


def nms_fixed_rotated_batched(boxes_xywhr: torch.Tensor,
                              scores: torch.Tensor, labels: torch.Tensor, *,
                              iou_threshold: float, score_threshold: float,
                              max_det: int = 50, class_aware: bool = True,
                              backend: str = "scan"
                              ) -> Dict[str, torch.Tensor]:
    """Batched rotated NMS over [B,A,...] (boxes [B,A,5]: cx, cy, w, h,
    angle in radians). backend "cuda" runs ONE K3 launch for the batch;
    "scan" the plain loop over all rows at once. Identical results. The
    slate's box key is "boxes_xywhr" [B,max_det,5]."""
    B, A = scores.shape
    shifted = class_shifted(boxes_xywhr, labels, class_aware)
    alive = scores > as_f32(score_threshold)
    if resolve_backend(backend, scores) == "cuda":
        masked = torch.where(alive, scores.float(), NEG)
        sel, ok = nms_rotated_batched_cuda(rotated_gaussian_rows(shifted),
                                           masked, iou_threshold, max_det)
    else:
        sel, ok = _select_and_suppress_rotated(shifted, scores, alive,
                                               iou_threshold, max_det)
    idx = torch.arange(A, dtype=torch.int32, device=scores.device)
    out = _take_slate(sel, ok, idx.expand(B, A), boxes_xywhr, scores.float(),
                      labels)
    out["boxes_xywhr"] = out.pop("boxes_xywh")
    return out


def nms_fixed_rotated(boxes_xywhr: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, *, iou_threshold: float,
                      score_threshold: float, max_det: int = 50,
                      class_aware: bool = True,
                      backend: str = "scan") -> Dict[str, torch.Tensor]:
    """Single-image rotated NMS: boxes_xywhr [A,5], scores [A], labels [A]
    -> the padded slate (key "boxes_xywhr" [max_det,5])."""
    out = nms_fixed_rotated_batched(
        boxes_xywhr[None], scores[None], labels[None],
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, class_aware=class_aware, backend=backend)
    return {k: v[0] for k, v in out.items()}


def probiou_numpy(b1, b2, eps=1e-7):
    """Scalar numpy probIoU (test oracle, independent arithmetic)."""

    def cov(b):
        # same 1e-3 px variance floor as the torch op (rbox_covariance)
        a0 = max(b[2], 1e-3) ** 2 / 12.0
        b0 = max(b[3], 1e-3) ** 2 / 12.0
        c, s = np.cos(b[4]), np.sin(b[4])
        return (a0 * c * c + b0 * s * s, a0 * s * s + b0 * c * c,
                (a0 - b0) * c * s)

    b1 = np.asarray(b1, np.float64)
    b2 = np.asarray(b2, np.float64)
    a1, bb1, c1 = cov(b1)
    a2, bb2, c2 = cov(b2)
    # same PSD clamp as the torch op (see probiou): degenerate pairs
    # round the form negative and NaN the log otherwise
    den = max((a1 + a2) * (bb1 + bb2) - (c1 + c2) ** 2, 0.0) + eps
    t1 = ((a1 + a2) * (b1[1] - b2[1]) ** 2
          + (bb1 + bb2) * (b1[0] - b2[0]) ** 2) / den * 0.25
    t2 = ((c1 + c2) * (b2[0] - b1[0]) * (b1[1] - b2[1])) / den * 0.5
    t3 = 0.5 * np.log(den / (4.0 * np.sqrt(
        max((a1 * bb1 - c1 * c1), 0.0) * max((a2 * bb2 - c2 * c2), 0.0))
        + eps) + eps)
    bd = min(max(t1 + t2 + t3, eps), 100.0)
    return 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)


def nms_rotated_reference_numpy(boxes_xywhr, scores, labels, iou_threshold,
                                score_threshold, class_aware=True,
                                max_keep: int = 0):
    """Naive greedy rotated NMS (test oracle). max_keep>0 stops once that
    many boxes are kept — EXACT for the kept[:max_keep] prefix (greedy
    NMS only ever appends, in score order); essential when thousands of
    candidates survive the gate (fixture weights at 640^2)."""
    order = np.argsort(-scores, kind="stable")
    order = [i for i in order if scores[i] > score_threshold]
    kept = []
    for i in order:
        if max_keep and len(kept) >= max_keep:
            break
        ok = True
        for j in kept:
            if class_aware and labels[i] != labels[j]:
                continue
            if probiou_numpy(boxes_xywhr[i], boxes_xywhr[j]) > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(i)
    return kept


def nms_reference_numpy(boxes_xywh, scores, labels, iou_threshold,
                        score_threshold, class_aware=True,
                        max_keep: int = 0):
    """Naive O(N^2) host NMS — test oracle only. max_keep as in
    nms_rotated_reference_numpy (exact early exit for the top prefix)."""
    order = np.argsort(-scores, kind="stable")
    order = [i for i in order if scores[i] > score_threshold]
    kept = []

    def iou(a, b):
        ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
        ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
        bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
        bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
        iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        ih = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = iw * ih
        ua = max(0.0, ax2 - ax1) * max(0.0, ay2 - ay1)
        ub = max(0.0, bx2 - bx1) * max(0.0, by2 - by1)
        u = ua + ub - inter
        return inter / u if u > 0 else 0.0

    for i in order:
        if max_keep and len(kept) >= max_keep:
            break
        ok = True
        for j in kept:
            if class_aware and labels[i] != labels[j]:
                continue
            if iou(boxes_xywh[i], boxes_xywh[j]) > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(i)
    return kept
