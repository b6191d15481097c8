"""Detection/segmentation evaluation: AP (COCO-style), precision/recall
(the port's copy of xrseg_tpu/eval/metrics.py; numpy only).

Self-contained (no pycocotools): greedy score-ordered matching at IoU
thresholds, 101-point interpolated AP, box IoU and mask IoU variants. This
is the parity-measurement tool for the framework's "mask-mAP parity"
target (BASELINE.json): run the same images through a reference
implementation and through us, and compare AP on identical ground truth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.ops.nms import probiou_numpy
from xrseg_tpu_torch.ops.preprocess import boxes_to_frame_space

# COCO 17-keypoint OKS sigmas (the published per-joint tolerance
# constants); non-17 layouts fall back to uniform 1/K. The JAX package
# keeps them in train/losses.py, which the port has not taken yet.
_OKS_SIGMAS_17 = [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                  0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
                  0.089]


def _kpt_sigmas(k: int) -> np.ndarray:
    if k == 17:
        return np.asarray(_OKS_SIGMAS_17, np.float32)
    return np.full((k,), 1.0 / k, np.float32)


def _host(x) -> np.ndarray:
    """A numpy view of a slate entry (a tensor on any device, or numpy)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Detection:
    box_xywh: np.ndarray            # [4] cxcywh
    label: int
    score: float
    mask: Optional[np.ndarray] = None   # bool [H,W] (any resolution)
    kpts: Optional[np.ndarray] = None   # [K,3] x,y,vis (pose task)
    box_xywhr: Optional[np.ndarray] = None  # [5] rotated (obb task)


@dataclasses.dataclass
class GroundTruth:
    box_xywh: np.ndarray
    label: int
    mask: Optional[np.ndarray] = None
    kpts: Optional[np.ndarray] = None
    box_xywhr: Optional[np.ndarray] = None
    # COCO iscrowd/ignore region: detections matching it are dropped from
    # scoring (neither TP nor FP); never counts toward n_gt
    ignore: bool = False


def box_iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / union if union > 0 else 0.0


def oks(det_kpts: np.ndarray, gt_kpts: np.ndarray, gt_area: float,
        sigmas: Optional[np.ndarray] = None) -> float:
    """COCO Object Keypoint Similarity: mean over labeled keypoints of
    exp(-d^2 / (2 * area * (2*sigma)^2)). det/gt kpts [K,3] (x, y, vis);
    only gt-visible keypoints count."""
    k = gt_kpts.shape[0]
    sig = np.asarray(sigmas if sigmas is not None else _kpt_sigmas(k),
                     np.float64)
    vis = gt_kpts[:, 2] > 0.5
    if not vis.any():
        return 0.0
    d2 = ((det_kpts[:, :2] - gt_kpts[:, :2]) ** 2).sum(-1)
    e = d2 / ((2.0 * sig) ** 2) / (2.0 * max(gt_area, 1.0))
    return float(np.exp(-e)[vis].mean())


def _similarity(d: Detection, g: GroundTruth, sim: str) -> float:
    if sim == "mask" and d.mask is not None and g.mask is not None:
        return mask_iou(d.mask, g.mask)
    if sim == "oks" and d.kpts is not None and g.kpts is not None:
        return oks(d.kpts, g.kpts, float(g.box_xywh[2] * g.box_xywh[3]))
    if sim == "rbox" and d.box_xywhr is not None and g.box_xywhr is not None:
        return probiou_numpy(d.box_xywhr, g.box_xywhr)
    return box_iou_xywh(d.box_xywh, g.box_xywh)


def _crowd_similarity(d: Detection, g: GroundTruth, sim: str) -> float:
    """COCO crowd overlap: intersection over DETECTION area (the crowd
    region is not consumed and its own area does not dilute the ratio).
    Mask form when both masks exist, else the box form."""
    if sim == "mask" and d.mask is not None and g.mask is not None:
        dm = np.asarray(d.mask, bool)
        gm = np.asarray(g.mask, bool)
        da = dm.sum()
        return float(np.logical_and(dm, gm).sum()) / da if da else 0.0
    a, b = d.box_xywh, g.box_xywh
    iw = max(0.0, min(a[0] + a[2] / 2, b[0] + b[2] / 2)
             - max(a[0] - a[2] / 2, b[0] - b[2] / 2))
    ih = max(0.0, min(a[1] + a[3] / 2, b[1] + b[3] / 2)
             - max(a[1] - a[3] / 2, b[1] - b[3] / 2))
    da = a[2] * a[3]
    return iw * ih / da if da > 0 else 0.0


def _match_image(dets: Sequence[Detection], gts: Sequence[GroundTruth],
                 iou_thr: float, sim: str
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy matching (COCO protocol): detections by descending score, each
    takes the highest-similarity unmatched same-class GT. sim: "box" |
    "mask" | "oks" (pose, OKS thresholds in place of IoU) | "rbox" (obb,
    probIoU). GTs with ignore=True (COCO iscrowd) are matched LAST, by
    intersection-over-detection-area, are never consumed, and matching one
    removes the detection from scoring. Returns (tp flags, keep flags —
    both aligned with score-sorted dets — and n_gt over non-ignore GT)."""
    order = np.argsort([-d.score for d in dets], kind="stable")
    real = [g for g in gts if not g.ignore]
    crowds = [g for g in gts if g.ignore]
    matched = [False] * len(real)
    tp = np.zeros(len(dets), bool)
    keep = np.ones(len(dets), bool)
    for oi, di in enumerate(order):
        d = dets[di]
        best, best_iou = -1, iou_thr
        for gi, g in enumerate(real):
            if matched[gi] or g.label != d.label:
                continue
            iou = _similarity(d, g, sim)
            if iou >= best_iou:
                best, best_iou = gi, iou
        if best >= 0:
            matched[best] = True
            tp[oi] = True
            continue
        for g in crowds:
            if g.label == d.label and \
                    _crowd_similarity(d, g, sim) >= iou_thr:
                keep[oi] = False      # ignored: neither TP nor FP
                break
    return tp, keep, len(real)


def average_precision(scores: np.ndarray, tps: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from pooled (score, tp) pairs."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tps = tps[order]
    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(~tps)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope, sampled at 101 recall points
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r].max() if (recall >= r).any() else 0.0
        ap += p / 101
    return float(ap)


def evaluate(per_image: Sequence[Tuple[Sequence[Detection], Sequence[GroundTruth]]],
             iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
             use_mask: bool = False,
             similarity: Optional[str] = None) -> Dict[str, float]:
    """COCO-style mAP over a dataset.

    per_image: list of (detections, ground_truths).
    similarity: "box" (default) | "mask" | "oks" (pose keypoint AP — the
    thresholds become OKS thresholds) | "rbox" (obb probIoU AP).
    use_mask=True is kept as an alias for similarity="mask".
    Returns {"mAP": mean over IoU thresholds and classes, "AP50", "AP75"}.
    """
    sim = similarity or ("mask" if use_mask else "box")
    classes = sorted({g.label for _, gts in per_image for g in gts
                      if not g.ignore})
    ap_per_thr: Dict[float, List[float]] = {t: [] for t in iou_thresholds}
    for cls in classes:
        for thr in iou_thresholds:
            scores, tps, n_gt = [], [], 0
            for dets, gts in per_image:
                cd = [d for d in dets if d.label == cls]
                cg = [g for g in gts if g.label == cls]
                tp, kept, ng = _match_image(cd, cg, thr, sim)
                order = np.argsort([-d.score for d in cd], kind="stable")
                scores += [cd[i].score for oi, i in enumerate(order)
                           if kept[oi]]
                tps += [t for t, k in zip(tp, kept) if k]
                n_gt += ng
            if n_gt:
                ap_per_thr[thr].append(average_precision(
                    np.asarray(scores), np.asarray(tps, bool), n_gt))
    mean_ap = {t: (float(np.mean(v)) if v else float("nan"))
               for t, v in ap_per_thr.items()}
    vals = [v for v in mean_ap.values() if not np.isnan(v)]
    out = {"mAP": float(np.mean(vals)) if vals else float("nan")}
    t50 = min(iou_thresholds, key=lambda t: abs(t - 0.5))
    t75 = min(iou_thresholds, key=lambda t: abs(t - 0.75))
    out["AP50"] = mean_ap[t50]
    out["AP75"] = mean_ap[t75]
    return out


def detections_from_slate(det: dict, image_index: int = 0,
                          mask_threshold: float = 0.5,
                          frame_hw: Optional[Tuple[int, int]] = None,
                          input_size: Tuple[int, int] = (640, 640),
                          resize_mode: str = "stretch") -> List[Detection]:
    """Convert one image's padded pipeline output into Detection objects
    (boxes mapped back to frame space when frame_hw given). `det` holds
    numpy arrays or tensors; eval copies a batch's dict to the host once
    and passes numpy."""
    n = int(_host(det["count"])[image_index])
    boxes = _host(det["boxes_xywh"])[image_index][:n]
    if frame_hw is not None:
        boxes = boxes_to_frame_space(boxes, frame_hw, input_size, resize_mode)
    labels = _host(det["labels"])[image_index][:n]
    scores = _host(det["scores"])[image_index][:n]
    masks = det.get("masks")
    if masks is not None:
        masks = _host(masks)[image_index]
    out = []
    for i in range(n):
        m = None
        if masks is not None:
            m = np.asarray(masks[i]) > mask_threshold
        out.append(Detection(boxes[i], int(labels[i]), float(scores[i]), m))
    return out
