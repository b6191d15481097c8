"""The comparison that decides `correct`: what the timed path produced,
held against the plain float32 reference on the same inputs.

Each compared number is a worst case over the sampled answers:

- slate_miss: 1 where an answer has a detection that is no reference
  anchor's: of another class than its anchor's, or with a box farther
  than BOX_TOL strides of that anchor from it (exact). A detection is tied to the reference anchor
  whose box is nearest (largest coordinate gap, in model pixels);
  BOX_TOL is half an anchor spacing.
- box_err: the mean, over an answer's detections, of the largest
  coordinate gap between its box and its anchor's reference box, in
  strides of the anchor (bins of the DFL decode); the largest such mean
  over the answers. It holds the box branch and the decode. A mean, for
  the reason score_err is one: box_err_max (a diagnostic) is one box
  where two bins of the decode compete and rounding moves it most.
- nms_miss: how often an answer's slate is not what greedy NMS keeps
  from the reference's scores and boxes, allowing for near-ties (exact).
  Greedy NMS keeps no two boxes of a class that overlap by more than
  the IoU threshold, and leaves an anchor out only where a kept box of
  its class that scored at least as high overlaps it by more than the
  threshold, or where it scored at most the slate's last. With scores
  that may differ from the reference's by SCORE_TIE / 2 on each side,
  and IoUs by IOU_TIE, a miss is a kept pair that overlaps by more than
  the threshold + IOU_TIE, or an anchor left out that scored more than
  SCORE_TIE above the answer's lowest and that no kept box scoring at
  least SCORE_TIE less overlaps by more than the threshold - IOU_TIE.
  So a slate chosen without suppression, or with another threshold, or
  cut short, misses, and one that breaks a near-tie the other way does
  not, even where that changes how many boxes a slate that is not full
  keeps.
- rank_gap: how far (in score) below the reference's own cutoff (the
  score of its last kept detection) the reference scores an anchor the
  answer kept.
- score_err: the mean, over an answer's detections, of the gap between
  its score and the reference's score of its anchor; the largest such
  mean over the answers. A mean: the largest single gap (score_err_max,
  a diagnostic) is one anchor where the random network amplifies
  rounding the most.
- mask_err: the mean gap between the pixels of an answer's masks and
  those of the reference's masks of the same anchors (sigmoid
  probabilities); the largest such mean over the answers. A mean and
  not a single pixel or mask: masks are sharp, a boundary pixel flips
  under any rounding, and the random network amplifies rounding far more
  in a few masks than in the rest.
- points_err: the share of the point grid where the answer's point cloud
  and the reference's disagree: valid on one side only, or valid on
  both and more than POINT_TOL metres apart.
- relock_miss: 1 where a tick's re-lock is not the nearest valid
  same-class detection of the answer's own slate (exact).

Where slate_miss is 1, rank_gap, score_err, box_err and nms_miss read
UNMATCHED.

Beside each worst case, box_err_mean, mask_err_mean and points_err_mean
are the means of the same numbers over the sampled answers (add_means):
a worst case of a few dozen answers swings with the one answer where the
random network amplifies rounding the most, and a mean holds still.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

UNMATCHED = 1e30
BOX_TOL = 0.5            # strides of the anchor
POINT_TOL = 0.01         # metres
SCORE_TIE = 0.02         # twice the largest score error of a sound answer
IOU_TIE = 0.05


def identify(boxes: np.ndarray, labels: np.ndarray, ref: Dict):
    """(reference anchor of each answer detection, -1 where none fits;
    the distance to the nearest reference box in strides of its anchor;
    whether the labels agree)."""
    rb = ref["boxes"]
    if len(boxes) == 0:
        return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, bool))
    d = np.abs(boxes[:, None, :].astype(np.float64)
               - rb[None, :, :]).max(-1)
    a = d.argmin(1)
    dist = d[np.arange(len(a)), a]
    same = ref["labels"][a] == labels.astype(np.int64)
    dist = dist / ref["strides"][a]
    return np.where((dist <= BOX_TOL) & same, a, -1), dist, same


def slate_numbers(ref: Dict, boxes: np.ndarray, scores: np.ndarray,
                  labels: np.ndarray) -> Dict[str, float]:
    """ref: one image's reference (boxes [A,4], scores [A], labels [A],
    count, cutoff, nms = (IoU threshold, score threshold, max_det));
    boxes/scores/labels: the answer's valid detections, model-space
    cxcywh. Besides the compared numbers, diagnostics: score_err_max (the
    largest single gap), box_err_max, kept_iou_max (the largest IoU of two kept boxes
    of a class), left_out_gap (how far above the answer's lowest score
    the best uncovered anchor left out scores), label_miss, count_diff."""
    anchor, dist, same = identify(boxes, labels, ref)
    diag = {"label_miss": float((~same).sum()),
            "count_diff": float(abs(len(boxes) - int(ref["count"])))}
    if (anchor < 0).any():
        return {"rank_gap": UNMATCHED, "score_err": UNMATCHED,
                "box_err": UNMATCHED, "nms_miss": UNMATCHED,
                "slate_miss": 1.0, "anchor": anchor,
                "box_dist": float(np.max(dist, initial=0.0)), **diag}
    s_ref = ref["scores"][anchor]
    gap = float(np.max(ref["cutoff"] - s_ref, initial=0.0))
    err = np.abs(scores.astype(np.float64) - s_ref)
    return {"rank_gap": max(gap, 0.0), "slate_miss": 0.0,
            "box_err": float(np.mean(dist)) if len(dist) else 0.0,
            "box_err_max": float(np.max(dist, initial=0.0)),
            "score_err": float(np.mean(err)) if len(err) else 0.0,
            "score_err_max": float(np.max(err, initial=0.0)),
            **nms_numbers(ref, anchor), "anchor": anchor, **diag}


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cxcywh [n,4] x [m,4] -> IoU [n,m], in float64."""
    def corners(x):
        return (x[:, 0] - x[:, 2] / 2, x[:, 1] - x[:, 3] / 2,
                x[:, 0] + x[:, 2] / 2, x[:, 1] + x[:, 3] / 2)
    ax1, ay1, ax2, ay2 = (v[:, None] for v in corners(a))
    bx1, by1, bx2, by2 = (v[None, :] for v in corners(b))
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1)) + ((bx2 - bx1) * (by2 - by1)) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def nms_numbers(ref: Dict, anchor: np.ndarray) -> Dict[str, float]:
    """nms_miss of one answer whose detections are the reference anchors
    `anchor` (see the module's docstring), with its diagnostics."""
    iou_thr, score_thr, max_det = ref["nms"]
    boxes, scores, labels = ref["boxes"], ref["scores"], ref["labels"]
    if len(anchor) == 0:
        low = score_thr
    else:
        low = float(scores[anchor].min()) if len(anchor) >= max_det \
            else score_thr
    kept = np.zeros(len(scores), bool)
    kept[anchor] = True
    ov = _iou(boxes[anchor], boxes)                         # [D, A]
    ov = np.where(labels[anchor][:, None] == labels[None, :], ov, 0.0)
    pair = ov[:, anchor]
    np.fill_diagonal(pair, 0.0)
    pair_iou = float(pair.max(initial=0.0))
    pairs = int((np.triu(pair, 1) > iou_thr + IOU_TIE).sum())
    cover = (ov > iou_thr - IOU_TIE) & \
        (scores[anchor][:, None] >= scores[None, :] - SCORE_TIE)
    open_ = ~kept & (scores > score_thr) & ~cover.any(0)
    gap = float(np.max(scores[open_] - low, initial=-1.0))
    left = int((scores[open_] > low + SCORE_TIE).sum())
    return {"nms_miss": float(pairs + left), "kept_iou_max": pair_iou,
            "left_out_gap": gap}


def mask_err(ref_masks: np.ndarray, masks: np.ndarray) -> float:
    """ref_masks / masks: [n, h, w] sigmoid masks of one answer's
    anchors."""
    if ref_masks.shape != masks.shape:
        return UNMATCHED
    if ref_masks.size == 0:
        return 0.0
    return float(np.abs(ref_masks.astype(np.float64) - masks).mean())


def points_err(ref_packed: np.ndarray, packed: np.ndarray) -> float:
    """[N, 5] xyz | depth | valid, both sides."""
    if ref_packed.shape != packed.shape:
        return UNMATCHED
    rv, pv = ref_packed[:, 4] > 0.5, packed[:, 4] > 0.5
    far = np.abs(ref_packed[:, :3] - packed[:, :3]).max(-1) > POINT_TOL
    bad = (rv != pv) | (rv & pv & far)
    return float(bad.mean())


MEANS = ("box_err", "mask_err", "points_err")


def add_means(acc: Dict[str, float], answers: List[Dict[str, float]]
              ) -> None:
    """acc[k + "_mean"]: the mean of k over the answers that read it, for
    each k in MEANS (an UNMATCHED answer makes the mean UNMATCHED)."""
    for k in MEANS:
        v = [a[k] for a in answers if k in a]
        if v:
            acc[k + "_mean"] = min(float(np.mean(v)), UNMATCHED)


def worst(acc: Dict[str, float], new: Dict[str, Optional[float]]) -> None:
    for k, v in new.items():
        if isinstance(v, (float, int)):
            acc[k] = max(acc.get(k, 0.0), float(v))

