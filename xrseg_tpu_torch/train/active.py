"""Active-learning frame selection (counterpart of
xrseg_tpu/train/active.py): send the frames the deployed model is unsure
about to a human, pseudo-label the rest (train/pseudo.py).

- "margin": per-detection uncertainty u = 1 - |2p - 1|, summed over an
  image's gate-passing detections;
- "flip": horizontal-flip disagreement: the pipeline on the frame and on
  its mirror (`img[:, ::-1]`, a negative-stride view that device.
  to_device makes contiguous); detections without a same-class flipped
  match (IoU-gated) are unstable under a symmetry the task guarantees.
  Twice the compute of "margin".

Both run through the deployed pipeline at a LOW score gate; on the card
each call's NMS is K1 at B=1 (twice a frame under "flip"). The scorers
are the port's own numpy copies of the JAX package's. obb and classify
raise, as in train/pseudo.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from xrseg_tpu_torch.config import ExecutorConfig
from xrseg_tpu_torch.train.pseudo import check_box_task


def margin_uncertainty(scores: np.ndarray) -> float:
    """Sum of per-detection uncertainty 1 - |2p - 1| over an image's
    (gate-passing) detections."""
    s = np.asarray(scores, np.float32)
    return float(np.sum(1.0 - np.abs(2.0 * s - 1.0)))


def flip_disagreement(det: Dict[str, np.ndarray],
                      det_flip: Dict[str, np.ndarray],
                      width: float, iou_gate: float = 0.5) -> float:
    """Fraction of detections (both directions) without a same-class
    flipped counterpart, weighted by score: 0 when the two views agree
    perfectly, 1 when nothing matches."""
    def boxes_of(d, flip):
        n = int(d["count"])
        b = np.asarray(d["boxes_xywh"][:n], np.float32).copy()
        if flip:
            b[:, 0] = width - b[:, 0]
        return b, np.asarray(d["labels"][:n]), \
            np.asarray(d["scores"][:n], np.float32)

    ba, la, sa = boxes_of(det, False)
    bb, lb, sb = boxes_of(det_flip, True)
    if len(ba) == 0 and len(bb) == 0:
        return 0.0

    def iou(a, b):
        ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
        ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
        bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
        bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
        iw = np.maximum(0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
        ih = np.maximum(0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
        inter = iw * ih
        return inter / (a[2] * a[3] + b[:, 2] * b[:, 3] - inter + 1e-9)

    def unmatched_mass(b1, l1, s1, b2, l2):
        miss = 0.0
        for i in range(len(b1)):
            ok = (len(b2) > 0
                  and bool(((iou(b1[i], b2) >= iou_gate)
                            & (l2 == l1[i])).any()))
            if not ok:
                miss += float(s1[i])
        return miss

    miss = (unmatched_mass(ba, la, sa, bb, lb)
            + unmatched_mass(bb, lb, sb, ba, la))
    total = float(sa.sum() + sb.sum())
    return miss / total if total > 0 else 0.0


def rank_frames(cfg: ExecutorConfig, model, images: Iterable[np.ndarray],
                strategy: str = "margin", score_gate: float = 0.05,
                device="cuda") -> List[Tuple[int, float]]:
    """Rank frames most-uncertain-first through the deployed pipeline on
    `device`. `model` is a YOLO11 for cfg.model; returns
    [(image_index, uncertainty), ...] sorted descending. One pipeline is
    built per distinct frame geometry."""
    from xrseg_tpu_torch.compile import build_pipeline, unpack_slate

    if strategy not in ("margin", "flip"):
        raise ValueError(f"unknown strategy {strategy!r}")
    check_box_task(cfg.model.task, "rank_frames")
    post = dataclasses.replace(cfg.post, score_threshold=score_gate)
    cfg = dataclasses.replace(cfg, post=post)
    max_det = cfg.post.max_detections

    pipes: Dict[Tuple[int, int], Any] = {}
    out: List[Tuple[int, float]] = []
    for i, img in enumerate(images):
        img = np.asarray(img, np.uint8)
        hw = img.shape[:2]
        if hw not in pipes:
            pipes[hw] = build_pipeline(cfg, model, frame_hw=hw, batch=1,
                                       device=device)
        pipe = pipes[hw]
        det = unpack_slate(pipe(img[None])["slate"][0], max_det)
        n = int(det["count"])
        if strategy == "margin":
            u = margin_uncertainty(det["scores"][:n])
        else:
            det_f = unpack_slate(pipe(img[:, ::-1][None])["slate"][0],
                                 max_det)
            u = flip_disagreement(det, det_f, cfg.model.input_size[1])
        out.append((i, u))
    out.sort(key=lambda t: -t[1])
    return out
