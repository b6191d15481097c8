"""Plain float32 post-processing of the reference: decode, greedy NMS,
mask synthesis, the tracker's re-lock, depth latency compensation and
the RGBD point fusion.

Each follows the published semantics the program implements (Ultralytics'
class-aware greedy NMS into a max_det slate; the reference XR app's
IEExecutor re-lock, DepthExtractionJob and PrepareDepthData), written
again here from those descriptions. It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

CLASS_OFFSET = 8192.0        # shifts each class into its own coordinate range


def best_class(cls_logits: torch.Tensor):
    """[..., A, nc] logits -> (score [..., A] as a probability, label)."""
    logit, label = cls_logits.max(-1)
    return torch.sigmoid(logit), label


def greedy_nms(boxes_xywh: torch.Tensor, scores: torch.Tensor,
               labels: torch.Tensor, iou_threshold: float,
               score_threshold: float, max_det: int):
    """Class-aware greedy NMS of each row of a batch.

    boxes [B,A,4] cxcywh, scores [B,A] probabilities, labels [B,A].
    Returns (indices [B,D] long, valid [B,D] bool) in selection order: at
    each step the best live candidate (the first of equal scores) is kept
    and every live candidate of its class overlapping it by more than
    iou_threshold is dropped."""
    off = labels.to(torch.float32)[..., None] * CLASS_OFFSET
    c = torch.cat([boxes_xywh[..., :2] - boxes_xywh[..., 2:] * 0.5,
                   boxes_xywh[..., :2] + boxes_xywh[..., 2:] * 0.5], -1)
    x1, y1 = c[..., 0] + off[..., 0], c[..., 1] + off[..., 0]
    x2, y2 = c[..., 2] + off[..., 0], c[..., 3] + off[..., 0]
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    live = torch.where(scores > score_threshold, scores,
                       torch.full_like(scores, -math.inf))
    ar = torch.arange(scores.shape[-1], device=scores.device)
    idxs, oks = [], []
    for _ in range(max_det):
        i = live.argmax(-1, keepdim=True)
        ok = live.gather(-1, i) > -math.inf

        def g(v):
            return v.gather(-1, i)

        iw = (torch.minimum(x2, g(x2)) - torch.maximum(x1, g(x1))).clamp_min(0)
        ih = (torch.minimum(y2, g(y2)) - torch.maximum(y1, g(y1))).clamp_min(0)
        inter = iw * ih
        union = area + g(area) - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        drop = (iou > iou_threshold) | (ar == i)
        live = torch.where(ok & drop, torch.full_like(live, -math.inf), live)
        idxs.append(i[..., 0])
        oks.append(ok[..., 0])
    return torch.stack(idxs, -1), torch.stack(oks, -1)


def detect(raw: Dict[str, torch.Tensor], iou_threshold: float,
           score_threshold: float, max_det: int) -> Dict[str, torch.Tensor]:
    """Raw heads of a batch -> every anchor's (box, score, label, coefs)
    and the NMS slate: indices, valid, count and cutoff (the score of the
    last kept detection; the gate when fewer than max_det clear it)."""
    scores, labels = best_class(raw["cls_logits"])
    idx, valid = greedy_nms(raw["boxes_xywh"], scores, labels,
                            iou_threshold, score_threshold, max_det)
    kept = torch.where(valid, scores.gather(-1, idx),
                       torch.full_like(scores[:, :1].expand_as(idx), math.inf))
    count = valid.sum(-1)
    cutoff = torch.where(count >= max_det, kept.min(-1).values,
                         torch.full_like(kept[:, 0], score_threshold))
    return {"boxes_xywh": raw["boxes_xywh"], "scores": scores,
            "labels": labels, "coefs": raw["mask_coefs"],
            "protos": raw["protos"], "indices": idx, "valid": valid,
            "count": count, "cutoff": cutoff}


def masks(coefs: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """coefs [..., D, nm] x protos [..., h, w, nm] -> sigmoid [..., D, h, w]."""
    h, w, nm = protos.shape[-3:]
    logits = coefs @ protos.reshape(*protos.shape[:-3], h * w, nm) \
        .transpose(-1, -2)
    return torch.sigmoid(logits).reshape(*logits.shape[:-1], h, w)


# ---------------------------------------------------------------------------
# the XR tick's host-side pieces, in numpy float32
# ---------------------------------------------------------------------------

def relock_nearest(boxes: np.ndarray, labels: np.ndarray, valid: np.ndarray,
                   prev: Tuple[float, float, float, float],
                   screen_scale: Tuple[float, float], gate_px: float):
    """The re-lock: among valid detections of the previous target's class,
    the one whose centre is nearest to the previous target's, measured in
    screen pixels, if strictly inside the gate. Returns (matched, index,
    squared distance of every candidate, inf where not one)."""
    dx = (boxes[:, 0].astype(np.float32) - np.float32(prev[0])) \
        * np.float32(screen_scale[0])
    dy = (boxes[:, 1].astype(np.float32) - np.float32(prev[1])) \
        * np.float32(screen_scale[1])
    d2 = dx * dx + dy * dy
    cand = valid & (labels == int(prev[2])) & (prev[3] > 0.5)
    d2 = np.where(cand, d2, np.float32(np.inf))
    i = int(np.argmin(d2))
    return bool(d2[i] < np.float32(gate_px) ** 2), i, d2


def box_to_model_space(box_screen: Tuple[float, float, float, float],
                       screen_wh, model_hw):
    """A centre-origin, y-up screen box (cx, cy, w, h) -> model-space
    cxcywh (the app's ParseBoxes mapping, inverted)."""
    sw, sh = screen_wh
    mh, mw = model_hw
    sx, sy = sw / mw, sh / mh
    cx, cy, w, h = box_screen
    return (cx / sx + mw / 2.0, mh / 2.0 - cy / sy, w / sx, h / sy)


def quat_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    a = np.asarray(a, np.float32) / np.linalg.norm(a)
    b = np.asarray(b, np.float32) / np.linalg.norm(b)
    dot = float(np.dot(a, b))
    if dot < 0.0:
        b, dot = -b, -dot
    if dot > 0.9995:
        q = a + t * (b - a)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1, 1))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b


def compensate_pose(cur_pos, cur_rot, prev_pos, prev_rot, dt: float,
                    latency: float):
    """The depth frame's pose: the current pose moved back toward the
    previous one by latency/dt (clamped to [0, 1]); the current pose
    itself when there is no previous one."""
    if prev_pos is None:
        return (np.asarray(cur_pos, np.float32),
                np.asarray(cur_rot, np.float32))
    t = float(np.clip(latency / max(dt, 1e-6), 0.0, 1.0))
    cur_pos = np.asarray(cur_pos, np.float32)
    pos = cur_pos + (np.asarray(prev_pos, np.float32) - cur_pos) * t
    rot = quat_slerp(cur_rot, prev_rot, t)
    return pos.astype(np.float32), np.asarray(rot, np.float32)


def fuse_points(depth_u16: np.ndarray, mask: np.ndarray, box_xywh,
                focal, principal, sensor, cam_pos, cam_quat, *,
                confidence: float, min_depth: float, max_depth: float,
                step: int, model_size: float = 640.0) -> np.ndarray:
    """Mask -> world points over the step-strided mask grid ([N, 5]: xyz,
    depth, valid; zero where not valid): grid point -> box-relative model
    coordinates -> depth texel (bottom-up rows) -> fp16 depth in range ->
    pinhole ray -> world by the depth pose. The app's job normalises
    model coordinates by its 640-pixel model size."""
    mh, mw = mask.shape
    dh, dw = depth_u16.shape
    ys = np.arange(mh // step) * step
    xs = np.arange(mw // step) * step
    yy = np.repeat(ys, len(xs))
    xx = np.tile(xs, len(ys))
    alive = mask[yy, xx] > confidence
    cx, cy, bw, bh = (np.float32(v) for v in box_xywh)
    img_x = cx - bw * np.float32(0.5) + (xx.astype(np.float32) / mw) * bw
    img_y = cy - bh * np.float32(0.5) + (yy.astype(np.float32) / mh) * bh
    u = np.clip(img_x / np.float32(model_size), 0, 1).astype(np.float32)
    v = np.clip(img_y / np.float32(model_size), 0, 1).astype(np.float32)
    dx = (u * (dw - 1)).astype(np.int64)
    dy = ((1 - v) * (dh - 1)).astype(np.int64)
    depth = depth_u16.reshape(-1)[dy * dw + dx].view(np.float16) \
        .astype(np.float32)
    alive &= (depth > min_depth) & (depth < max_depth)
    px = u * np.float32(sensor[0])
    py = (1 - v) * np.float32(sensor[1])
    d = np.stack([(px - np.float32(principal[0])) / np.float32(focal[0]),
                  (py - np.float32(principal[1])) / np.float32(focal[1]),
                  np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    q = np.asarray(cam_quat, np.float32)
    t = 2.0 * np.cross(q[:3], d)
    world = d + q[3] * t + np.cross(q[:3], t)
    pos = np.asarray(cam_pos, np.float32) + world * depth[:, None]
    pos = np.where(alive[:, None], pos, 0)
    return np.concatenate([pos, np.where(alive, depth, 0)[:, None],
                           alive[:, None].astype(np.float32)], -1) \
        .astype(np.float32)
