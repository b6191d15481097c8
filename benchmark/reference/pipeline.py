"""The reference's frame pipeline: uint8 frames -> every anchor's box,
score, label and mask coefficients, the prototypes and the NMS slate.

Preprocess is the stretch resize with half-pixel centres and two taps
per axis (no antialiasing), after scaling to [0, 1], all in float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import post, yolo


def _taps(src: int, dst: int, device):
    s = (torch.arange(dst, dtype=torch.float64, device=device) + 0.5) \
        * (src / dst) - 0.5
    s0 = torch.floor(s)
    frac = (s - s0).float()
    i0 = s0.long().clamp(0, src - 1)
    i1 = (s0.long() + 1).clamp(0, src - 1)
    return i0, i1, frac


def preprocess(frames: torch.Tensor, out_hw) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 [B,oh,ow,3] in [0, 1]."""
    x = frames.float() / 255.0
    for axis, dst in ((1, out_hw[0]), (2, out_hw[1])):
        src = x.shape[axis]
        if src == dst:
            continue
        i0, i1, f = _taps(src, dst, x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = dst
        f = f.reshape(shape)
        x = x.index_select(axis, i0) * (1 - f) + x.index_select(axis, i1) * f
    return x


def run(sd: Dict[str, torch.Tensor], cfg: dict, frames, device,
        quant: Optional[str] = None, chunk: int = 8) -> List[Dict]:
    """Per image: numpy boxes [A,4], scores [A], labels [A], indices [D],
    valid [D], count, cutoff, nms (its thresholds and max_det), strides
    [A] (each anchor's); device tensors coefs [A,nm], protos
    [h,w,nm]."""
    out = []
    frames = torch.as_tensor(np.asarray(frames))
    strides = yolo.anchors(cfg["input_size"])[1][:, 0].double().numpy()
    with torch.no_grad(), yolo.float32_scope():
        for s in range(0, frames.shape[0], chunk):
            x = preprocess(frames[s:s + chunk].to(device),
                           cfg["input_size"])
            raw = yolo.forward(yolo.Ops(sd, quant=quant), cfg, x)
            det = post.detect(raw, cfg["iou_threshold"],
                              cfg["score_threshold"], cfg["max_detections"])
            for i in range(x.shape[0]):
                out.append({
                    "boxes": det["boxes_xywh"][i].double().cpu().numpy(),
                    "scores": det["scores"][i].double().cpu().numpy(),
                    "labels": det["labels"][i].cpu().numpy(),
                    "indices": det["indices"][i].cpu().numpy(),
                    "valid": det["valid"][i].cpu().numpy(),
                    "count": int(det["count"][i]),
                    "cutoff": float(det["cutoff"][i]),
                    "nms": (cfg["iou_threshold"], cfg["score_threshold"],
                            cfg["max_detections"]),
                    "strides": strides,
                    "coefs": det["coefs"][i],
                    "protos": det["protos"][i],
                })
    return out


def masks_of(ref: Dict, anchors: np.ndarray) -> np.ndarray:
    """The reference's sigmoid masks [n, h, w] of the given anchors."""
    if len(anchors) == 0:
        h, w = ref["protos"].shape[:2]
        return np.zeros((0, h, w), np.float32)
    idx = torch.as_tensor(np.asarray(anchors), device=ref["coefs"].device)
    with yolo.float32_scope():
        m = post.masks(ref["coefs"].index_select(0, idx), ref["protos"])
    return m.cpu().numpy()


def slate_of(ref: Dict) -> Dict[str, np.ndarray]:
    """The reference's own slate, in the program's layout (valid rows
    first, in selection order)."""
    keep = ref["indices"][ref["valid"]]
    return {"boxes": ref["boxes"][keep].astype(np.float32),
            "scores": ref["scores"][keep].astype(np.float32),
            "labels": ref["labels"][keep], "anchors": keep}
