"""Pseudo-labelling (self-training; counterpart of
xrseg_tpu/train/pseudo.py): the deployed pipeline's hard detections,
NMS and all, become ordinary training samples.

- masks transfer: each survivor's instance mask is polygonized into the
  Sample contract, so a student's segmentation head trains from unlabelled
  frames (mask coefficients do not distil; train/distill.py);
- the output is ordinary data: `python -m xrseg_tpu_torch.tools.
  pseudo_label` writes COCO instances JSON that train/data.CocoDataset and
  any COCO consumer read.

On the card each frame's NMS is K1 (ops/nms_kernels.
nms_select_batched_cuda) at B=1. The polygon helpers and the COCO writer
are the port's own numpy copies of the JAX package's.

The detect, segment and pose tasks are ported as the JAX package has
them (a pose slate gives boxes with polys None). obb and classify raise:
the JAX function reads every slate as 4-wide boxes, which misreads an obb
slate, and a classify pipeline has no box slate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.config import ExecutorConfig


def check_box_task(task: str, what: str) -> None:
    """Refuse the tasks whose slate is not 4-wide boxes (obb, classify)."""
    if task in ("obb", "classify"):
        raise ValueError(
            f"{what} reads 4-wide box slates (detect, segment, pose); the "
            f"{task} task is refused (an obb slate is 5-wide, a classify "
            "pipeline has no box slate)")


def mask_to_polygon(mask: np.ndarray, threshold: float = 0.5,
                    step: int = 1) -> Optional[np.ndarray]:
    """Binary/probability mask [h,w] -> normalized polygon [P,2]
    (x, y in [0,1]), or None for an empty mask. Row spans: the left edge
    down, the right edge up. `step` subsamples rows."""
    m = np.asarray(mask) > threshold
    rows = np.flatnonzero(m.any(axis=1))
    if rows.size == 0:
        return None
    if step > 1:
        keep = rows[::step]
        rows = keep if keep[-1] == rows[-1] else np.append(keep, rows[-1])
    h, w = m.shape
    sel = m[rows]
    first = np.argmax(sel, axis=1).astype(np.float32)
    last = (w - np.argmax(sel[:, ::-1], axis=1)).astype(np.float32)
    ys = (rows.astype(np.float32) + 0.5) / h
    left = np.stack([first / w, ys], axis=-1)
    right = np.stack([last / w, ys], axis=-1)
    poly = np.concatenate([left, right[::-1]], axis=0)
    return poly if len(poly) >= 3 else None


def _crop_to_box(mask: np.ndarray, box_norm: np.ndarray) -> np.ndarray:
    """Zero the mask outside the (normalized cxcywh) box: proto leakage
    outside the detection must not become a training target."""
    h, w = mask.shape
    cx, cy, bw, bh = (float(v) for v in box_norm)
    x1 = int(np.clip(np.floor((cx - bw / 2) * w), 0, w))
    x2 = int(np.clip(np.ceil((cx + bw / 2) * w), 0, w))
    y1 = int(np.clip(np.floor((cy - bh / 2) * h), 0, h))
    y2 = int(np.clip(np.ceil((cy + bh / 2) * h), 0, h))
    out = np.zeros_like(mask)
    out[y1:y2, x1:x2] = mask[y1:y2, x1:x2]
    return out


def generate_pseudo_samples(cfg: ExecutorConfig, model,
                            images: Iterable[np.ndarray],
                            score_gate: float = 0.5,
                            max_det: Optional[int] = None,
                            poly_step: int = 1,
                            device="cuda") -> List[Dict[str, Any]]:
    """Run the deployed pipeline (on `device`) over `images` (uint8
    [H,W,3], any mix of geometries) and return train-ready Samples:
    {image, boxes (normalized cxcywh), labels, polys}. Detections below
    `score_gate` are dropped on top of the pipeline's own NMS gate, which
    is lowered to `score_gate` when it is higher.

    `model` is a YOLO11 for cfg.model. One pipeline is built per distinct
    frame geometry (stretch resize, so normalized model coordinates are
    normalized image coordinates)."""
    from xrseg_tpu_torch.compile import build_pipeline, unpack_slate

    check_box_task(cfg.model.task, "generate_pseudo_samples")
    post = cfg.post
    if post.score_threshold > score_gate:
        # the baked gate must not exceed the requested one
        post = dataclasses.replace(post, score_threshold=score_gate)
        cfg = dataclasses.replace(cfg, post=post)
    mdet = max_det if max_det is not None else cfg.post.max_detections
    mh, mw = cfg.model.input_size

    pipes: Dict[Tuple[int, int], Any] = {}
    out: List[Dict[str, Any]] = []
    for img in images:
        img = np.asarray(img, np.uint8)
        hw = img.shape[:2]
        if hw not in pipes:
            pipes[hw] = build_pipeline(cfg, model, frame_hw=hw, batch=1,
                                       device=device)
        res = pipes[hw](img[None])
        det = unpack_slate(res["slate"][0], cfg.post.max_detections)
        # masks may be float16/bfloat16 on the card: read them as float32
        masks = (res["masks"][0].float().cpu().numpy() if "masks" in res
                 else None)
        n = min(int(det["count"]), mdet)
        boxes, labels, polys = [], [], []
        for i in range(n):
            if det["scores"][i] < score_gate:
                continue
            b = det["boxes_xywh"][i] / (mw, mh, mw, mh)   # -> normalized
            b = np.clip(b, 0.0, 1.0)
            if b[2] <= 0 or b[3] <= 0:
                continue
            poly = None
            if masks is not None:
                poly = mask_to_polygon(_crop_to_box(masks[i], b),
                                       step=poly_step)
            boxes.append(b.astype(np.float32))
            labels.append(int(det["labels"][i]))
            polys.append(poly)
        out.append({
            "image": img,
            "boxes": (np.stack(boxes) if boxes
                      else np.zeros((0, 4), np.float32)),
            "labels": np.asarray(labels, np.int32),
            "polys": polys,
        })
    return out


def coco_from_samples(samples: Sequence[Dict[str, Any]],
                      file_names: Sequence[str],
                      class_names: Sequence[str]) -> Dict[str, Any]:
    """Samples -> a standard COCO instances dict (polygon segmentation,
    absolute-pixel boxes; categories id 1..nc, so CocoDataset's sorted-id
    remap recovers the same label indices)."""
    images, annotations = [], []
    aid = 1
    for i, (s, fn) in enumerate(zip(samples, file_names)):
        H, W = s["image"].shape[:2]
        images.append({"id": i + 1, "file_name": fn,
                       "width": W, "height": H})
        for g in range(len(s["labels"])):
            cx, cy, bw, bh = (float(v) for v in s["boxes"][g])
            ann: Dict[str, Any] = {
                "id": aid, "image_id": i + 1,
                "category_id": int(s["labels"][g]) + 1,
                "bbox": [round((cx - bw / 2) * W, 2),
                         round((cy - bh / 2) * H, 2),
                         round(bw * W, 2), round(bh * H, 2)],
                "area": round(bw * W * bh * H, 2),
                "iscrowd": 0,
            }
            poly = s["polys"][g]
            if poly is not None:
                ann["segmentation"] = [
                    [round(float(v), 2) for xy in (poly * (W, H))
                     for v in xy]]
            annotations.append(ann)
            aid += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c + 1, "name": (class_names[c]
                                              if c < len(class_names)
                                              else str(c))}
                       for c in range(len(class_names))],
    }
