"""End-to-end accuracy parity measurement: the deployed pipeline vs an
independent CPU oracle (counterpart of xrseg_tpu/eval/parity.py).

With no COCO ground truth at hand, parity is measured as agreement between
two full pipelines running the same weights on the same images:

  ours:   uint8 frame -> compile.build_pipeline on `device` (the deployed
          path: preprocess, forward in the model's dtype, NMS through K1
          on a card, mask synthesis)
  oracle: torch bilinear resize -> the same network as a float32 copy on
          the CPU with TF32 forbidden (matmul_precision "highest") -> the
          numpy greedy NMS (ops/nms.nms_reference_numpy) -> numpy
          sigmoid(coefs . protos)

The oracle shares the network's module code with ours (the JAX package's
oracle is a separate torch re-implementation in its tests, which reach
into the JAX package, so the port cannot import it; the tests hold this
oracle against that one). It shares no kernel, no device, no reduced
precision and no postprocess code with the deployed path.

The oracle's detections serve as ground truth and ours are evaluated
against them with the COCO-style AP harness (eval/metrics.py), boxes and
masks separately.

Mask protocol: both sides emit sigmoid prototype-space masks; each is
cropped to its own box (display-layer semantics, IEMasker.cs:232-247) and
thresholded at 0.5 before mask-IoU matching.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.eval.metrics import Detection, GroundTruth, evaluate
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops.nms import nms_reference_numpy


def crop_binary_mask(mask: np.ndarray, box_xywh: np.ndarray,
                     input_size=(640, 640), threshold: float = 0.5
                     ) -> np.ndarray:
    """Threshold a sigmoid mask and zero everything outside the box
    (mask-space crop, IEMasker.cs:232-247 semantics)."""
    H, W = mask.shape
    ih, iw = input_size
    sx, sy = W / float(iw), H / float(ih)
    cx, cy, bw, bh = [float(v) for v in box_xywh]
    x1, x2 = (cx - bw / 2) * sx, (cx + bw / 2) * sx
    y1, y2 = (cy - bh / 2) * sy, (cy + bh / 2) * sy
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    inside = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    return (np.asarray(mask, np.float32) > threshold) & inside


def our_slates(images: Sequence[np.ndarray], params: yolo11.YOLO11,
               mcfg: ModelConfig, pcfg: PostprocessConfig, device="cuda"
               ) -> List[Dict[str, np.ndarray]]:
    """The deployed pipeline (build_pipeline, batch 1) on `device`, one
    image at a time; each detection dict copied to the host."""
    pipe = build_pipeline(ExecutorConfig(model=mcfg, post=pcfg), params,
                          batch=1, device=device)
    return [{k: v.detach().cpu().numpy()
             for k, v in pipe(img[None]).items()} for img in images]


def oracle_model(params: yolo11.YOLO11) -> yolo11.YOLO11:
    """A float32 copy of `params` on the CPU that forbids TF32 (the
    oracle's network; the caller's module is untouched)."""
    cfg = dataclasses.replace(params.cfg, dtype="float32",
                              param_dtype="float32",
                              matmul_precision="highest")
    return yolo11.yolo11_for_state(cfg, {
        k: v.detach().float().cpu()
        for k, v in params.state_dict().items()}).eval()


def oracle_preprocess(img_uint8: np.ndarray, out_hw=(640, 640)
                      ) -> torch.Tensor:
    """uint8 [H,W,3] -> float32 [1,oh,ow,3] in [0,1]; 2-tap bilinear
    stretch (TextureConverter.ToTensor semantics) via torch interpolate."""
    x = torch.as_tensor(np.ascontiguousarray(img_uint8)[None],
                        dtype=torch.float32).permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).contiguous()


def oracle_outputs(model: yolo11.YOLO11, img: np.ndarray
                   ) -> Dict[str, np.ndarray]:
    """The oracle network's raw outputs for one image, as numpy [1, ...]."""
    with torch.inference_mode():
        out = model(oracle_preprocess(img, model.cfg.input_size),
                    concat_preds=False)
    return {k: v.numpy() for k, v in out.items()}


def oracle_detections(out: Dict[str, np.ndarray], iou_threshold: float,
                      score_threshold: float, max_det: int = 50) -> list:
    """Oracle outputs -> final detections, via numpy threshold +
    class-aware greedy NMS + per-instance mask synthesis (sigmoid at proto
    resolution, uncropped — cropping is display-layer semantics,
    IEMasker.cs:232-247). Returns a list of dicts {box_xywh, label, score,
    mask|None}."""
    boxes = np.asarray(out["boxes_xywh"][0], np.float32)
    scores_all = np.asarray(out["scores"][0], np.float32)
    scores = scores_all.max(-1)
    labels = scores_all.argmax(-1)
    keep = nms_reference_numpy(boxes, scores, labels, iou_threshold,
                               score_threshold, max_keep=max_det)
    protos = out.get("protos")
    coefs = out.get("mask_coefs")
    dets = []
    for i in keep:
        m = None
        if protos is not None:
            logit = np.einsum("c,hwc->hw", np.asarray(coefs[0][i], np.float32),
                              np.asarray(protos[0], np.float32))
            m = 1.0 / (1.0 + np.exp(-logit))
        dets.append({"box_xywh": boxes[i], "label": int(labels[i]),
                     "score": float(scores[i]), "mask": m})
    return dets


def _our_detections(images: Sequence[np.ndarray], params,
                    mcfg: ModelConfig, pcfg: PostprocessConfig,
                    device="cuda") -> List[List[Detection]]:
    """The deployed pipeline per image -> Detection lists (boxes in model
    space; masks cropped+thresholded)."""
    per_image = []
    for det in our_slates(images, params, mcfg, pcfg, device):
        n = int(det["count"][0])
        dets = []
        for i in range(n):
            box = np.asarray(det["boxes_xywh"][0][i], np.float32)
            m = None
            if "masks" in det:
                m = crop_binary_mask(np.asarray(det["masks"][0][i],
                                                np.float32),
                                     box, mcfg.input_size)
            dets.append(Detection(box, int(det["labels"][0][i]),
                                  float(det["scores"][0][i]), m))
        per_image.append(dets)
    return per_image


def _oracle_detections(images: Sequence[np.ndarray], params,
                       mcfg: ModelConfig, pcfg: PostprocessConfig
                       ) -> List[List[GroundTruth]]:
    model = oracle_model(params)
    per_image = []
    for img in images:
        dets = oracle_detections(oracle_outputs(model, img),
                                 pcfg.iou_threshold, pcfg.score_threshold,
                                 pcfg.max_detections)
        gts = []
        for d in dets:
            m = crop_binary_mask(d["mask"], d["box_xywh"], mcfg.input_size) \
                if d["mask"] is not None else None
            gts.append(GroundTruth(d["box_xywh"], d["label"], m))
        per_image.append(gts)
    return per_image


def parity_report(images: Sequence[np.ndarray], params, mcfg: ModelConfig,
                  pcfg: PostprocessConfig, device="cuda"
                  ) -> Dict[str, float]:
    """AP agreement of the deployed pipeline on `device` vs the CPU
    oracle.

    Returns box_mAP/box_AP50/box_AP75 and mask_mAP/mask_AP50/mask_AP75,
    plus detection-count stats.
    """
    ours = _our_detections(images, params, mcfg, pcfg, device)
    oracle = _oracle_detections(images, params, mcfg, pcfg)
    pairs = list(zip(ours, oracle))
    box = evaluate(pairs, use_mask=False)
    mask = evaluate(pairs, use_mask=True)
    n_ours = sum(len(d) for d in ours)
    n_oracle = sum(len(g) for g in oracle)
    return {
        "box_mAP": box["mAP"], "box_AP50": box["AP50"],
        "box_AP75": box["AP75"],
        "mask_mAP": mask["mAP"], "mask_AP50": mask["AP50"],
        "mask_AP75": mask["AP75"],
        "n_detections_ours": n_ours, "n_detections_oracle": n_oracle,
        "n_images": len(images),
    }


def augment_images(images: Sequence[np.ndarray], n_variants: int = 4,
                   seed: int = 0) -> List[np.ndarray]:
    """Expand an image set with deterministic photometric/geometric
    variants (flip, brightness, crop) to densify the parity measurement."""
    rng = np.random.default_rng(seed)
    out = [np.asarray(im, np.uint8) for im in images]
    for im in images:
        H, W = im.shape[:2]
        variants = [
            im[:, ::-1],                                        # h-flip
            np.clip(im.astype(np.int16) + 30, 0, 255),          # brighter
            np.clip(im.astype(np.float32) * 0.7, 0, 255),       # darker
            im[H // 8: H - H // 8, W // 8: W - W // 8],         # center crop
        ]
        for v in variants[:n_variants]:
            out.append(np.ascontiguousarray(v).astype(np.uint8))
        rng.shuffle(out)
    return out
