"""Raw heads -> padded detection slate + masks (counterpart of
xrseg_tpu/ops/postprocess.py).

Per image: best-class score and label, a score gate (in logit space when
the scores are logits: sigmoid is monotonic, so ranking and NMS run on the
logits and the sigmoid is applied to the survivors only), greedy NMS into
a fixed max_det slate, the survivors' mask coefficients, and optionally
their masks. The NMS backend comes from PostprocessConfig.nms_backend;
"auto" takes the CUDA kernel for CUDA tensors (K1 for the batched path, K2
per image) and the plain loop for CPU tensors. The OBB task
(postprocess_obb_batch) runs rotated NMS with its own backend argument,
as in the JAX package: "auto" takes K3 for CUDA tensors; the pose task
(postprocess_pose_batch) likewise, taking K1 for CUDA tensors. The NMS-free
one-to-one head (postprocess_o2o_batch) selects by score alone.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xrseg_tpu_torch.config import PostprocessConfig
from xrseg_tpu_torch.device import resolve_device, to_device
from xrseg_tpu_torch.ops import masks as mask_ops
from xrseg_tpu_torch.ops import nms as nms_ops


def _check_merge(cfg: PostprocessConfig) -> None:
    if cfg.merge != "nms":
        raise NotImplementedError(
            f"merge {cfg.merge!r} is not ported yet (ROADMAP queue 1, "
            "item 9: accuracy modes, ops/wbf.py)")


def _logit_threshold(cfg: PostprocessConfig, scores_are_logits: bool):
    if not scores_are_logits:
        return cfg.score_threshold
    t = min(max(float(cfg.score_threshold), 1e-7), 1 - 1e-7)
    return float(np.log(t / (1.0 - t)))


def _attach_masks(det, coefs_all, protos, crop, input_size, mask_dtype,
                  with_masks) -> None:
    """Gather the survivors' coefficients [...,D,nm] and add masks (or the
    protos, in coefs-only mode) to `det`."""
    idx = det["indices"].long()[..., None]
    coefs = coefs_all.gather(-2, idx.expand(*idx.shape[:-1],
                                            coefs_all.shape[-1]))
    coefs = coefs * det["valid"][..., None]
    det["coefs"] = coefs
    if with_masks:
        m = mask_ops.synthesize_masks(coefs.to(mask_dtype),
                                      protos.to(mask_dtype))
        if crop:
            m = mask_ops.crop_masks(m, det["boxes_xywh"], input_size)
        det["masks"] = m.to(mask_dtype)
    else:
        det["protos"] = protos.to(mask_dtype)


def postprocess_single_parts(boxes, cls_scores, coefs_all, protos,
                             cfg: PostprocessConfig, crop: bool = False,
                             input_size=(640, 640),
                             mask_dtype=torch.float32,
                             scores_are_logits: bool = False,
                             with_masks: bool = True
                             ) -> Dict[str, torch.Tensor]:
    """One image: boxes [A,4], cls_scores [A,nc], coefs_all [A,nm] or None,
    protos [h,w,nm] or None. Honours cfg.pre_nms_topk."""
    _check_merge(cfg)
    scores, labels = cls_scores.max(-1)
    scores, labels = scores.float(), labels.int()
    det = nms_ops.nms_fixed(
        boxes, scores, labels, iou_threshold=cfg.iou_threshold,
        score_threshold=_logit_threshold(cfg, scores_are_logits),
        pre_topk=cfg.pre_nms_topk, max_det=cfg.max_detections,
        class_aware=cfg.class_aware, backend=cfg.nms_backend)
    if scores_are_logits:
        det["scores"] = torch.sigmoid(det["scores"]) * det["valid"]
    if protos is not None and coefs_all is not None:
        _attach_masks(det, coefs_all, protos, crop, input_size, mask_dtype,
                      with_masks)
    return det


def postprocess_batch_parts(boxes, cls_scores, coefs_all, protos,
                            cfg: PostprocessConfig, crop: bool = False,
                            input_size=(640, 640),
                            mask_dtype=torch.float32,
                            scores_are_logits: bool = False,
                            with_masks: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """Batched hot path: boxes [B,A,4], cls_scores [B,A,nc], coefs_all
    [B,A,nm] or None, protos [B,h,w,nm] or None. The whole batch goes
    through ONE NMS call (K1 on the card); always full width, as in the
    JAX package (no pre_topk)."""
    _check_merge(cfg)
    scores, labels = cls_scores.max(-1)
    scores, labels = scores.float(), labels.int()
    det = nms_ops.nms_fixed_batched(
        boxes, scores, labels, iou_threshold=cfg.iou_threshold,
        score_threshold=_logit_threshold(cfg, scores_are_logits),
        max_det=cfg.max_detections, class_aware=cfg.class_aware,
        backend=cfg.nms_backend)
    if scores_are_logits:
        det["scores"] = torch.sigmoid(det["scores"]) * det["valid"]
    if protos is not None and coefs_all is not None:
        _attach_masks(det, coefs_all, protos, crop, input_size, mask_dtype,
                      with_masks)
    return det


def postprocess_o2o_batch(boxes, cls_scores, coefs_all, protos,
                          cfg: PostprocessConfig, crop: bool = False,
                          input_size=(640, 640), mask_dtype=torch.float32,
                          scores_are_logits: bool = False,
                          with_masks: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """NMS-free batched postprocess of the one-to-one head (ModelConfig.o2o):
    the head is trained to emit one detection per object, so the slate is a
    score gate and a top-K gather, with no suppression loop and so no
    kernel. boxes [B,A,4], cls_scores [B,A,nc]; the same det contract as
    postprocess_batch_parts, `indices` being anchor ids, so the mask
    coefficients gather as in the NMS path. Ties keep the lower anchor
    first (a stable sort, as lax.top_k orders them); when A < max_det the
    slate is padded with -inf scores (invalid rows at anchor 0)."""
    scores, labels = cls_scores.max(-1)
    scores, labels = scores.float(), labels.int()
    thr = _logit_threshold(cfg, scores_are_logits)
    D = cfg.max_detections
    B, A = scores.shape
    top_s, idx = torch.sort(scores, stable=True, dim=-1, descending=True)
    top_s, idx = top_s[:, :D], idx[:, :D]
    if A < D:
        top_s = torch.cat([top_s, top_s.new_full((B, D - A), -np.inf)], -1)
        idx = torch.cat([idx, idx.new_zeros((B, D - A))], -1)
    det = {"indices": idx.int(),
           "boxes_xywh": boxes.gather(1, idx[..., None].expand(B, D, 4)),
           "labels": labels.gather(1, idx),
           "valid": top_s > thr}
    det["count"] = det["valid"].sum(-1).int()
    s = torch.sigmoid(top_s) if scores_are_logits else top_s
    det["scores"] = s * det["valid"]
    if protos is not None and coefs_all is not None:
        _attach_masks(det, coefs_all, protos, crop, input_size, mask_dtype,
                      with_masks)
    return det


def postprocess_pose_batch(boxes, cls_scores, kpts, cfg: PostprocessConfig,
                           scores_are_logits: bool = False,
                           backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Pose task: axis-aligned NMS on boxes [B,A,4] and cls_scores
    [B,A,nc] (ONE call for the batch: K1 on the card under "auto"), then
    each survivor's decoded keypoints kpts [B,A,K,D] -> det["kpts"]
    [B,max_det,K,D], zero on invalid rows."""
    _check_merge(cfg)
    scores, labels = cls_scores.max(-1)
    scores, labels = scores.float(), labels.int()
    det = nms_ops.nms_fixed_batched(
        boxes, scores, labels, iou_threshold=cfg.iou_threshold,
        score_threshold=_logit_threshold(cfg, scores_are_logits),
        max_det=cfg.max_detections, class_aware=cfg.class_aware,
        backend=backend)
    if scores_are_logits:
        det["scores"] = torch.sigmoid(det["scores"]) * det["valid"]
    B, D = det["indices"].shape
    idx = det["indices"].long()[:, :, None, None].expand(
        B, D, *kpts.shape[2:])
    det["kpts"] = kpts.gather(1, idx) * det["valid"][..., None, None]
    return det


def postprocess_obb_batch(boxes_xywhr, cls_scores, cfg: PostprocessConfig,
                          scores_are_logits: bool = False,
                          backend: str = "auto") -> Dict[str, torch.Tensor]:
    """OBB task: rotated (probIoU) NMS on boxes_xywhr [B,A,5] and
    cls_scores [B,A,nc]; the slate's box key is "boxes_xywhr" [B,max_det,5]
    (cx, cy, w, h, angle in radians). The whole batch goes through ONE NMS
    call (K3 on the card under "auto")."""
    if cfg.merge == "wbf":
        raise NotImplementedError(
            "merge 'wbf' for rotated boxes is not ported yet (ROADMAP queue "
            "1, item 9: accuracy modes, ops/wbf.py wbf_rotated_fixed_batched)")
    _check_merge(cfg)
    scores, labels = cls_scores.max(-1)
    scores, labels = scores.float(), labels.int()
    det = nms_ops.nms_fixed_rotated_batched(
        boxes_xywhr, scores, labels, iou_threshold=cfg.iou_threshold,
        score_threshold=_logit_threshold(cfg, scores_are_logits),
        max_det=cfg.max_detections, class_aware=cfg.class_aware,
        backend=backend)
    if scores_are_logits:
        det["scores"] = torch.sigmoid(det["scores"]) * det["valid"]
    return det


def postprocess_single(preds, protos, cfg: PostprocessConfig,
                       num_classes: int = 80, crop: bool = False,
                       input_size=(640, 640)) -> Dict[str, torch.Tensor]:
    """preds [A, 4+nc(+nm)] (sigmoid scores); protos [h,w,nm] or None."""
    coefs_all = preds[:, 4 + num_classes:] if protos is not None else None
    return postprocess_single_parts(
        preds[:, :4], preds[:, 4:4 + num_classes], coefs_all, protos, cfg,
        crop, input_size)


def postprocess(preds, protos, cfg: PostprocessConfig, num_classes: int = 80,
                crop: bool = False, input_size=(640, 640), device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """Batched postprocess of the concatenated heads: preds [B,A,C], protos
    [B,h,w,nm] or None -> [B,D,...]. Each image runs the single-image path
    (with pre_topk compaction when configured), through K2 on the card.
    Inputs (numpy or tensors) are moved to `device`."""
    dev = resolve_device(device)
    preds = to_device(preds, dev)
    if protos is not None:
        protos = to_device(protos, dev)
    dets = [postprocess_single(preds[b],
                               None if protos is None else protos[b],
                               cfg, num_classes, crop, input_size)
            for b in range(preds.shape[0])]
    return {k: torch.stack([d[k] for d in dets]) for k in dets[0]}
