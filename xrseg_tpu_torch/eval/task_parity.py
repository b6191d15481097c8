"""Task-family end-to-end parity: the deployed pose/obb/classify pipelines
vs the independent CPU oracle (counterpart of
xrseg_tpu/eval/task_parity.py).

The task-family analogue of eval/parity.py: the same weights run through
(a) the deployed pipeline on `device` (build_pipeline: preprocess ->
forward -> task decode -> fixed-shape NMS slate, K1/K3 on a card) and
(b) eval/parity's oracle (the network as a float32 copy on the CPU with
TF32 forbidden, then the naive numpy NMS of ops/nms), on the same images.
The oracle's outputs serve as ground truth and ours are scored with the
task's native metric:

  pose     -> OKS-AP (COCO keypoint protocol) + box AP
  obb      -> rotated AP (probIoU matching) over xywhr slates
  classify -> top-1 agreement + prob max-abs-diff
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from xrseg_tpu_torch.config import ModelConfig, PostprocessConfig
from xrseg_tpu_torch.eval.metrics import Detection, GroundTruth, evaluate
from xrseg_tpu_torch.eval.parity import (oracle_model, oracle_outputs,
                                         our_slates)
from xrseg_tpu_torch.ops.nms import (nms_reference_numpy,
                                     nms_rotated_reference_numpy)


def _with_vis(k: np.ndarray) -> np.ndarray:
    """Vis-less skeletons [K,2] score as fully visible [K,3]."""
    if k.shape[-1] == 2:
        k = np.concatenate([k, np.ones_like(k[..., :1])], -1)
    return k


def pose_parity_report(images: Sequence[np.ndarray], params,
                       mcfg: ModelConfig, pcfg: PostprocessConfig,
                       device="cuda") -> Dict[str, float]:
    """OKS-AP + box-AP of the deployed pose pipeline vs the CPU oracle
    (float32 forward -> numpy class-aware NMS -> keypoint gather)."""
    model = oracle_model(params)
    ours, oracle = [], []
    for img, det in zip(images, our_slates(images, params, mcfg, pcfg,
                                           device)):
        n = int(det["count"][0])
        ours.append([Detection(np.asarray(det["boxes_xywh"][0][i]),
                               int(det["labels"][0][i]),
                               float(det["scores"][0][i]),
                               kpts=_with_vis(np.asarray(
                                   det["kpts"][0][i], np.float32)))
                     for i in range(n)])

        out = oracle_outputs(model, img)
        scores = out["scores"][0]                      # [A, nc]
        best = scores.max(-1)
        labels = scores.argmax(-1)
        kept = nms_reference_numpy(out["boxes_xywh"][0], best, labels,
                                   pcfg.iou_threshold,
                                   pcfg.score_threshold,
                                   class_aware=pcfg.class_aware,
                                   max_keep=pcfg.max_detections)
        oracle.append([GroundTruth(out["boxes_xywh"][0][i], int(labels[i]),
                                   kpts=_with_vis(np.asarray(
                                       out["kpts"][0][i], np.float32)))
                       for i in kept])

    pairs = list(zip(ours, oracle))
    ap_oks = evaluate(pairs, similarity="oks")
    ap_box = evaluate(pairs, similarity="box")
    return {"oks_mAP": ap_oks["mAP"], "oks_AP50": ap_oks["AP50"],
            "box_mAP": ap_box["mAP"], "box_AP50": ap_box["AP50"],
            "n_detections_ours": sum(len(d) for d in ours),
            "n_detections_oracle": sum(len(g) for g in oracle),
            "n_images": len(images)}


def obb_parity_report(images: Sequence[np.ndarray], params,
                      mcfg: ModelConfig, pcfg: PostprocessConfig,
                      device="cuda") -> Dict[str, float]:
    """Rotated AP (probIoU matching) of the deployed obb pipeline vs the
    CPU oracle (float32 forward -> numpy rotated NMS)."""
    model = oracle_model(params)
    ours, oracle = [], []
    for img, det in zip(images, our_slates(images, params, mcfg, pcfg,
                                           device)):
        n = int(det["count"][0])
        dets = []
        for i in range(n):
            r = np.asarray(det["boxes_xywhr"][0][i], np.float64)
            dets.append(Detection(r[:4], int(det["labels"][0][i]),
                                  float(det["scores"][0][i]),
                                  box_xywhr=r))
        ours.append(dets)

        out = oracle_outputs(model, img)
        scores = out["scores"][0]
        best = scores.max(-1)
        labels = scores.argmax(-1)
        rboxes = np.asarray(out["boxes_xywhr"][0], np.float64)
        kept = nms_rotated_reference_numpy(rboxes, best, labels,
                                           pcfg.iou_threshold,
                                           pcfg.score_threshold,
                                           class_aware=pcfg.class_aware,
                                           max_keep=pcfg.max_detections)
        oracle.append([GroundTruth(rboxes[i][:4], int(labels[i]),
                                   box_xywhr=rboxes[i]) for i in kept])

    pairs = list(zip(ours, oracle))
    ap = evaluate(pairs, similarity="rbox")
    return {"rbox_mAP": ap["mAP"], "rbox_AP50": ap["AP50"],
            "n_detections_ours": sum(len(d) for d in ours),
            "n_detections_oracle": sum(len(g) for g in oracle),
            "n_images": len(images)}


def classify_parity_report(images: Sequence[np.ndarray], params,
                           mcfg: ModelConfig, pcfg: PostprocessConfig,
                           device="cuda") -> Dict[str, float]:
    """Top-1 agreement + softmax max-abs-diff of the deployed classify
    pipeline vs the CPU oracle."""
    model = oracle_model(params)
    agree = 0
    max_diff = 0.0
    for img, det in zip(images, our_slates(images, params, mcfg, pcfg,
                                           device)):
        probs = np.asarray(det["probs"][0], np.float64)
        logits = oracle_outputs(model, img)["logits"][0].astype(np.float64)
        e = np.exp(logits - logits.max())
        oprobs = e / e.sum()
        agree += int(probs.argmax() == oprobs.argmax())
        max_diff = max(max_diff, float(np.abs(probs - oprobs).max()))
    return {"top1_agreement": agree / len(images),
            "prob_max_abs_diff": max_diff, "n_images": len(images)}


TASK_REPORTS = {"pose": pose_parity_report, "obb": obb_parity_report,
                "classify": classify_parity_report}


def task_parity_report(task: str, images: Sequence[np.ndarray], params,
                       mcfg: ModelConfig, pcfg: PostprocessConfig,
                       device="cuda") -> Dict[str, float]:
    return TASK_REPORTS[task](images, params, mcfg, pcfg, device)
