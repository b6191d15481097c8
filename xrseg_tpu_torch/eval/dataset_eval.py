"""Dataset evaluation through the deployed pipeline: the framework's `val`
(counterpart of xrseg_tpu/eval/dataset_eval.py).

Runs a dataset (train.data.YoloDataset / SyntheticShapesDataset — anything
with __len__/__getitem__ returning the Sample contract) through the REAL
pipeline on the device (preprocess + forward + NMS/mask postprocess,
compile.build_pipeline: K1 for segment, detect and pose, K3 for obb, K5/K6
under merge="wbf" on a card) and scores box/mask mAP against the dataset's
GT with eval.metrics. Each batch's detection dict comes to the host once.
This is the quantitative half of the reference's eyeball-golden testing
(SURVEY §4: bus.png), generalized to any dataset.

CLI:
  python -m xrseg_tpu_torch.eval --data DIR --weights W.{pt,onnx,npz} \
      [--scale n] [--size 640] [--batch 8] [--score 0.05] \
      [--max-images N] [--device cuda|cpu]
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.eval.metrics import (Detection, GroundTruth,
                                          detections_from_slate, evaluate)
from xrseg_tpu_torch.train import data as data_lib


def _to_host(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A batch's detection dict on the host: each entry copied once."""
    return {k: v.detach().cpu().numpy() for k, v in det.items()}


def evaluate_dataset(cfg: ModelConfig, params, dataset,
                     score_threshold: float = 0.05,
                     iou_threshold: float = 0.6,
                     max_detections: int = 50,
                     max_images: Optional[int] = None,
                     batch: int = 8,
                     pipe=None,
                     coco_dump: Optional[str] = None,
                     tta: bool = False,
                     merge: str = "nms",
                     resize_mode: str = "stretch",
                     device="cuda") -> Dict[str, float]:
    """mAP of `params` through the deployed pipeline on `dataset`'s GT.

    Returns {box_mAP, box_AP50, box_AP75, mask_mAP?, n_images, n_gt}.
    The mAP-standard low score gate (0.05) keeps the PR curve intact; pass
    the deployed gate (0.301) to measure what the XR scene would show.
    `params` is a YOLO11 module (moved to `device`); a prebuilt `pipe`
    (CompiledPipeline, e.g. one with another nms_backend) is used as it
    is, on its own device.

    coco_dump: path to ALSO write the detections as a standard COCO
    results JSON (boxes in original-image [x,y,w,h] pixels, masks as
    compressed RLE) — directly scoreable by external pycocotools against
    the source annotations. Category/image ids come from the dataset's
    cat_ids/image_id (CocoDataset) when present, else label/index.
    """
    if pipe is not None and tta:
        raise ValueError("tta=True has no effect on a caller-supplied"
                         " pipe — build it with build_pipeline(tta=True)"
                         " and drop the flag here")
    if pipe is None:
        ex_cfg = ExecutorConfig(
            model=cfg,
            post=PostprocessConfig(score_threshold=score_threshold,
                                   iou_threshold=iou_threshold,
                                   max_detections=max_detections,
                                   merge=merge))
        pipe = build_pipeline(ex_cfg, params, crop_masks=True,
                              frame_hw=cfg.input_size, batch=batch,
                              tta=tta, device=device)
    H, W = cfg.input_size
    mh, mw = cfg.mask_size
    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)
    per_image = []
    dump_rows = [] if coco_dump else None
    n_gt = 0
    for b0 in range(0, n, batch):
        idx = range(b0, min(b0 + batch, n))
        raw = [dataset[i] for i in idx]
        if resize_mode == "letterbox":
            # aspect-preserving eval geometry: letterbox each sample
            # (image + normalized GT remapped into the padded canvas);
            # the stretch path below is then a no-op resize
            raw = [data_lib.letterbox_sample(s, (H, W)) for s in raw]
        frames = np.zeros((batch, H, W, 3), np.uint8)
        for j, s in enumerate(raw):
            frames[j] = data_lib._resize_uint8(s["image"], (H, W))
        det = _to_host(pipe(frames))
        for j, s in enumerate(raw):
            dets = detections_from_slate(det, j, input_size=(H, W))
            if dump_rows is not None:
                dump_rows += _coco_rows(dets, dataset, b0 + j,
                                        s["image"].shape[:2], (H, W))
            gts = []
            for g in range(len(s["labels"])):
                bx = s["boxes"][g] * (W, H, W, H)
                poly = s["polys"][g] if g < len(s["polys"]) else None
                m = data_lib.rasterize_mask(poly, s["boxes"][g],
                                            (mh, mw)) > 0.5
                gts.append(GroundTruth(bx.astype(np.float32),
                                       int(s["labels"][g]), m))
            n_gt += len(gts)
            # COCO iscrowd regions (CocoDataset): ignore-matched, never
            # counted as GT
            for g in range(len(s.get("ignore_boxes", ()))):
                bx = s["ignore_boxes"][g] * (W, H, W, H)
                im = s["ignore_masks"][g]
                if im is not None:      # nearest-resample to proto res
                    ih, iw = im.shape
                    yy = np.minimum((np.arange(mh) + 0.5) * ih // mh,
                                    ih - 1).astype(int)
                    xx = np.minimum((np.arange(mw) + 0.5) * iw // mw,
                                    iw - 1).astype(int)
                    im = im[yy][:, xx]
                gts.append(GroundTruth(bx.astype(np.float32),
                                       int(s["ignore_labels"][g]), im,
                                       ignore=True))
            per_image.append((dets, gts))
    box = evaluate(per_image, use_mask=False)
    out = {"box_mAP": box["mAP"], "box_AP50": box["AP50"],
           "box_AP75": box["AP75"], "n_images": n, "n_gt": n_gt}
    if any(d.mask is not None for dets, _ in per_image for d in dets):
        mask = evaluate(per_image, use_mask=True)
        out.update({"mask_mAP": mask["mAP"], "mask_AP50": mask["AP50"]})
    if dump_rows is not None:
        with open(coco_dump, "w") as f:
            json.dump(dump_rows, f)
        out["dumped"] = len(dump_rows)
    return out


def _coco_rows(dets, dataset, index: int, orig_hw, input_hw) -> list:
    """Detections (input-pixel space) -> COCO results rows in
    original-image pixels, masks as compressed RLE at original res."""
    oh, ow = int(orig_hw[0]), int(orig_hw[1])
    H, W = input_hw
    sx, sy = ow / W, oh / H
    img_id = (dataset.image_id(index)
              if hasattr(dataset, "image_id") else index)
    cat_ids = getattr(dataset, "cat_ids", None)
    rows = []
    for d in dets:
        if cat_ids is not None and d.label >= len(cat_ids):
            continue    # class absent from the annotation file: such a
            # row would fail pycocotools loadRes (result cat ids must be
            # a subset of the GT's), and it can only ever score as FP
        cx, cy, w, h = (float(v) for v in d.box_xywh)
        # clip to the image (ultralytics convention for results files)
        x1 = min(max((cx - w / 2) * sx, 0.0), ow)
        y1 = min(max((cy - h / 2) * sy, 0.0), oh)
        x2 = min(max((cx + w / 2) * sx, 0.0), ow)
        y2 = min(max((cy + h / 2) * sy, 0.0), oh)
        row = {"image_id": img_id,
               "category_id": (cat_ids[d.label] if cat_ids else d.label),
               "bbox": [round(x1, 2), round(y1, 2),
                        round(x2 - x1, 2), round(y2 - y1, 2)],
               "score": round(float(d.score), 5)}
        if d.mask is not None:
            mh, mw = d.mask.shape
            yy = np.minimum((np.arange(oh) * mh) // oh, mh - 1)
            xx = np.minimum((np.arange(ow) * mw) // ow, mw - 1)
            row["segmentation"] = data_lib.encode_coco_rle(d.mask[yy][:, xx])
        rows.append(row)
    return rows


def evaluate_task_dataset(cfg: ModelConfig, params, dataset,
                          score_threshold: float = 0.05,
                          iou_threshold: float = 0.6,
                          max_detections: int = 50,
                          max_images: Optional[int] = None,
                          batch: int = 4,
                          pipe=None,
                          coco_dump: Optional[str] = None,
                          tta: bool = False,
                          tta_kpt_flip_idx=None,
                          merge: str = "nms",
                          device="cuda"
                          ) -> Dict[str, float]:
    """Task-family `val`: pose (OKS keypoint AP), obb (probIoU rotated
    AP), classify (top-1 accuracy) of `params` through the REAL compiled
    pipeline on a dataset speaking the task's Sample contract
    (SyntheticPoseDataset / SyntheticOBBDataset / SyntheticClassifyDataset
    or equivalents).

    coco_dump (pose only): ALSO write a standard COCO keypoint-results
    JSON ({image_id, category_id, keypoints: [x,y,v...], score} in
    original-image pixels) for external pycocotools OKS scoring."""
    if cfg.task not in ("pose", "obb", "classify"):
        raise ValueError("use evaluate_dataset for detect/segment")
    if pipe is not None and tta:
        raise ValueError("tta=True has no effect on a caller-supplied"
                         " pipe — build it with build_pipeline(tta=True)")
    if pipe is None:
        ex_cfg = ExecutorConfig(
            model=cfg,
            post=PostprocessConfig(score_threshold=score_threshold,
                                   iou_threshold=iou_threshold,
                                   max_detections=max_detections,
                                   merge=merge))
        pipe = build_pipeline(ex_cfg, params,
                              frame_hw=cfg.input_size, batch=batch,
                              tta=(tta and cfg.task != "classify"),
                              tta_kpt_flip_idx=tta_kpt_flip_idx,
                              device=device)
    H, W = cfg.input_size
    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)

    if cfg.task == "classify":
        correct = 0
        for b0 in range(0, n, batch):
            idx = range(b0, min(b0 + batch, n))
            raw = [dataset[i] for i in idx]
            frames = np.zeros((batch, H, W, 3), np.uint8)
            for j, s in enumerate(raw):
                frames[j] = data_lib._resize_uint8(s["image"], (H, W))
            probs = pipe(frames)["slate"].cpu().numpy()
            for j, s in enumerate(raw):
                correct += int(probs[j].argmax() == s["label"])
        return {"top1_acc": correct / max(n, 1), "n_images": n}

    per_image = []
    dump_rows = [] if coco_dump else None
    n_gt = 0
    for b0 in range(0, n, batch):
        idx = range(b0, min(b0 + batch, n))
        raw = [dataset[i] for i in idx]
        frames = np.zeros((batch, H, W, 3), np.uint8)
        for j, s in enumerate(raw):
            frames[j] = data_lib._resize_uint8(s["image"], (H, W))
        det = _to_host(pipe(frames))
        for j, s in enumerate(raw):
            cnt = int(det["count"][j])
            dets, gts = [], []
            if cfg.task == "pose":
                for i in range(cnt):
                    dets.append(Detection(
                        np.asarray(det["boxes_xywh"][j][i], np.float32),
                        int(det["labels"][j][i]),
                        float(det["scores"][j][i]),
                        kpts=np.asarray(det["kpts"][j][i], np.float32)))
                if dump_rows is not None:
                    dump_rows += _coco_kpt_rows(
                        dets, dataset, b0 + j, s["image"].shape[:2],
                        (H, W))
                for g in range(len(s["labels"])):
                    bx = (s["boxes"][g] * (W, H, W, H)).astype(np.float32)
                    k = np.asarray(s["kpts"][g], np.float32).copy()
                    k[:, 0] *= W
                    k[:, 1] *= H
                    gts.append(GroundTruth(bx, int(s["labels"][g]),
                                           kpts=k))
                # iscrowd / num_keypoints==0 ignore regions
                # (CocoPoseDataset): box-overlap shielded, never GT
                for g in range(len(s.get("ignore_boxes", ()))):
                    bx = s["ignore_boxes"][g] * (W, H, W, H)
                    gts.append(GroundTruth(bx.astype(np.float32),
                                           int(s["ignore_labels"][g]),
                                           ignore=True))
            else:                                      # obb
                for i in range(cnt):
                    rb = np.asarray(det["boxes_xywhr"][j][i], np.float32)
                    dets.append(Detection(
                        rb[:4], int(det["labels"][j][i]),
                        float(det["scores"][j][i]), box_xywhr=rb))
                for g in range(len(s["labels"])):
                    rb = np.asarray(s["boxes_xywhr"][g], np.float32).copy()
                    rb[0] *= W
                    rb[1] *= H
                    rb[2] *= W
                    rb[3] *= H
                    gts.append(GroundTruth(rb[:4], int(s["labels"][g]),
                                           box_xywhr=rb))
            n_gt += sum(not g.ignore for g in gts)
            per_image.append((dets, gts))
    sim = "oks" if cfg.task == "pose" else "rbox"
    r = evaluate(per_image, similarity=sim)
    key = "oks" if cfg.task == "pose" else "rbox"
    out = {f"{key}_mAP": r["mAP"], f"{key}_AP50": r["AP50"],
           "n_images": n, "n_gt": n_gt}
    if dump_rows is not None:
        with open(coco_dump, "w") as f:
            json.dump(dump_rows, f)
        out["dumped"] = len(dump_rows)
    return out


def _coco_kpt_rows(dets, dataset, index: int, orig_hw, input_hw) -> list:
    """Pose detections -> COCO keypoint-results rows (original pixels)."""
    oh, ow = int(orig_hw[0]), int(orig_hw[1])
    H, W = input_hw
    sx, sy = ow / W, oh / H
    img_id = (dataset.image_id(index)
              if hasattr(dataset, "image_id") else index)
    cat_ids = getattr(dataset, "cat_ids", None)
    rows = []
    for d in dets:
        if cat_ids is not None and d.label >= len(cat_ids):
            continue    # unmapped class: unloadable by pycocotools
        k = np.asarray(d.kpts, np.float64).copy()
        k[:, 0] *= sx
        k[:, 1] *= sy
        rows.append({
            "image_id": img_id,
            "category_id": (cat_ids[d.label] if cat_ids else d.label),
            "keypoints": [round(float(v), 2) for v in k.reshape(-1)],
            "score": round(float(d.score), 5)})
    return rows


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="dataset images dir (YOLO-format without --ann; "
                         "with --ann, the COCO images dir) or 'synthetic'")
    ap.add_argument("--ann", default=None, metavar="JSON",
                    help="COCO instances annotation file "
                         "(e.g. instances_val2017.json); --data is then "
                         "the images directory")
    ap.add_argument("--weights",
                    help=".sentis (the reference's artifact), .pt/.pth "
                         "(ultralytics state dict), .onnx or .npz weights "
                         "(orbax is refused: convert it to .npz with the "
                         "JAX package)")
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--task", default="segment",
                    choices=["segment", "detect"])
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--classes", type=int, default=80)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--score", type=float, default=0.05)
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--dump", default=None, metavar="JSON",
                    help="also write detections as a COCO results JSON "
                         "(scoreable by external pycocotools)")
    ap.add_argument("--tta", action="store_true",
                    help="2-view test-time augmentation (identity + "
                         "hflip, merged pre-NMS; ~2x device cost)")
    ap.add_argument("--merge", default="nms", choices=["nms", "wbf"],
                    help="candidate merge: greedy NMS (reference "
                         "semantics) or Weighted Box Fusion")
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate on (default: the card)")
    args = ap.parse_args()

    cfg = ModelConfig(arch=args.arch, scale=args.scale, task=args.task,
                      input_size=(args.size, args.size),
                      num_classes=args.classes)
    if args.weights:
        from xrseg_tpu_torch.io.weights import load_params_auto
        params, cfg = load_params_auto(args.weights, cfg)
    else:
        from xrseg_tpu_torch.models import yolo11
        params = yolo11.init_params(torch.Generator().manual_seed(0), cfg)

    if args.data == "synthetic":
        ds = data_lib.SyntheticShapesDataset(
            n=32, hw=(args.size, args.size), n_classes=min(3, args.classes))
    elif args.ann:
        ds = data_lib.CocoDataset(args.ann, args.data)
    else:
        ds = data_lib.YoloDataset(args.data)

    out = evaluate_dataset(cfg, params, ds, score_threshold=args.score,
                           iou_threshold=args.iou,
                           max_images=args.max_images, batch=args.batch,
                           coco_dump=args.dump, tta=args.tta,
                           merge=args.merge, device=args.device)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
