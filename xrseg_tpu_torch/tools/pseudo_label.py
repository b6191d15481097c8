"""Pseudo-label an unlabelled image directory into COCO instances JSON
(the port's tools/pseudo_label.py).

Runs the deployed pipeline (on the card, its NMS is K1) over every image
and writes standard COCO annotations, boxes and polygonized instance
masks, which `python -m xrseg_tpu_torch.examples.train --data DIR --ann
pseudo.json` (or any COCO consumer) trains on.

  python -m xrseg_tpu_torch.tools.pseudo_label --images frames/ \
      --weights model.npz --out frames/pseudo.json [--device cuda]

--weights takes .npz, .pt/.pth, .onnx or .sentis; orbax directories raise
(ROADMAP item 13b).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True, help="unlabeled image dir")
    ap.add_argument("--weights", required=True,
                    help="teacher weights (.npz/.onnx/.pt/.sentis)")
    ap.add_argument("--out", required=True, help="COCO JSON to write")
    ap.add_argument("--score-gate", type=float, default=0.5,
                    help="min teacher confidence for a pseudo label")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--size", type=int, default=640, help="model input")
    ap.add_argument("--classes", type=int, default=80)
    ap.add_argument("--poly-step", type=int, default=2,
                    help="polygon row subsampling (bigger = smaller JSON)")
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np
    from PIL import Image

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.io.weights import load_params_auto, with_config
    from xrseg_tpu_torch.train.pseudo import (coco_from_samples,
                                              generate_pseudo_samples)

    cfg = ExecutorConfig(model=ModelConfig(
        arch=args.arch, scale=args.scale, num_classes=args.classes,
        input_size=(args.size, args.size)))
    model, got = load_params_auto(args.weights, cfg.model)
    if got is not None and got.num_classes != args.classes:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(got,
                                           input_size=cfg.model.input_size))
    model = with_config(model, cfg.model)

    exts = (".png", ".jpg", ".jpeg", ".bmp")
    files = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith(exts))
    if args.max_images:
        files = files[:args.max_images]
    if not files:
        print(f"no images in {args.images}", file=sys.stderr)
        return 2

    def frames():
        for f in files:
            yield np.asarray(
                Image.open(os.path.join(args.images, f)).convert("RGB"),
                np.uint8)

    samples = generate_pseudo_samples(cfg, model, frames(),
                                      score_gate=args.score_gate,
                                      poly_step=args.poly_step,
                                      device=device)
    if cfg.model.num_classes == 80:
        from xrseg_tpu_torch.viz.labels import COCO_LABELS as names
    else:
        names = [str(i) for i in range(cfg.model.num_classes)]
    coco = coco_from_samples(samples, files, names)
    with open(args.out, "w") as f:
        json.dump(coco, f)
    n_ann = len(coco["annotations"])
    n_seg = sum(1 for a in coco["annotations"] if "segmentation" in a)
    print(json.dumps({"images": len(files), "annotations": n_ann,
                      "with_masks": n_seg, "out": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
