"""Batch/stream serving CLI: image paths in, JSON detections out (the
port's examples/serve.py).

Reads newline-separated image paths (stdin or --list), streams them
through a StreamingRunner over a b=1 pipeline (K1 on the card), and
prints one JSON object per image:

  {"path": ..., "latency_ms": ..., "detections": [{"label",
   "class_name", "score", "box_xywh" (frame pixels)}, ...]}

  ls imgs/*.jpg | python -m xrseg_tpu_torch.examples.serve --ckpt m.npz
  python -m xrseg_tpu_torch.examples.serve --list paths.txt [--device cuda]

Without --ckpt the model is random from --seed. .sentis raises (ROADMAP
item 13).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--list", default=None, help="file of image paths")
    ap.add_argument("--sentis", default=None,
                    help=".sentis model file: refused (ROADMAP item 13)")
    ap.add_argument("--ckpt", default=None,
                    help="weights (.npz/.pt/.onnx)")
    ap.add_argument("--scale", default="n")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--score", type=float, default=0.23)
    ap.add_argument("--depth", type=int, default=4, help="pipeline depth")
    ap.add_argument("--frame-hw", type=int, nargs=2, default=None,
                    help="normalize all images to this size (h w); default: "
                         "size of the first image")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    import torch

    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                        PostprocessConfig)
    from xrseg_tpu_torch.eval.metrics import detections_from_slate
    from xrseg_tpu_torch.io.weights import load_params_auto
    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner
    from xrseg_tpu_torch.viz.labels import COCO_LABELS

    if args.list:
        with open(args.list) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    else:
        paths = [ln.strip() for ln in sys.stdin if ln.strip()]
    if not paths:
        print("no input paths", file=sys.stderr)
        return 2

    mcfg = ModelConfig(arch=args.arch, scale=args.scale)
    if args.ckpt or args.sentis:          # .sentis: load_params_auto refuses
        params, mcfg = load_params_auto(args.ckpt or args.sentis, mcfg)
    else:
        params = yolo11.init_params(torch.Generator().manual_seed(args.seed),
                                    mcfg)

    def load(path):
        img = Image.open(path).convert("RGB")
        if args.frame_hw:
            img = img.resize((args.frame_hw[1], args.frame_hw[0]))
        return np.asarray(img, np.uint8)

    first = load(paths[0])
    fh, fw = first.shape[:2]
    cfg = ExecutorConfig(model=mcfg, post=PostprocessConfig(
        iou_threshold=args.iou, score_threshold=args.score))
    pipe = build_pipeline(cfg, params, frame_hw=(fh, fw), batch=1,
                          device=args.device).warmup()
    runner = StreamingRunner(pipe, depth=args.depth)

    def frames():
        yield first[None]
        for p in paths[1:]:
            img = load(p)
            if img.shape[:2] != (fh, fw):
                img = np.asarray(Image.fromarray(img).resize((fw, fh)),
                                 np.uint8)
            yield img[None]

    for path, res in zip(paths, runner.run(frames())):
        s = res.slate
        dets = detections_from_slate(
            {"boxes_xywh": [s["boxes_xywh"]], "labels": [s["labels"]],
             "scores": [s["scores"]], "count": [s["count"]]},
            frame_hw=(fh, fw), input_size=mcfg.input_size)
        print(json.dumps({
            "path": path,
            "latency_ms": round(res.latency_s * 1e3, 1),
            "detections": [{
                "label": d.label,
                "class_name": (COCO_LABELS[d.label]
                               if d.label < len(COCO_LABELS) else "?"),
                "score": round(d.score, 3),
                "box_xywh": [round(float(v), 1) for v in d.box_xywh],
            } for d in dets],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
