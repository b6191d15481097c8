"""Active-learning frame selection (the port's tools/select_frames.py):
rank an unlabelled image directory by the deployed model's uncertainty
and print the top-K frames to label.

  python -m xrseg_tpu_torch.tools.select_frames --images frames/ \
      --weights model.npz --k 20 --strategy flip [--device cuda]

On the card each frame's NMS is K1, twice a frame under "flip".
--weights takes .npz, .pt/.pth, .onnx or .sentis; orbax directories
raise (ROADMAP item 13b).
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
    ap.add_argument("--images", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--strategy", default="margin",
                    choices=["margin", "flip"])
    ap.add_argument("--score-gate", type=float, default=0.05)
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--classes", type=int, default=80)
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np
    from PIL import Image

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.io.weights import load_params_auto, with_config
    from xrseg_tpu_torch.train.active import rank_frames

    cfg = ExecutorConfig(model=ModelConfig(
        arch=args.arch, scale=args.scale, num_classes=args.classes,
        input_size=(args.size, args.size)))
    model, got = load_params_auto(args.weights, cfg.model)
    if got is not None:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(got,
                                           input_size=cfg.model.input_size))
    model = with_config(model, cfg.model)

    exts = (".png", ".jpg", ".jpeg", ".bmp")
    files = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith(exts))
    if not files:
        print(f"no images in {args.images}", file=sys.stderr)
        return 2

    def frames():
        for f in files:
            yield np.asarray(
                Image.open(os.path.join(args.images, f)).convert("RGB"),
                np.uint8)

    ranked = rank_frames(cfg, model, frames(), strategy=args.strategy,
                         score_gate=args.score_gate, device=device)
    rows = [{"file": files[i], "uncertainty": round(u, 4)}
            for i, u in ranked[:args.k]]
    for r in rows:
        print(f"{r['uncertainty']:8.4f}  {r['file']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"strategy": args.strategy, "scored": len(files),
                      "selected": len(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
