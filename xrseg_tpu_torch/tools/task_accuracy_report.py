"""Task-family parity report: pose, obb and classify through the deployed
pipeline against the CPU float32 oracle (the port's
tools/task_accuracy_report.py).

Five deterministic synthetic frames (numpy seed 7: the JAX script's
frames when the reference app's bundled COCO images are not mounted),
each with 4 deterministic augmentations, at --size x --size, run through each
task's pipeline on --device and through eval/task_parity's oracle with the
same weights, scored with the task's own metric (OKS-AP, rotated
probIoU-AP, top-1 agreement). pose and obb take
testing.detection_params weights (every anchor fires; the keypoint and
angle branches keep their random init), classify plain random init.

  python -m xrseg_tpu_torch.tools.task_accuracy_report [--size 640] \\
      [--task pose|obb|classify] [--out report.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def load_images(size: int):
    """The JAX script's synthetic fallback frames, augmented."""
    from xrseg_tpu_torch.eval.parity import augment_images
    rng = np.random.default_rng(7)
    return augment_images([rng.integers(0, 255, (size, size, 3),
                                        dtype=np.uint8) for _ in range(5)])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--out", default=None)
    ap.add_argument("--task", default=None,
                    choices=["pose", "obb", "classify"],
                    help="run one task only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from xrseg_tpu_torch.config import ModelConfig, PostprocessConfig
    from xrseg_tpu_torch.eval.task_parity import task_parity_report
    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.testing import detection_params

    images = load_images(args.size)
    print(f"{len(images)} scenes at {args.size}^2 (synthetic)", flush=True)
    pcfg = PostprocessConfig(iou_threshold=0.43, score_threshold=0.301,
                             max_detections=50)   # the deployed XR preset
    results = {}
    specs = [("pose", dict(kpt_shape=(17, 3)), True),
             ("obb", {}, True),
             ("classify", dict(num_classes=80), False)]
    if args.task:
        specs = [s for s in specs if s[0] == args.task]
    for task, kw, fixture in specs:
        mcfg = ModelConfig(scale="n", input_size=(args.size, args.size),
                           dtype="float32", task=task, **kw)
        gen = torch.Generator().manual_seed(0)
        params = (detection_params(gen, mcfg, device="cpu") if fixture
                  else yolo11.init_params(gen, mcfg))
        r = task_parity_report(task, images, params, mcfg, pcfg,
                               device=args.device)
        results[task] = r
        print(json.dumps({"task": task, **{
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in r.items()}}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
