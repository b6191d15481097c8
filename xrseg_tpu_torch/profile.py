"""Where the frame pipeline's time goes on the card: a torch.profiler
breakdown of a model at full width with detection_params weights, per
batch size. --model seg (the default) is YOLO11n-seg (640x640 on 480x640
uint8 frames, stretch); --model obb is YOLO11n-obb (1024x1024, 15 classes,
on 1024x1024 frames); --model pose is YOLO11n-pose (640x640, 1 class, 17
keypoints), --model cls YOLO11n-cls (224x224, 1000 classes, random init
weights: it has no detect head to patch) and --model v8seg YOLOv8n-seg
(640x640), all on 480x640 frames; --model tick is the fused XR tick on
the seg model
(build_xr_tick_pipeline: frame, re-lock, target mask, RGBD fusion on a
128x128 depth frame, one packed readback through the pipeline's pinned
buffer and copy stream; batch 1 only, with a locked target).

    python -m xrseg_tpu_torch.profile [--model seg|obb|pose|cls|v8seg|tick]
        [--batch 1 8]
        [--iters 20] [--json PATH]

For each batch size it prints, per frame batch: the host wall time (host
frames in, host slate out; measured without the profiler, then with it),
the summed device time of all kernels and copies, the device idle share
(1 - device / unprofiled wall), the number of kernel launches, and the
kernels that take the most device time. --json writes the same
numbers to PATH. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from xrseg_tpu_torch.compile import build_pipeline, build_xr_tick_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.models.yolo11 import init_params
from xrseg_tpu_torch.testing import detection_params, xr_frames


# model -> (its config, the frame size it is fed)
MODELS = {
    "seg": (ModelConfig(), (480, 640)),
    "obb": (ModelConfig(task="obb", num_classes=15, input_size=(1024, 1024)),
            (1024, 1024)),
    "pose": (ModelConfig(task="pose", num_classes=1), (480, 640)),
    "cls": (ModelConfig(task="classify", num_classes=1000,
                        input_size=(224, 224)), (480, 640)),
    "v8seg": (ModelConfig(arch="yolov8"), (480, 640)),
    "tick": (ModelConfig(), (480, 640)),
}
DEPTH_HW = (128, 128)


def frame_step(pipe, frames):
    """One frame batch: host frames in, host slate out."""
    return lambda: pipe(frames)["slate"].cpu()


def tick_step(cfg, model, frame_hw):
    """One fused tick with a locked target: host frame, depth and aux in,
    the packed output in the pipeline's pinned buffer out."""
    pipe = build_xr_tick_pipeline(cfg, model, frame_hw=frame_hw,
                                  depth_hw=DEPTH_HW).warmup()
    frame = xr_frames(1, frame_hw, DEPTH_HW, seed=1)[0]
    intr, pose = frame.intrinsics, frame.pose
    scale = (frame_hw[1] / cfg.model.input_size[1],
             frame_hw[0] / cfg.model.input_size[0])

    def aux(prev):
        return pipe.pack_aux(intr.focal_length, intr.principal_point,
                             intr.resolution, pose.position, pose.rotation,
                             prev, scale)

    def step(a):
        out = pipe(frame.rgb[None], frame.depth_fp16, a)
        pipe.readback.start(out["packed"])
        pipe.readback.wait()
        return pipe.unpack(pipe.readback.host())

    first = step(aux((0.0, 0.0, -1.0, 0.0)))          # nothing locked yet
    cx, cy = first["boxes_xywh"][0, :2]
    locked = aux((cx, cy, float(first["labels"][0]), 1.0))
    if not step(locked)["matched"]:
        raise RuntimeError("the tick did not re-lock its own first box")
    return lambda: step(locked)


def profile_batch(step, batch: int, iters: int, top: int = 12) -> dict:
    for _ in range(3):
        step()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / iters
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3 / iters, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "batch": batch, "wall_ms": wall_ms,
        "wall_ms_profiled": profiled_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "launches": len(kernels) / iters,
        "top": [{"kernel": k[:120], "ms": ms, "launches": n / iters}
                for k, (ms, n) in ranked],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="seg")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    mcfg, frame_hw = MODELS[args.model]
    cfg = ExecutorConfig(model=mcfg)
    gen = torch.Generator().manual_seed(0)
    model = (init_params(gen, cfg.model).cuda() if mcfg.task == "classify"
             else detection_params(gen, cfg.model))
    rng = np.random.default_rng(1)
    rows = []
    for B in ([1] if args.model == "tick" else args.batch):
        if args.model == "tick":
            step = tick_step(cfg, model, frame_hw)
        else:
            pipe = build_pipeline(cfg, model, frame_hw=frame_hw,
                                  batch=B).warmup()
            step = frame_step(pipe, rng.integers(
                0, 256, (B,) + frame_hw + (3,), np.uint8))
        r = profile_batch(step, B, args.iters)
        rows.append(r)
        print(f"b={B}: wall {r['wall_ms']:.3f} ms "
              f"({r['wall_ms_profiled']:.3f} profiled), device "
              f"{r['device_ms']:.3f}"
              f" ms, idle {r['device_idle_share']:.1%}, "
              f"{r['launches']:.0f} kernel launches per batch")
        for t in r["top"]:
            print(f"  {t['ms']:8.4f} ms {t['launches']:6.1f}x  {t['kernel']}")
    out = {"device": torch.cuda.get_device_name(0), "model": args.model,
           "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
