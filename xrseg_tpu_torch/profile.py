"""Where the frame pipeline's time goes on the card: a torch.profiler
breakdown of YOLO11n-seg at full width (640x640, detection_params weights,
480x640 uint8 frames, stretch), per batch size.

    python -m xrseg_tpu_torch.profile [--batch 1 8] [--iters 20] [--json PATH]

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

from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.testing import detection_params


def profile_batch(pipe, frames, iters: int, top: int = 12) -> dict:
    for _ in range(3):
        pipe(frames)["slate"].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe(frames)["slate"].cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pipe(frames)["slate"].cpu()
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
        "batch": frames.shape[0], "wall_ms": wall_ms,
        "wall_ms_profiled": profiled_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "launches": len(kernels) / iters,
        "top": [{"kernel": k[:120], "ms": ms, "launches": n / iters}
                for k, (ms, n) in ranked],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    cfg = ExecutorConfig(model=ModelConfig())
    model = detection_params(torch.Generator().manual_seed(0), cfg.model)
    rng = np.random.default_rng(1)
    rows = []
    for B in args.batch:
        pipe = build_pipeline(cfg, model, frame_hw=(480, 640),
                              batch=B).warmup()
        frames = rng.integers(0, 256, (B, 480, 640, 3), np.uint8)
        r = profile_batch(pipe, frames, args.iters)
        rows.append(r)
        print(f"b={B}: wall {r['wall_ms']:.3f} ms "
              f"({r['wall_ms_profiled']:.3f} profiled), device "
              f"{r['device_ms']:.3f}"
              f" ms, idle {r['device_idle_share']:.1%}, "
              f"{r['launches']:.0f} kernel launches per batch")
        for t in r["top"]:
            print(f"  {t['ms']:8.4f} ms {t['launches']:6.1f}x  {t['kernel']}")
    out = {"device": torch.cuda.get_device_name(0), "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
