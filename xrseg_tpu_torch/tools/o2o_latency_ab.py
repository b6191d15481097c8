"""o2o vs classic-NMS b=1 latency, apples to apples (the port's
tools/o2o_latency_ab.py).

ONE process, both pipelines built up front (plain, whose NMS is K1, and
ModelConfig(o2o=True), which runs no NMS; b=1, bf16 weights: the
latency-mode serving configuration), then ROUND-ROBIN interleaved timed
frames so any host weather hits both arms equally. Each timed call ends
with a host copy of the slate. Reports p50/p95/p99 per arm plus each
arm's 5 slowest frames with their positions in the sequence (a periodic
spike pattern = the host; an o2o-only tail = the o2o program itself).

    python -m xrseg_tpu_torch.tools.o2o_latency_ab --frames 150
    python -m xrseg_tpu_torch.tools.o2o_latency_ab --device cpu \\
        --frames 20 --size 64
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150,
                    help="timed frames per arm")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from xrseg_tpu_torch.compile import load_model
    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    hw = (args.size, args.size)
    pipes = {}
    for name, o2o in (("plain", False), ("o2o", True)):
        cfg = ExecutorConfig(model=ModelConfig(
            scale=args.scale, input_size=hw, o2o=o2o, dtype="float32"))
        print(f"building {name}...", flush=True)
        pipes[name] = load_model(cfg, batch=1, params_dtype="bfloat16",
                                 seed=0, device=dev)

    # the frames lie on the device, as the reference's jnp arrays do
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(
        rng.integers(0, 255, (1, *hw, 3)).astype(np.uint8)).to(dev)
        for _ in range(2)]
    lats = {"plain": [], "o2o": []}
    for i in range(args.warmup + args.frames):
        for name in ("plain", "o2o"):        # round-robin: shared weather
            t0 = time.perf_counter()
            out = pipes[name](frames[i % 2])
            out["slate"].cpu()               # host-anchored
            if i >= args.warmup:
                lats[name].append(time.perf_counter() - t0)

    row = {"metric": "o2o_latency_ab_b1", "unit": "ms",
           "frames": args.frames, "size": args.size}
    for name, ls in lats.items():
        a = np.asarray(ls) * 1e3
        worst = np.argsort(a)[-5:][::-1]
        row[name] = {
            "p50": round(float(np.percentile(a, 50)), 2),
            "p95": round(float(np.percentile(a, 95)), 2),
            "p99": round(float(np.percentile(a, 99)), 2),
            "worst_ms": [round(float(a[i]), 1) for i in worst],
            "worst_at_frame": [int(i) for i in worst],
        }
    row["p50_delta_ms"] = round(row["o2o"]["p50"] - row["plain"]["p50"], 2)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
