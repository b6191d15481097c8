"""Times of the greedy-NMS kernels (K1, K2, K3) on one NVIDIA card.

    python -m xrseg_tpu_torch.nms_times [--clusters] [--shapes K3:8x21504 ...]
                                        [--json nms_times.json]

Each shape is KERNEL:BxK (K2 takes B = 1). For each it builds seeded
inputs (`nms_inputs`, `rotated_inputs`: the inputs chip_smoke.py checks the
kernels on), launches the kernel through its wrapper and prints the mean
device time of a launch by CUDA events, the greedy steps the loop ran and
the microseconds per step. With --clusters every shape is also timed with
each cluster size (blocks per image) forced that can hold it: the table
`launch_plan`'s thresholds were read from. The first line printed is the
card's name and power limit as nvidia-smi gives them; times of two trees
compare only when taken on one card, one right after the other.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from xrseg_tpu_torch.ops import nms as nms_ops
from xrseg_tpu_torch.ops import nms_kernels as nk

MAX_DET = 50
IOU = 0.6
GATE = float(np.log(0.23 / 0.77))     # logit-space gate of score 0.23
K_OBB = 21504                         # the anchors of a 1024x1024 input
SHAPES = ("K3:1x21504", "K3:8x21504", "K3:32x21504",
          "K1:1x8400", "K1:8x8400", "K1:32x8400", "K1:128x8400",
          "K1:1x21504", "K1:8x21504", "K2:1x8400", "K2:1x1024")


def nms_inputs(rng, B: int, K: int, extent: float = 640.0, device="cuda"):
    """Corners [B,K,4] (class offset applied) and masked scores [B,K] on
    `device`: bf16-quantised logits (exact ties), about 20% of them below
    the gate, every 13th box of zero width, and, for B > 1, a last image
    entirely below the gate."""
    cxy = rng.uniform(0, extent, (B, K, 2))
    wh = rng.uniform(4, 96, (B, K, 2))
    wh[:, ::13, 0] = 0.0
    boxes = torch.from_numpy(np.concatenate([cxy, wh], -1).astype(np.float32))
    scores = torch.from_numpy(rng.normal(0.0, 1.5, (B, K)).astype(np.float32))
    scores = scores.bfloat16().float()
    if B > 1:
        scores[-1] = -10.0
    labels = torch.from_numpy(rng.integers(0, 4, (B, K)))
    corners = nms_ops.class_corners(boxes, labels, True).to(device)
    masked = torch.where(scores > GATE, scores, nk.NEG).to(device)
    return corners, masked


def rotated_inputs(rng, B: int, K: int, device="cuda"):
    """K3's inputs on `device`: Gaussian rows [B,6,K] of class-shifted
    rotated boxes in a 1024x1024 scene (15 classes) and masked scores
    [B,K]: bf16-quantised logits (exact ties), about 20% below the gate,
    every 13th box of zero width, the first 64 boxes as 32 thin (64x0.5 px)
    pairs 0.3 px and 1e-3 rad apart, and, for B > 1, a last image entirely
    below the gate."""
    boxes = np.concatenate([rng.uniform(0, 1024, (B, K, 2)),
                            rng.uniform(4, 96, (B, K, 2)),
                            rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, K, 1))],
                           -1).astype(np.float32)
    boxes[:, ::13, 2] = 0.0
    boxes[:, 1:64:2, :2] = boxes[:, 0:64:2, :2] + np.float32(0.3)
    boxes[:, :64, 2:4] = np.float32([64.0, 0.5])
    boxes[:, 1:64:2, 4] = boxes[:, 0:64:2, 4] + np.float32(1e-3)
    scores = torch.from_numpy(rng.normal(0.0, 1.5, (B, K)).astype(np.float32))
    scores = scores.bfloat16().float()
    if B > 1:
        scores[-1] = -10.0
    labels = torch.from_numpy(rng.integers(0, 15, (B, K)))
    shifted = nms_ops.class_shifted(torch.from_numpy(boxes).to(device),
                                    labels.to(device), True)
    masked = torch.where(scores > GATE, scores, nk.NEG).to(device)
    return nk.rotated_gaussian_rows(shifted), masked


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events. A large
    matrix product (about 20 ms) is queued ahead of the first event, so the
    host has enqueued the calls before the card reaches them: a call shorter
    than the host takes to issue it is still timed on the card, not on the
    host."""
    for _ in range(warmup):
        fn()
    ballast = torch.ones((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(ballast, ballast)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def steps_run(ok: torch.Tensor) -> int:
    """Greedy steps the slowest image's loop ran: one past its last ok
    step, at most max_det."""
    n_ok = ok.reshape(-1, ok.shape[-1]).sum(-1)
    return min(int(n_ok.max()) + 1, ok.shape[-1])


def time_shape(rng, kernel: str, B: int, K: int, clusters, iters: int):
    if kernel == "K3":
        args, fn = rotated_inputs(rng, B, K), nk.nms_rotated_batched_cuda
    else:
        c, m = nms_inputs(rng, B, K, 1024.0 if K == K_OBB else 640.0)
        args, fn = (c, m), nk.nms_select_batched_cuda
        if kernel == "K2":
            args, fn = (c[0], m[0]), nk.nms_select_cuda
    rows = []
    for cluster in clusters:
        forced = {} if cluster is None else {"cluster": cluster}
        try:
            _, ok = fn(*args, IOU, MAX_DET, **forced)
        except ValueError:
            if cluster is None:
                raise
            continue                           # this size cannot hold K
        steps = steps_run(ok)
        ms = cuda_ms(lambda: fn(*args, IOU, MAX_DET, **forced), iters)
        rows.append(dict(kernel=kernel, B=B, K=K, cluster=cluster, ms=ms,
                         steps=steps, us_per_step=1e3 * ms / steps))
        print(f"{kernel} B={B} K={K} cluster="
              f"{'plan' if cluster is None else cluster}: {ms:.4f} ms, "
              f"{steps} steps, {1e3 * ms / steps:.3f} us a step", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    help="KERNEL:BxK, KERNEL one of K1, K2, K3")
    ap.add_argument("--clusters", action="store_true",
                    help="also force each cluster size that holds the shape")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--json", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_times: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    clusters = (None, 1, 2, 4, 8) if a.clusters else (None,)
    rows = []
    for shape in a.shapes:
        kernel, _, bk = shape.partition(":")
        B, K = (int(v) for v in bk.split("x"))
        rows += time_shape(rng, kernel, B, K, clusters, a.iters)
    out = {"card": smi, "iou": IOU, "max_det": MAX_DET, "rows": rows}
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
