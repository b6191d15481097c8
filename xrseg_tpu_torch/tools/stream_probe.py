"""The batch path's own spans on the card: StreamingRunner at depth 2
over build_pipeline(batch=B) in a closed loop, read through the runtime's
Tracer.

The windows alternate tracer off and on (off, on, on, off, ...) in one
process, so `frames_per_s_off` against `frames_per_s_on` is what tracing
costs. The enabled windows give the batch's per-step readings from
`Tracer.export()`.

    python -m xrseg_tpu_torch.tools.stream_probe [--arch yolo11] [--scale x]
        [--batch 32] [--seconds 10] [--rounds 2] [--seed 0] [--device cuda]
        [--size N] [--out PATH]

Weights: detection_params from the seed (every anchor fires, so the NMS
sees all of them); bfloat16 compute; TEST_PRESET thresholds; 480x640
uint8 frames from the seed, four distinct batches in turn (--size N: an
NxN model on NxN frames in float32, for a CPU smoke run).

Emits ONE JSON line: the device, frames_per_s_off and frames_per_s_on
(one per window), "traced" (per enabled window: queued_batches =
queued_at_submit / batches_submitted; <span>_ms = the mean self time of
each span a batch; batch_device_ms and its p95 on the card's clock;
spans and device spans a batch), and per window, from ops/launches:
conv_epilogue_launches_per_batch (the hand-written conv epilogue's
launches a batch, which is the model's conv count when the batch goes
through the kernel, and 0 on the CPU),
conv_epilogue_channels_last_per_batch (those of them on a channels-last
output, all of them on the card) and area_attention_calls_per_batch (the
fused attention calls a batch: 16 a YOLO12x batch, 0 for YOLO11, YOLOv8
and on the CPU), upload_staged_per_batch (the batches staged through the
pipeline's pinned ring, `device.Upload`: 1 on the card, 0 on the CPU) and
slot_waits (the staged batches that waited for their slot's earlier copy
to land).
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

DEPTH = 2                  # batches queued behind the one being read


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8", "yolo12"])
    ap.add_argument("--scale", default="x")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="each timed window")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of windows (off, on, on, off, ...)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=None,
                    help="an NxN float32 model on NxN frames (CPU smoke)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.config import TEST_PRESET, ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.ops import launches
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner
    from xrseg_tpu_torch.testing import detection_params

    if args.size:
        mcfg = ModelConfig(arch=args.arch, scale=args.scale,
                           input_size=(args.size,) * 2, dtype="float32")
        frame_hw = (args.size, args.size)
    else:
        mcfg = ModelConfig(arch=args.arch, scale=args.scale,
                           dtype="bfloat16")
        frame_hw = (480, 640)
    cfg = ExecutorConfig(model=mcfg, post=TEST_PRESET.post)
    model = detection_params(torch.Generator().manual_seed(args.seed), mcfg,
                             device=args.device)
    pipe = build_pipeline(cfg, model, frame_hw=frame_hw, batch=args.batch,
                          device=args.device).warmup()
    runner = StreamingRunner(pipe, depth=DEPTH)
    rng = np.random.default_rng(args.seed)
    batches = [rng.integers(0, 256, (args.batch,) + frame_hw + (3,),
                            np.uint8) for _ in range(4)]
    window(runner, batches, 0.0, warm=2 * DEPTH + 2)
    tracer = runner.tracer

    fps = {False: [], True: []}
    traced, epilogues, epilogues_cl, attention = [], [], [], []
    staged, slot_waits = [], []
    for on in [False, True, True, False] * (args.rounds // 2) + \
            [False, True] * (args.rounds % 2):
        tracer.reset()
        tracer.enable(on)
        launches.reset()
        rate, n = window(runner, batches, args.seconds)
        fps[on].append(rate)
        counts = launches.read()
        epilogues.append(counts["conv_epilogue_cuda"] / n)
        epilogues_cl.append(counts["conv_epilogue_cuda", "channels_last"] / n)
        attention.append(counts["area_attention_cuda"] / n)
        staged.append(counts["upload_staged"] / n)
        slot_waits.append(counts["upload_staged", "slot_wait"])
        if on:
            traced.append(readings(tracer.export()))
        tracer.enable(False)

    out = {"device": (torch.cuda.get_device_name(pipe.device)
                      if pipe.device.type == "cuda" else "cpu"),
           "scale": args.scale, "batch": args.batch, "depth": DEPTH,
           "seed": args.seed, "seconds": args.seconds,
           "frames_per_s_off": fps[False], "frames_per_s_on": fps[True],
           "arch": args.arch, "traced": traced,
           "conv_epilogue_launches_per_batch": epilogues,
           "conv_epilogue_channels_last_per_batch": epilogues_cl,
           "area_attention_calls_per_batch": attention,
           "upload_staged_per_batch": staged, "slot_waits": slot_waits}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def window(runner, batches, seconds: float, warm: int = 0):
    """Submit batches in a closed loop for `seconds` (or `warm` batches),
    then drain: (frames / the time from the first submit to the last
    result, batches completed)."""
    done, i = 0, 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while (i < warm) if warm else (time.perf_counter() < t_end):
        if runner.submit(batches[i % len(batches)]) is not None:
            done += 1
        i += 1
    for _ in runner.drain():
        done += 1
    return done * batches[0].shape[0] / (time.perf_counter() - t0), done


def readings(exp: Dict) -> Dict[str, float]:
    """A StreamingRunner tracer's export -> per-batch readings."""
    c = exp["counters"]
    n = c.get("batches_submitted", 0)
    if not n:
        return {}
    self_ms: Dict[str, List[float]] = collections.defaultdict(list)
    for s in exp["spans"]:
        if s["self_ns"] is not None:
            self_ms[s["name"]].append(s["self_ns"] / 1e6)
    out = {"batches": n,
           "queued_batches": c.get("queued_at_submit", 0) / n,
           "spans_per_batch": len(exp["spans"]) / n,
           "device_spans_per_batch": len(exp["device_spans"]) / n}
    for name, v in sorted(self_ms.items()):
        out[f"{name}_ms"] = sum(v) / len(v)
    dev = [d["ms"] for d in exp["device_spans"]
           if d["name"] == "batch_device"]
    if dev:
        out["batch_device_ms"] = sum(dev) / len(dev)
        out["batch_device_p95_ms"] = float(np.percentile(dev, 95))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
