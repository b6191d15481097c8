"""Drive the FULL XR tick on the card: the reference's per-frame workload
composed end to end (the port's tools/xr_probe.py).

tools/executor_probe.py measures L3 (the inference state machine); this
probe composes L3+L4+L5+L6 the way XRScene does (IEExecutor.cs:458-526
tracking + target-mask path, :561-651 depth fusion/point-cloud):
SyntheticCameraSource frames (+ synthetic depth + pose), a scripted
controller that laser-selects the first detection, then N frames of

  dispatch -> poll -> packed-slate readback -> tracker update ->
  device-side target-mask gather -> masker SmoothDamp -> depth fusion ->
  point-cloud extraction

reporting sustained fps, per-stage latency split (executor tracer), and
per-frame point counts. Emits ONE JSON line.

    python -m xrseg_tpu_torch.tools.xr_probe --frames 120
    python -m xrseg_tpu_torch.tools.xr_probe --fused --pipelined 2
    python -m xrseg_tpu_torch.tools.xr_probe --device cpu --frames 12 \\
        --size 64

Uses the reference's deployed .sentis weights and a bundled real image as
the camera background when XRSEG_REFERENCE names the reference project's
root (a real `bus` lock); detection-guaranteeing fixture weights
(testing.detection_params from seed 0) otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from xrseg_tpu_torch.tools._donor import REF_SENTIS

REF_IMAGES = "Assets/Resources/Images"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120,
                    help="timed tracked frames after lock")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=None,
                    help="model input size override (CPU smoke)")
    ap.add_argument("--scale", default="n")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--fused", action="store_true",
                    help="transport-minimal tick (ExecutorConfig."
                         "fused_tick): device-side re-lock + mask + "
                         "depth fusion, ONE packed readback per frame")
    ap.add_argument("--pipelined", type=int, default=0, metavar="DEPTH",
                    help="run the TIMED window through PipelinedTickRunner "
                         "at this depth (requires --fused): frame N+1 "
                         "dispatches with a one-result-stale re-lock box "
                         "while frame N is still on the card, overlapping "
                         "the dispatch->ready windows")
    args = ap.parse_args(argv)
    if args.pipelined and not args.fused:
        ap.error("--pipelined requires --fused")

    import torch

    from xrseg_tpu_torch.config import XR_PRESET, ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.runtime.executor import Executor
    from xrseg_tpu_torch.runtime.frame_source import (FileFrameSource,
                                                      SyntheticCameraSource)
    from xrseg_tpu_torch.runtime.xr_loop import (XRLoop,
                                                 aim_controller_at_frame_point)

    mcfg = ModelConfig(scale=args.scale)
    if args.size:
        mcfg = ModelConfig(scale=args.scale,
                           input_size=(args.size, args.size),
                           dtype="float32")
    cfg = ExecutorConfig(model=mcfg, post=XR_PRESET.post,
                         depth=XR_PRESET.depth, enable_ui_rendering=True,
                         fused_tick=args.fused)

    params = None
    background = None
    weights = "fixture"
    ref = os.environ.get("XRSEG_REFERENCE", "")
    if ref and os.path.exists(os.path.join(ref, REF_SENTIS)) \
            and not args.size:
        from xrseg_tpu_torch.io.weights import load_params_auto
        params, mcfg = load_params_auto(os.path.join(ref, REF_SENTIS), mcfg)
        cfg = ExecutorConfig(model=mcfg, post=XR_PRESET.post,
                             depth=XR_PRESET.depth,
                             enable_ui_rendering=True,
                             fused_tick=args.fused)
        weights = "reference .sentis"
        src_bg = FileFrameSource(os.path.join(ref, REF_IMAGES),
                                 image_name="000000002006", loop=False)
        if src_bg.open():
            background = next(src_bg.frames()).rgb
    else:
        from xrseg_tpu_torch.testing import detection_params
        params = detection_params(torch.Generator().manual_seed(0), mcfg,
                                  device=args.device)

    # Unbounded camera source: one RESULT costs several readiness-poll
    # ticks (each tick consumes a frame), so any fixed frames*K budget can
    # starve the timed window. The loop breaks on RESULT count; a
    # tick-count guard below bounds runaway.
    src = SyntheticCameraSource(frame_hw=(480, 640), depth_hw=(128, 128),
                                max_frames=None, realtime=False,
                                background_rgb=background)
    max_ticks = (args.warmup + args.frames) * 2000 + 20000
    ex = Executor(cfg, params=params, frame_hw=(480, 640),
                  device=args.device)
    loop = XRLoop(ex, intrinsics=src.intrinsics)
    print(f"weights: {weights}; building + warmup...", flush=True)

    frames_iter = src.frames()
    results = 0
    locked_at = None
    timed_started = None
    point_counts = []
    lost = 0
    t_first = None
    t_last = None
    ticks = 0
    for fd in frames_iter:
        r = loop.tick(fd)
        ticks += 1
        if ticks > max_ticks:
            break
        if r is None:
            continue
        results += 1
        if t_first is None:
            t_first = time.perf_counter()
        # lock phase: laser-select the first detection (trigger edge)
        if not loop.selected and r.count > 0 and fd.pose is not None:
            b = r.boxes[0]
            frame_sp = (b.center_x + ex.screen_wh[0] / 2,
                        b.center_y + ex.screen_wh[1] / 2)
            ctl = aim_controller_at_frame_point(
                src.intrinsics, fd.pose, frame_sp, ex.screen_wh)
            ctl.trigger = True
            loop.tick(fd, ctl)
            if loop.selected:
                locked_at = results
                print(f"laser-selected target: {b.class_name} "
                      f"@ result {results}", flush=True)
        if loop.selected and locked_at is not None:
            n_after_lock = results - locked_at
            if n_after_lock == args.warmup:
                timed_started = (results, time.perf_counter())
                point_counts = []
                lost = 0
                # the published per-stage p50s cover ONLY the timed
                # window: drop the warm-up samples
                ex.tracer.reset()
                if args.pipelined:
                    break              # timed window runs pipelined below
            if n_after_lock >= args.warmup:
                if r.tracked is not None:
                    point_counts.append(
                        len(r.point_cloud.positions)
                        if r.point_cloud is not None else 0)
                else:
                    lost += 1
                t_last = time.perf_counter()
            if timed_started and results - timed_started[0] >= args.frames:
                break

    if timed_started is None:
        print(json.dumps({"metric": "xr_tick_full_loop",
                          "error": "never locked a target",
                          "results": results}), flush=True)
        return 1

    def make_row(n, secs, pts, n_lost, depth):
        stages = ex.tracer.summary()
        split = {k: round(v.get("p50_ms", 0.0), 2)
                 for k, v in stages.items()
                 if k in ("dispatch", "device_wait", "readback", "process",
                          "mask_fetch", "depth_fusion")}
        return {
            "metric": "xr_tick_full_loop_fps",
            "value": round(n / secs, 2),
            "unit": "tracked frames/sec (dispatch+slate+track+mask+"
                    "depth-fusion+pointcloud)",
            "vs_baseline": round(n / secs / 30.0, 2),
            "weights": weights,
            "frames_timed": n,
            "lost_frames": n_lost,
            "points_min": int(min(pts)) if pts else 0,
            "points_p50": int(np.median(pts)) if pts else 0,
            "stage_p50_ms": split,
            "fused_tick": bool(args.fused),
            "pipelined_depth": depth,
        }

    if args.pipelined:
        # timed windows: SAME-process A/B, depth=1 first (exactly the
        # sequential fused tick), then depth=K: one process, one build
        from xrseg_tpu_torch.runtime.streaming import PipelinedTickRunner
        rows = []
        depths = [1, args.pipelined] if args.pipelined > 1 \
            else [args.pipelined]
        for depth in depths:
            ex.tracer.reset()
            runner = PipelinedTickRunner(ex, depth=depth)
            t0 = time.perf_counter()
            t_last = t0
            n_timed = 0
            point_counts = []
            lost = 0
            for fd in frames_iter:
                r = runner.submit(fd)
                if r is None:
                    continue           # fill phase (depth-1 frames)
                n_timed += 1
                if r.tracked is not None:
                    point_counts.append(
                        len(r.point_cloud.positions)
                        if r.point_cloud is not None else 0)
                else:
                    lost += 1
                t_last = time.perf_counter()
                if n_timed >= args.frames:
                    break
            for _ in runner.drain():   # leftover in-flight, untimed
                pass
            row = make_row(n_timed, t_last - t0, point_counts, lost, depth)
            rows.append(row)
            print(json.dumps(row), flush=True)
        if args.out:
            payload = rows[-1] if len(rows) == 1 else {
                f"depth{d}": r for d, r in zip(depths, rows)}
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
        if weights == "reference .sentis":
            return 0 if (point_counts and min(point_counts) > 0) else 1
        return 0 if point_counts else 1

    elapsed = t_last - timed_started[1]
    n_timed = results - timed_started[0]
    row = make_row(n_timed, elapsed, point_counts, lost, 0)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
            f.write("\n")
    if weights == "reference .sentis":
        # the real-weights gate: every tracked frame must extract points
        return 0 if (point_counts and min(point_counts) > 0) else 1
    return 0 if point_counts else 1   # fixture smoke: loop composed + ran


if __name__ == "__main__":
    raise SystemExit(main())
