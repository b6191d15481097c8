"""Interactive Executor probe: the L3 state machine on the card (the port's
tools/executor_probe.py).

Drives the interactive loop, SyntheticCameraSource -> run_inference ->
update() ticks, on YOLO11n-seg with random weights from seed 0, and
reports:

  - per-frame completed latency (dispatch -> SUCCESS), p50/p95
  - interactive frames/sec sustained by the tick loop
  - ticks spent in RUNNING before the readiness poll flipped; the poll is
    the query() of a CUDA event recorded behind the frame's last kernel
    (device.Readback.computed). 0 ticks everywhere means the event was
    done at the first poll, so the latency is paid elsewhere. On
    device="cpu" the poll is true at once, so these are 0 by design.
  - time split: RUNNING-poll wait vs readback materialization

    python -m xrseg_tpu_torch.tools.executor_probe [n_frames] \\
        [--warmup 8] [--device cuda]

Output: one JSON line (plus a human-readable summary on stderr).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", type=int, nargs="?", default=60)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_frames, warmup = args.n_frames, args.warmup

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.runtime.executor import ExecState, Executor
    from xrseg_tpu_torch.runtime.frame_source import SyntheticCameraSource

    frame_hw = (480, 640)
    cfg = ExecutorConfig(model=ModelConfig(scale="n"))
    t0 = time.perf_counter()
    ex = Executor(cfg, frame_hw=frame_hw, seed=0, device=args.device)
    load_s = time.perf_counter() - t0
    platform = ex.device.type

    src = SyntheticCameraSource(frame_hw=frame_hw,
                                max_frames=n_frames + warmup + 4)
    frames = src.frames()

    lat, run_ticks_hist, run_wait_s, readback_s = [], [], [], []
    done = 0
    t_loop0 = None
    while done < n_frames + warmup:
        frame = next(frames)
        assert ex.run_inference(frame)
        ticks = 0
        t_run0 = time.perf_counter()
        t_ready = None
        while True:
            r = ex.update()
            if ex.state == ExecState.REQUESTING_OUTPUTS and t_ready is None:
                t_ready = time.perf_counter()
            if r is not None:
                ex.update()       # CLEANUP -> COMPLETED
                break
            if ex.state == ExecState.COMPLETED:
                raise RuntimeError("executor ERROR state")
            if ex.state == ExecState.RUNNING:
                ticks += 1
        done += 1
        if done == warmup:
            t_loop0 = time.perf_counter()
        if done > warmup:
            lat.append(r.latency_s)
            run_ticks_hist.append(ticks)
            run_wait_s.append((t_ready or t_run0) - t_run0)
            readback_s.append(time.perf_counter() - (t_ready or t_run0))
    elapsed = time.perf_counter() - t_loop0

    out = {
        "platform": platform,
        "frame_hw": list(frame_hw),
        "n_frames": n_frames,
        "load_s": round(load_s, 1),
        "interactive_fps": round(n_frames / elapsed, 1),
        "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "p95_latency_ms": round(float(np.percentile(lat, 95)) * 1e3, 2),
        "running_ticks_p50": int(np.percentile(run_ticks_hist, 50)),
        "running_ticks_max": int(np.max(run_ticks_hist)),
        "running_wait_ms_p50": round(
            float(np.percentile(run_wait_s, 50)) * 1e3, 2),
        "readback_ms_p50": round(
            float(np.percentile(readback_s, 50)) * 1e3, 2),
    }
    print(json.dumps(out), flush=True)
    poll_informative = out["running_ticks_p50"] > 0
    print(
        f"[probe] {platform}: {out['interactive_fps']} interactive fps, "
        f"p50 {out['p50_latency_ms']} ms "
        f"(poll wait {out['running_wait_ms_p50']} ms / readback "
        f"{out['readback_ms_p50']} ms). The CUDA event query() "
        + ("tracks completion" if poll_informative else
           "returns done at once: completion is only observable at the "
           "readback, so the per-frame cost lands in REQUESTING_OUTPUTS"),
        file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
