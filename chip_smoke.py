#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (xrseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as it finishes:

1. device: the card's name and power limit as nvidia-smi gives them, the
   torch and CUDA versions, and the seconds the nvcc build of
   xrseg_tpu_torch/csrc/ took (with ptxas's register/shared-memory report).
2. kernels: K1 (nms_select_batched_cuda) at B = 1, 8, 32 and K2
   (nms_select_cuda) at K = 8400 and at a pre_topk-compacted K = 1024, on
   numpy-seeded inputs with bf16-quantised (tied) scores, below-gate
   candidates, zero-area boxes and an all-below-gate image. idx and ok
   must EQUAL the plain torch version's on the same card. Each is timed
   with CUDA events beside its plain version and its bound.
3. pipeline: YOLO11n-seg at full width (640x640, 80 classes, 32 protos at
   160x160, 8400 anchors, max_det 50) with detection_params weights, on
   480x640 uint8 frames (stretch): build_pipeline at b=1 and b=8, once with
   emit_masks="none", and the b=1 postprocess() entry point. Launch counters
   are zeroed just before these runs and read just after: K1 and K2 must
   both have launched. Every slate must hold 50 finite detections and equal
   the same pipeline built with nms_backend="scan". Then b=1 p50 latency
   and b=8 frames/s, each timed from host frames to a host copy of the
   slate.
4. one line {"kernels": [...]}, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check exits non-zero before the last line. Without a CUDA
device it exits 2 and runs nothing.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.ops import nms as nms_ops
from xrseg_tpu_torch.ops import nms_kernels as nk
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops.postprocess import postprocess
from xrseg_tpu_torch.testing import detection_params

# H100 SXM data sheet: HBM rate, and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# per candidate per greedy step: the argmax compare, the IoU row (min, max,
# sub, clamp, mul for the overlap; sub, clamp, mul for the area; add, sub,
# div for the union and ratio) and the suppression test
OPS_PER_CANDIDATE_STEP = 20
MAX_DET = 50
IOU = 0.6
GATE = float(np.log(0.23 / 0.77))     # logit-space gate of score 0.23
# the run's shapes: YOLO11n-seg at full width on 480x640 camera frames
DEVICE = "cuda"
MODEL = ModelConfig()                 # 640x640, 80 classes, 32 protos
FRAME_HW = (480, 640)
K1_BATCHES = (1, 8, 32)
K_FULL, K_COMPACT = 8400, 1024
SOURCE = "xrseg_tpu_torch/csrc/nms_select.cu"
K1 = dict(name="nms_select_batched_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:218")
K2 = dict(name="nms_select_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:125")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    check(bool(smi), "nvidia-smi reported no card")
    print(smi, flush=True)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"cards {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"device: kernel build {build_s:.2f} s (nvcc, sm_90a, "
          f"{len(paths)} source(s))", flush=True)
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "bytes stack" in line:
                print(f"device: ptxas {name}: {line.strip()}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def nms_inputs(rng, B: int, K: int):
    """Card-resident corners [B,K,4] (class offset applied) and masked
    scores [B,K]: bf16-quantised logits (exact ties), about 20% of them
    below the gate, every 13th box of zero width, and, for B > 1, a last
    image entirely below the gate."""
    cxy = rng.uniform(0, 640, (B, K, 2))
    wh = rng.uniform(4, 96, (B, K, 2))
    wh[:, ::13, 0] = 0.0
    boxes = torch.from_numpy(np.concatenate([cxy, wh], -1).astype(np.float32))
    scores = torch.from_numpy(rng.normal(0.0, 1.5, (B, K)).astype(np.float32))
    scores = scores.bfloat16().float()
    if B > 1:
        scores[-1] = -10.0
    labels = torch.from_numpy(rng.integers(0, 4, (B, K)))
    corners = nms_ops.class_corners(boxes, labels, True).to(DEVICE)
    masked = torch.where(scores > GATE, scores, nk.NEG).to(DEVICE)
    return corners, masked


def nms_bound(ok: torch.Tensor, K: int):
    """Least time for the work these inputs need: each image's data read
    once and its slate written once; the steps the loop runs (until the
    first non-ok step) over K candidates."""
    B = ok.shape[0]
    steps = sum(min(int(n) + 1, MAX_DET) for n in ok.sum(-1).tolist())
    t_bytes = (B * K * 5 * 4 + B * MAX_DET * 5) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * K * OPS_PER_CANDIDATE_STEP / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_case(kernel, plain, corners, masked, K: int, label: str):
    idx, ok = kernel(corners, masked, IOU, MAX_DET)
    ref_idx, ref_ok = plain(corners, masked, IOU, MAX_DET)
    torch.cuda.synchronize()
    check(torch.equal(idx, ref_idx) and torch.equal(ok, ref_ok),
          f"{label}: kernel idx/ok differ from the plain version")
    err = max(float((idx - ref_idx).abs().max()),
              float((ok.int() - ref_ok.int()).abs().max()))
    ms = cuda_ms(lambda: kernel(corners, masked, IOU, MAX_DET), 50)
    plain_ms = cuda_ms(lambda: plain(corners, masked, IOU, MAX_DET), 5, 1)
    bound_ms, bound_by = nms_bound(ok.reshape(-1, MAX_DET), K)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                n_ok=ok.reshape(-1, MAX_DET).sum(-1).tolist())
    print(f"kernels: {label}: equal, {ms:.4f} ms (plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms by {bound_by}), "
          f"ok per image {case['n_ok']}", flush=True)
    return case


def phase_kernels():
    rng = np.random.default_rng(0)
    k1_cases, k2_cases = {}, {}
    for B in K1_BATCHES:
        c, m = nms_inputs(rng, B, K_FULL)
        k1_cases[B] = run_case(nk.nms_select_batched_cuda,
                               nk.nms_select_batched_torch, c, m, K_FULL,
                               f"K1 B={B} K={K_FULL}")
    for K in (K_FULL, K_COMPACT):
        c, m = nms_inputs(rng, 1, K)
        k2_cases[K] = run_case(nk.nms_select_cuda, nk.nms_select_torch,
                               c[0], m[0], K, f"K2 K={K}")
    # the main path's shapes: K1 at b=8 and K2 at the full anchor count
    return [dict(K1, main=k1_cases[8], cases=list(k1_cases.values())),
            dict(K2, main=k2_cases[K_FULL], cases=list(k2_cases.values()))]


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------

def check_det(det, B: int, masks: bool, what: str) -> None:
    mh, mw = MODEL.mask_size
    check(det["count"].shape == (B,) and bool((det["count"] == MAX_DET).all()),
          f"{what}: count {det['count'].tolist()} != {MAX_DET}")
    check(det["slate"].shape == (B, MAX_DET * 7 + 1)
          and bool(det["slate"].isfinite().all()), f"{what}: bad slate")
    if masks:
        check(tuple(det["masks"].shape) == (B, MAX_DET, mh, mw)
              and bool(det["masks"].isfinite().all()), f"{what}: bad masks")
    else:
        check(tuple(det["protos"].shape) == (B, mh, mw, MODEL.num_masks)
              and tuple(det["coefs"].shape) == (B, MAX_DET, MODEL.num_masks)
              and "masks" not in det, f"{what}: bad coefs-only outputs")


def phase_pipeline(kernels) -> None:
    cfg = ExecutorConfig(model=MODEL)
    scan = dataclasses.replace(
        cfg, post=dataclasses.replace(cfg.post, nms_backend="scan"))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    frames = np.random.default_rng(1).integers(
        0, 256, (8,) + FRAME_HW + (3,), np.uint8)
    specs = {"b1": (1, "all"), "b8": (8, "all"), "b1_none": (1, "none")}

    def pipes(c):
        return {n: build_pipeline(c, model, frame_hw=FRAME_HW, batch=b,
                                  emit_masks=e, device=DEVICE).warmup()
                for n, (b, e) in specs.items()}

    kern, plain = pipes(cfg), pipes(scan)

    def b1_postprocess(post):
        x = pre_ops.preprocess(torch.from_numpy(frames[:1]).to(DEVICE),
                               MODEL.input_size, dtype=model.dtype)
        with torch.inference_mode():
            out = model(x)
            return postprocess(out["preds"], out["protos"], post,
                               device=DEVICE)

    # --- the main path, with the launch counters zeroed around it
    nk.nms_select_batched_cuda.launches = 0
    nk.nms_select_cuda.launches = 0
    runs = {}
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        for f in range(3):
            runs[name] = pipe(frames[f:f + B] if B == 1 else frames)
    runs["postprocess_b1"] = b1_postprocess(cfg.post)
    torch.cuda.synchronize()
    launches = {"nms_select_batched_cuda": nk.nms_select_batched_cuda.launches,
                "nms_select_cuda": nk.nms_select_cuda.launches}
    print(f"pipeline: launches on the main path {launches}", flush=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on the main "
                                 "path")

    # --- every run against the same pipeline with the plain NMS
    for name, (B, emit) in specs.items():
        ref = plain[name](frames[2:3] if B == 1 else frames)
        check_det(runs[name], B, emit == "all", name)
        check(torch.equal(runs[name]["slate"], ref["slate"])
              and torch.equal(runs[name]["indices"], ref["indices"]),
              f"{name}: slate differs from nms_backend='scan'")
        print(f"pipeline: {name}: 50/50 detections per image, slate equal "
              "to nms_backend='scan'", flush=True)
    ref = b1_postprocess(scan.post)
    det = runs["postprocess_b1"]
    check(bool((det["count"] == MAX_DET).all())
          and tuple(det["masks"].shape) == (1, MAX_DET) + MODEL.mask_size
          and bool(det["masks"].isfinite().all()),
          "postprocess_b1: bad outputs")
    for key in ("indices", "boxes_xywh", "scores", "labels", "valid"):
        check(torch.equal(det[key], ref[key]),
              f"postprocess_b1: {key} differs from nms_backend='scan'")
    print("pipeline: postprocess_b1: 50/50 detections, equal to "
          "nms_backend='scan'", flush=True)

    # --- end-to-end timing, host frames in, host slate out
    def host_ms(pipe, x, iters):
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            pipe(x)["slate"].cpu()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    name = torch.cuda.get_device_name(0)
    b1 = host_ms(kern["b1"], frames[:1], 50)
    b1_scan = host_ms(plain["b1"], frames[:1], 50)
    b8 = host_ms(kern["b8"], frames, 20)
    print(f"pipeline: b=1 p50 {statistics.median(b1):.3f} ms "
          f"(p95 {np.percentile(b1, 95):.3f} ms; with nms_backend='scan' "
          f"p50 {statistics.median(b1_scan):.3f} ms) on {name}", flush=True)
    print(f"pipeline: b=8 {8 * 1e3 / statistics.mean(b8):.1f} frames/s "
          f"(mean {statistics.mean(b8):.3f} ms per batch) on {name}",
          flush=True)


def kernel_line(kernels) -> dict:
    rows = []
    for k in kernels:
        m = k["main"]
        rows.append(dict(
            name=k["name"], route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=k["launches"],
            max_abs_err=max(c["max_abs_err"] for c in k["cases"]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, shape=m["case"],
            check="idx/ok equal to the plain version in every case",
            cases=[{key: c[key] for key in ("case", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                   for c in k["cases"]]))
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    try:
        phase_device()
        kernels = phase_kernels()
        phase_pipeline(kernels)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        return 1
    print(json.dumps(kernel_line(kernels)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
