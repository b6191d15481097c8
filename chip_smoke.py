#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (xrseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as it finishes:

1. device: the card's name and power limit as nvidia-smi gives them, the
   torch and CUDA versions, and the seconds the nvcc build of
   xrseg_tpu_torch/csrc/ took (one nvcc per source, all started together;
   with ptxas's register/shared-memory report).
2. kernels, each against its plain torch version on the same card and
   inputs, and timed with CUDA events beside its plain version and its
   bound:
   - K1 (nms_select_batched_cuda) at B = 1, 8, 32, 128 with K = 8400 (the
     640x640 anchors; B = 128 is the launch plan's one-block-per-image
     end) and at B = 1, 8 with K = 21504 (the 1024x1024 anchors), and K2
     (nms_select_cuda) at K = 8400 and at a pre_topk-compacted K = 1024,
     on numpy-seeded inputs with bf16-quantised (tied) scores, below-gate
     candidates, zero-area boxes and an all-below-gate image. idx and ok
     must EQUAL the plain version's.
   - K3 (nms_rotated_batched_cuda) at K = 21504, B = 1, 8, 32, on rotated
     boxes with bf16-tied scores, zero-width boxes, thin near-parallel
     pairs and an all-below-gate image: idx and ok must EQUAL the plain
     version's.
   - Each NMS line names the cluster size (blocks per image) the launch
     plan chose and the microseconds per greedy step run. Then, per
     kernel, every cluster size 1, 2, 4, 8 forced at ragged K (8399, 8199,
     21503; B = 3 with an empty last image): idx and ok must EQUAL the
     plain version's, and a size whose blocks cannot hold K must raise.
     A K beyond the plan's largest must raise too.
   - K4 (mask_synth_crop_cuda) at B = 8, D = 50, 32 prototypes at 160x160
     on seeded inputs: the zeroed pixels must equal the plain version's
     and the values lie within 1e-5. Also timed beside the library
     formulation torch.sigmoid(coefs @ protos.T) + crop.
3. segment pipeline: YOLO11n-seg at full width (640x640, 80 classes, 32
   protos at 160x160, 8400 anchors, max_det 50) with detection_params
   weights, on 480x640 uint8 frames (stretch): build_pipeline at b=1 and
   b=8, once with emit_masks="none", and the b=1 postprocess() entry
   point. Launch counters are zeroed just before these runs and read just
   after: K1 and K2 must both have launched. Every slate must hold 50
   finite detections and equal the same pipeline built with
   nms_backend="scan". Then b=1 p50 latency and b=8 frames/s, each timed
   from host frames to a host copy of the slate. K4 is then checked on
   the coefs, protos and boxes of a coefs-only b=8 run of this path.
4. obb pipeline: YOLO11n-obb at full width (1024x1024, 15 classes, the
   angle branch, 21504 anchors, max_det 50) with detection_params
   weights, on 1024x1024 uint8 frames: build_pipeline at b=1 and b=8.
   Launch counters are zeroed just before these runs and read just after:
   K3 must have launched. Every slate must hold 50 finite detections and
   equal postprocess_obb_batch(backend="scan") on the same raw outputs.
   Then b=1 p50 latency and b=8 frames/s.
5. one line {"kernels": [...]} (K1-K4; launches are counted on the path
   that runs each kernel; no path runs K4, as in the JAX package), then
   the last line
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
from xrseg_tpu_torch.compile import build_pipeline, decode_task_outputs, pack_slate
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.nms_times import (GATE, IOU, MAX_DET, cuda_ms, nms_inputs,
                                       rotated_inputs, steps_run)
from xrseg_tpu_torch.ops import mask_kernels as mk
from xrseg_tpu_torch.ops import masks as mask_ops
from xrseg_tpu_torch.ops import nms as nms_ops
from xrseg_tpu_torch.ops import nms_kernels as nk
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops.postprocess import postprocess, postprocess_obb_batch
from xrseg_tpu_torch.testing import detection_params

# H100 SXM data sheet: HBM rate, and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# per candidate per greedy step: the argmax compare, the IoU row (min, max,
# sub, clamp, mul for the overlap; sub, clamp, mul for the area; add, sub,
# div for the union and ratio) and the suppression test
OPS_PER_CANDIDATE_STEP = 20
# K3, per live candidate per step: the probIoU row (3 sums, 2 differences;
# the denominator 2 mul, sub, clamp, add; t1 2 squares, 2 mul, add, div,
# mul; t2 sub, 2 mul, div, mul; t3 mul, clamp, sqrt, mul, add, div, add,
# log, mul; bd 2 add, clamp; iou neg, exp, sub, add, sqrt, sub), the
# suppression test and the skip test; plus, for every candidate, the
# argmax compare
OPS_PER_LIVE_ROTATED = 43
DEVICE = "cuda"
# the segment path: YOLO11n-seg at full width on 480x640 camera frames
MODEL = ModelConfig()                 # 640x640, 80 classes, 32 protos
FRAME_HW = (480, 640)
# the obb path: YOLO11n-obb (yolo11-obb.yaml at scale n, DOTAv1's 15
# classes) at its 1024x1024 input, on 1024x1024 frames
OBB_MODEL = ModelConfig(task="obb", num_classes=15, input_size=(1024, 1024))
OBB_FRAME_HW = (1024, 1024)
K1_BATCHES = (1, 8, 32, 128)
K_ONCE = 128                          # from this B on the plain loop runs once
# (kernel, K) of the forced-cluster cases: ragged slices at every size
FORCED = (("K1", 8399), ("K1", 21503), ("K2", 8399), ("K3", 8199),
          ("K3", 21503))
K1_WIDE_BATCHES = (1, 8)
K3_BATCHES = (1, 8, 32)
K_FULL, K_COMPACT = 8400, 1024
K_OBB = OBB_MODEL.num_anchors         # 21504
K4_SHAPE = dict(B=8, D=MAX_DET, nm=MODEL.num_masks, hw=MODEL.mask_size)
SOURCE = "xrseg_tpu_torch/csrc/nms_select.cu"
K1 = dict(name="nms_select_batched_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:218")
K2 = dict(name="nms_select_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:125")
K3 = dict(name="nms_rotated_batched_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/nms_rotated.cu",
          replaces="xrseg_tpu/ops/pallas_kernels.py:420")
K4 = dict(name="mask_synth_crop_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/mask_synth_crop.cu",
          replaces="xrseg_tpu/ops/pallas_kernels.py:297",
          launches_note="no path of build_pipeline runs K4: as in the JAX "
                        "package, the pipeline keeps the unfused "
                        "synthesize_masks + crop_masks formulation")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(n_bytes: float, n_ops: float):
    """The least time for the work: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
          f"{len(paths)} sources in parallel)", flush=True)
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "bytes stack" in line:
                print(f"device: ptxas {name}: {line.strip()}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def nms_bound(ok: torch.Tensor, K: int):
    """Least time for the work these inputs need: each image's data read
    once and its slate written once; the steps the loop runs (until the
    first non-ok step) over K candidates."""
    B = ok.shape[0]
    steps = sum(min(int(n) + 1, MAX_DET) for n in ok.sum(-1).tolist())
    return bound(B * K * 5 * 4 + B * MAX_DET * 5,
                 steps * K * OPS_PER_CANDIDATE_STEP)


def rotated_bound(rows: torch.Tensor, masked: torch.Tensor):
    """Least time for the work K3 does on these inputs: the rows and scores
    read once, the slate written once; per step that runs, the argmax over
    all K and the probIoU row over the candidates still live (the kernel
    skips the rest), as the plain loop replays it."""
    B, K = masked.shape
    ops = 0
    active = torch.ones(B, dtype=torch.bool, device=masked.device)
    for _, ok, m in nk.rotated_steps(rows, masked, IOU, MAX_DET):
        ok = ok[:, 0] & active                 # an image exits at its first
        live = (m > nk.NEG * 0.5).sum(-1)      # non-ok step
        ops += int(active.sum()) * K \
            + int(torch.where(ok, live, 0).sum()) * OPS_PER_LIVE_ROTATED
        active = ok
        if not bool(active.any()):
            break
    return bound(B * K * 7 * 4 + B * MAX_DET * 5, ops)


def plan_cluster(what: str, masked: torch.Tensor) -> int:
    """The cluster size launch_plan chooses for these scores on this card."""
    B, K = masked.reshape(-1, masked.shape[-1]).shape
    return nk.launch_plan(what, B, K, *nk.device_limits(what, masked.device))[0]


def event_ms(fn):
    """fn()'s result and the device time of that one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_case(kernel, plain, args, label: str, what: str, bound_fn,
             iters: int = 50, plain_once: bool = False):
    idx, ok = kernel(*args, IOU, MAX_DET)
    (ref_idx, ref_ok), plain_ms = event_ms(lambda: plain(*args, IOU, MAX_DET))
    torch.cuda.synchronize()
    check(torch.equal(idx, ref_idx) and torch.equal(ok, ref_ok),
          f"{label}: kernel idx/ok differ from the plain version")
    err = max(float((idx - ref_idx).abs().max()),
              float((ok.int() - ref_ok.int()).abs().max()))
    ms = cuda_ms(lambda: kernel(*args, IOU, MAX_DET), iters)
    if not plain_once:
        plain_ms = cuda_ms(lambda: plain(*args, IOU, MAX_DET), 3, 1)
    bound_ms, bound_by = bound_fn(ok.reshape(-1, MAX_DET))
    steps = steps_run(ok)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                cluster=plan_cluster(what, args[1]), steps=steps,
                us_per_step=1e3 * ms / steps,
                n_ok=ok.reshape(-1, MAX_DET).sum(-1).tolist())
    n_ok = case["n_ok"] if len(case["n_ok"]) <= 32 else \
        f"{min(case['n_ok'])}..{max(case['n_ok'])} over {len(case['n_ok'])}"
    print(f"kernels: {label}: equal, cluster {case['cluster']}, {ms:.4f} ms, "
          f"{case['us_per_step']:.3f} us a step over {steps} steps (plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}), "
          f"ok per image {n_ok}", flush=True)
    return case


def forced_cluster_cases(rng) -> None:
    """Every cluster size forced at ragged K: equal to the plain version
    where the size's blocks hold K, refused where they do not."""
    for name, K in FORCED:
        if name == "K3":
            args = rotated_inputs(rng, 3, K)
            kernel, plain = (nk.nms_rotated_batched_cuda,
                             nk.nms_rotated_batched_torch)
        else:
            args = nms_inputs(rng, 3, K)
            kernel, plain = (nk.nms_select_batched_cuda,
                             nk.nms_select_batched_torch)
            if name == "K2":
                args = tuple(a[0] for a in args)
                kernel, plain = nk.nms_select_cuda, nk.nms_select_torch
        ref = plain(*args, IOU, MAX_DET)
        ran, refused = [], []
        for cluster in nk.CLUSTER_SIZES:
            try:
                got = kernel(*args, IOU, MAX_DET, cluster=cluster)
            except ValueError as e:
                check("cannot hold" in str(e)
                      and cluster < nk.CLUSTER_SIZES[-1],
                      f"{name} K={K} cluster {cluster}: refused: {e}")
                refused.append(cluster)
                continue
            torch.cuda.synchronize()
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"{name} K={K} forced cluster {cluster}: idx/ok differ "
                  "from the plain version")
            ran.append(cluster)
        print(f"kernels: {name} K={K} forced clusters {ran}: equal"
              + (f"; {refused} refused (the blocks cannot hold K)"
                 if refused else ""), flush=True)


def refusal_cases() -> None:
    """A K beyond the launch plan's largest must raise, not launch."""
    for what, kernel, shape in (
            ("nms_select", nk.nms_select_batched_cuda, lambda K: (1, K, 4)),
            ("nms_rotated", nk.nms_rotated_batched_cuda, lambda K: (1, 6, K))):
        K = nk.max_candidates(what, torch.device(DEVICE)) + 1
        geo = torch.zeros(shape(K), device=DEVICE)
        masked = torch.zeros((1, K), device=DEVICE)
        before = kernel.launches
        try:
            kernel(geo, masked, IOU, MAX_DET)
        except ValueError as e:
            check(f"limit of {K - 1} " in str(e),
                  f"{what}: the refusal does not name the limit: {e}")
        else:
            raise SmokeFailure(f"{what}: K={K} beyond the largest was taken")
        check(kernel.launches == before, f"{what}: a refused call counted")
        print(f"kernels: {what} refuses K={K} (largest {K - 1})", flush=True)


def phase_nms_kernels():
    rng = np.random.default_rng(0)
    k1_cases, k2_cases, k3_cases = {}, {}, {}
    for K, batches, extent in ((K_FULL, K1_BATCHES, 640.0),
                               (K_OBB, K1_WIDE_BATCHES, 1024.0)):
        for B in batches:
            c, m = nms_inputs(rng, B, K, extent)
            k1_cases[B, K] = run_case(
                nk.nms_select_batched_cuda, nk.nms_select_batched_torch,
                (c, m), f"K1 B={B} K={K}", "nms_select",
                lambda ok, K=K: nms_bound(ok, K), plain_once=B >= K_ONCE)
    for K in (K_FULL, K_COMPACT):
        c, m = nms_inputs(rng, 1, K)
        k2_cases[K] = run_case(nk.nms_select_cuda, nk.nms_select_torch,
                               (c[0], m[0]), f"K2 K={K}", "nms_select",
                               lambda ok, K=K: nms_bound(ok, K))
    for B in K3_BATCHES:
        rows, m = rotated_inputs(rng, B, K_OBB)
        k3_cases[B] = run_case(
            nk.nms_rotated_batched_cuda, nk.nms_rotated_batched_torch,
            (rows, m), f"K3 B={B} K={K_OBB}", "nms_rotated",
            lambda ok, rows=rows, m=m: rotated_bound(rows, m), iters=20)
    forced_cluster_cases(rng)
    refusal_cases()
    # the main paths' shapes: K1 at b=8 and K2 at the full anchor count of
    # the segment path, K3 at b=8 of the obb path
    return [dict(K1, main=k1_cases[8, K_FULL], cases=list(k1_cases.values())),
            dict(K2, main=k2_cases[K_FULL], cases=list(k2_cases.values())),
            dict(K3, main=k3_cases[8], cases=list(k3_cases.values()))]


def k4_library(coefs, protos, boxes, mask_hw, input_size):
    """The library formulation: one batched matmul, sigmoid, crop."""
    B, h, w, nm = protos.shape
    logits = coefs @ protos.reshape(B, h * w, nm).transpose(1, 2)
    return mask_ops.crop_masks(torch.sigmoid(logits).reshape(B, -1, h, w),
                               boxes, input_size)


def k4_case(coefs, protos, boxes, label: str, iters: int = 50):
    """K4 against its plain version (exact crop, values within 1e-5), timed
    beside the plain version and the library formulation."""
    args = (coefs, protos, boxes, MODEL.mask_size, MODEL.input_size)
    got = mk.mask_synth_crop_cuda(*args)
    ref = mk.mask_synth_crop_torch(*args)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and torch.equal(got == 0, ref == 0),
          f"{label}: K4 zeroes other pixels than the plain version")
    err = float((got - ref).abs().max())
    check(err <= 1e-5, f"{label}: K4 differs from the plain version by "
                       f"{err:.3e} > 1e-5")
    ms = cuda_ms(lambda: mk.mask_synth_crop_cuda(*args), iters)
    plain_ms = cuda_ms(lambda: mk.mask_synth_crop_torch(*args), iters)
    library_ms = cuda_ms(lambda: k4_library(*args), iters)
    B, D, nm = coefs.shape
    hw = protos.shape[1] * protos.shape[2]
    bound_ms, bound_by = bound(
        4 * B * (D * nm + hw * nm + D * 4) + 4 * B * D * hw,
        B * D * hw * (2 * nm + 8))            # + sigmoid (3) + crop (5)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                inside_share=float((ref != 0).float().mean()))
    print(f"kernels: {label}: crop equal, max |err| {err:.2e}, {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by})", flush=True)
    return case


def phase_k4_seeded():
    rng = np.random.default_rng(1)
    B, D, nm, (h, w) = (K4_SHAPE[k] for k in ("B", "D", "nm", "hw"))
    H, W = MODEL.input_size
    coefs = rng.standard_normal((B, D, nm)).astype(np.float32)
    protos = rng.standard_normal((B, h, w, nm)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 1, (B, D, 2)) * [W, H],
                            rng.uniform(0.02, 0.6, (B, D, 2)) * [W, H]],
                           -1).astype(np.float32)
    boxes[:, 0] = [8 * W / w, 6 * H / h, 4 * W / w, 4 * H / h]  # on centres
    args = [torch.from_numpy(a).to(DEVICE) for a in (coefs, protos, boxes)]
    case = k4_case(*args, f"K4 seeded B={B} D={D} {nm}x{h}x{w}")
    return dict(K4, main=case, cases=[case])


# ---------------------------------------------------------------------------
# 3. the segment path
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


def host_ms(pipe, x, iters):
    """Per-call host times: host frames in, host copy of the slate out."""
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pipe(x)["slate"].cpu()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_segment():
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
    zero_counters()
    runs = {}
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        for f in range(3):
            runs[name] = pipe(frames[f:f + B] if B == 1 else frames)
    runs["postprocess_b1"] = b1_postprocess(cfg.post)
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"pipeline: segment: launches on the path {launches}", flush=True)
    for k in (K1, K2):
        check(launches[k["name"]] > 0, f"{k['name']} never launched on the "
                                       "segment path")

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
    name = torch.cuda.get_device_name(0)
    b1 = host_ms(kern["b1"], frames[:1], 30)
    b1_scan = host_ms(plain["b1"], frames[:1], 20)
    b8 = host_ms(kern["b8"], frames, 15)
    print(f"pipeline: segment b=1 p50 {statistics.median(b1):.3f} ms "
          f"(p95 {np.percentile(b1, 95):.3f} ms; with nms_backend='scan' "
          f"p50 {statistics.median(b1_scan):.3f} ms) on {name}", flush=True)
    print(f"pipeline: segment b=8 {8 * 1e3 / statistics.mean(b8):.1f} "
          f"frames/s (mean {statistics.mean(b8):.3f} ms per batch) on {name}",
          flush=True)

    # --- a coefs-only b=8 run: K4's inputs as the segment path makes them
    det = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=8,
                         emit_masks="none", device=DEVICE)(frames)
    check_det(det, 8, False, "b8_none")
    return det, launches


# ---------------------------------------------------------------------------
# 4. the obb path
# ---------------------------------------------------------------------------

def check_obb_det(det, B: int, what: str) -> None:
    check(det["count"].shape == (B,) and bool((det["count"] == MAX_DET).all()),
          f"{what}: count {det['count'].tolist()} != {MAX_DET}")
    check(tuple(det["boxes_xywhr"].shape) == (B, MAX_DET, 5)
          and bool(det["boxes_xywhr"].isfinite().all()),
          f"{what}: bad boxes_xywhr")
    check(det["slate"].shape == (B, MAX_DET * 8 + 1)
          and bool(det["slate"].isfinite().all()), f"{what}: bad slate")


def phase_obb() -> dict:
    cfg = ExecutorConfig(model=OBB_MODEL)
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    frames = np.random.default_rng(2).integers(
        0, 256, (8,) + OBB_FRAME_HW + (3,), np.uint8)
    kern = {n: build_pipeline(cfg, model, frame_hw=OBB_FRAME_HW, batch=b,
                              device=DEVICE).warmup()
            for n, b in (("b1", 1), ("b8", 8))}

    # --- the main path, with the launch counters zeroed around it
    zero_counters()
    runs, last = {}, {}
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        for f in range(3):
            last[name] = frames[f:f + B] if B == 1 else frames
            runs[name] = pipe(last[name])
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"pipeline: obb: launches on the path {launches}", flush=True)
    check(launches[K3["name"]] > 0, f"{K3['name']} never launched on the "
                                    "obb path")

    # --- the scan comparison on the same raw outputs
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        check_obb_det(runs[name], B, f"obb {name}")
        x = pre_ops.preprocess(torch.from_numpy(last[name]).to(DEVICE),
                               OBB_MODEL.input_size, dtype=model.dtype)
        with torch.inference_mode():
            out = model(x, concat_preds=False)
            det = decode_task_outputs(out, cfg.model, cfg.post)
            ref = postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                        cfg.post, scores_are_logits=True,
                                        backend="scan")
        check(torch.equal(det["slate"], pack_slate(ref, MAX_DET)),
              f"obb {name}: slate differs from postprocess_obb_batch("
              "backend='scan') on the same raw outputs")
        check(torch.equal(runs[name]["slate"], det["slate"]),
              f"obb {name}: the pipeline's slate differs from its parts' run")
        print(f"pipeline: obb {name}: 50/50 detections per image, slate "
              "equal to postprocess_obb_batch(backend='scan')", flush=True)

    name = torch.cuda.get_device_name(0)
    b1 = host_ms(kern["b1"], frames[:1], 30)
    b8 = host_ms(kern["b8"], frames, 15)
    print(f"pipeline: obb b=1 p50 {statistics.median(b1):.3f} ms "
          f"(p95 {np.percentile(b1, 95):.3f} ms) on {name}", flush=True)
    print(f"pipeline: obb b=8 {8 * 1e3 / statistics.mean(b8):.1f} frames/s "
          f"(mean {statistics.mean(b8):.3f} ms per batch) on {name}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# launch counters and the kernel line
# ---------------------------------------------------------------------------

WRAPPERS = (nk.nms_select_batched_cuda, nk.nms_select_cuda,
            nk.nms_rotated_batched_cuda, mk.mask_synth_crop_cuda)


def zero_counters() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def read_counters() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


CASE_KEYS = ("case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "cluster", "steps", "us_per_step")


def kernel_line(kernels) -> dict:
    rows = []
    for k in kernels:
        m = k["main"]
        rows.append(dict(
            name=k["name"], route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=k["launches"],
            max_abs_err=max(c["max_abs_err"] for c in k["cases"]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m.get("library_ms"),
            shape=m["case"],
            check=("crop equal to the plain version, values within 1e-5"
                   if k["name"] == K4["name"] else
                   "idx/ok equal to the plain version in every case"),
            **({"launches_note": k["launches_note"]}
               if "launches_note" in k else {}),
            cases=[{key: c[key] for key in CASE_KEYS if key in c}
                   for c in k["cases"]]))
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        phase_device()
        kernels = phase_nms_kernels() + [phase_k4_seeded()]
        det, seg = phase_segment()
        kernels[-1]["cases"].append(k4_case(
            det["coefs"].contiguous(), det["protos"].contiguous(),
            det["boxes_xywh"].contiguous(), "K4 segment path b=8 coefs-only"))
        obb = phase_obb()
        # each kernel's count on the path that runs it; K4 runs on none
        for k in kernels:
            k["launches"] = (obb if k["name"] == K3["name"] else seg)[k["name"]]
        kernels[-1]["launches"] = seg[K4["name"]] + obb[K4["name"]]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(kernel_line(kernels)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
