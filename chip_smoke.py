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
5. XR tick: the product path at full width. Two Executors on the segment
   model (emit_masks="none", 480x640 frames, a 128x128 depth plane,
   sampling_step 4), one with fused_tick (frame, re-lock, target mask and
   RGBD fusion as one program and one pinned readback on a copy stream),
   one classic (slate, then mask fetch, then fusion), each under an
   XRLoop: tick until a result, aim the controller at the first box, pull
   the trigger, check the lock, then 30 tracked ticks, fused and classic
   in turns on the same frames. Every fused tick must be tracked, carry a
   finite non-empty point cloud, and agree with the host TargetTracker on
   the same slate; classic must track the same index with the same
   points (valid equal; positions within one depth texel of the plane,
   2e-2 m, and all but 1% of them within 1e-4 m: the classic box goes
   through screen space and back, which can move a truncated depth index
   by one). K1's launches over the fused ticks must equal the dispatches.
   One tick runs from its uploads to its queued readback under torch's
   sync debug mode "error" (no operation may wait for the card); its
   packed output must equal its parts run apart on the card bit for bit, and extract_points must agree with extract_points_numpy
   (valid equal, positions within 1e-5 m). Prints tick p50/p95 and the
   tracer's per-stage means for both.
6. one line {"kernels": [...]} (K1-K4; launches are counted on the path
   that runs each kernel, K1's over the segment path plus the fused
   ticks; no path runs K4, as in the JAX package), then the last line
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
from xrseg_tpu_torch.compile import (build_pipeline, build_xr_tick_pipeline,
                                     decode_task_outputs, pack_slate)
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.nms_times import (GATE, IOU, MAX_DET, cuda_ms, nms_inputs,
                                       rotated_inputs, steps_run)
from xrseg_tpu_torch.ops import depth_fusion as df
from xrseg_tpu_torch.ops import mask_kernels as mk
from xrseg_tpu_torch.ops import masks as mask_ops
from xrseg_tpu_torch.ops import nms as nms_ops
from xrseg_tpu_torch.ops import nms_kernels as nk
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops.postprocess import postprocess, postprocess_obb_batch
from xrseg_tpu_torch.ops.relock import relock_match
from xrseg_tpu_torch.perception.tracking import (TargetTracker,
                                                 box_to_model_space)
from xrseg_tpu_torch.precision import precision_scope
from xrseg_tpu_torch.runtime.executor import Executor
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.xr_loop import (ControllerState, XRLoop,
                                             aim_controller_at_frame_point)
from xrseg_tpu_torch.testing import detection_params, xr_frames

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
# the XR tick: the segment model on the same frames, with a depth frame
DEPTH_HW = (128, 128)
N_TICKS = 30
TICK_DEADLINE_S = 60.0
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
          f"{bound_ms:.5f} ms by {bound_by}); "
          f"{case['inside_share']:.1%} of the values inside their box",
          flush=True)
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
# 5. the XR tick
# ---------------------------------------------------------------------------

def tick_until_result(loop: XRLoop, frame, controller=None):
    """Feed `frame` and poll the loop until its result: (result, ms). The
    controller snapshot is handled once, on the first call."""
    t0 = time.perf_counter()
    result = loop.tick(frame, controller)
    while result is None:
        check(time.perf_counter() - t0 < TICK_DEADLINE_S,
              f"no result within {TICK_DEADLINE_S:.0f} s "
              f"(state {loop.executor.state})")
        result = loop.tick(frame)
    return result, (time.perf_counter() - t0) * 1e3


def start_tracking(loop: XRLoop, frames) -> None:
    """First result, then aim at its first box and pull the trigger."""
    ex = loop.executor
    first, _ = tick_until_result(loop, frames[0])
    check(first.count == MAX_DET, f"first tick: {first.count} detections")
    b = first.boxes[0]
    w, h = ex.screen_wh
    ctl = aim_controller_at_frame_point(
        frames[1].intrinsics, frames[1].pose,
        (b.center_x + w / 2, b.center_y + h / 2), (w, h))
    ctl.trigger = True
    tick_until_result(loop, frames[1], ctl)
    check(loop.selected and ex.is_tracking and loop.laser_visible,
          "the trigger did not lock a target")


def release_and_reset(loop: XRLoop) -> None:
    """Trigger released and B pressed, on a tick without a camera image."""
    loop.tick(FrameData(rgb=None), ControllerState(button_b=True))
    check(not loop.executor.is_tracking and not loop.laser_visible,
          "the B button did not reset tracking")


def check_tracked(ex: Executor, prev_locked, r, what: str) -> None:
    """A tracked tick: target set, cloud finite and non-empty, and the
    match equal to the host tracker's on the same slate."""
    check(r.tracked is not None, f"{what}: target lost")
    pc = r.point_cloud
    check(pc is not None and len(pc.positions) > 0
          and bool(np.isfinite(pc.positions).all())
          and bool(np.isfinite(pc.depths).all()),
          f"{what}: empty or non-finite point cloud")
    oracle = TargetTracker(ex.cfg.tracking_gate_px, ex.cfg.select_margin_px)
    oracle.locked_box, oracle.is_tracking = prev_locked, True
    want = oracle.update(r.boxes)
    check(want is not None and want.index == r.tracked.index,
          f"{what}: tracked index {r.tracked.index}, the host tracker says "
          f"{None if want is None else want.index}")


def stage_means(ex: Executor) -> str:
    s = ex.tracer.summary()
    return ", ".join(f"{k} {s[k]['mean_ms']:.3f} (x{s[k]['count']})"
                     for k in ("dispatch", "device_wait", "readback",
                               "process", "mask_fetch", "depth_fusion")
                     if k in s)


def check_packed_parts(cfg, model, frame, locked) -> None:
    """One tick's packed output against its parts, each run apart on the
    card and read back on its own: equal bit for bit. Then the fusion
    against the numpy oracle."""
    tick = build_xr_tick_pipeline(cfg, model, frame_hw=FRAME_HW,
                                  depth_hw=DEPTH_HW, device=DEVICE)
    plain = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=1,
                           emit_masks="none", device=DEVICE)
    size = tuple(map(float, MODEL.input_size))
    w, h = float(FRAME_HW[1]), float(FRAME_HW[0])
    cx, cy, _, _ = box_to_model_space(locked, (w, h), size)
    intr, pose = frame.intrinsics, frame.pose
    aux = tick.pack_aux(intr.focal_length, intr.principal_point,
                        intr.resolution, pose.position, pose.rotation,
                        (cx, cy, float(locked.label), 1.0),
                        (w / size[1], h / size[0]))
    x = torch.from_numpy(frame.rgb[None]).to(DEVICE)
    a = torch.from_numpy(aux).to(DEVICE)
    depth = df.depth_bits(frame.depth_fp16, DEVICE)
    # from the uploads to the queued copy the host only queues work: any
    # operation that waits for the card raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tick.run(x, depth, a)
        tick.readback.start(out["packed"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tick.readback.wait()
    packed = torch.from_numpy(tick.readback.host().copy())
    check(torch.equal(packed, out["packed"].cpu()),
          "the pinned readback differs from packed.cpu()")
    got = tick.unpack(packed)
    print("tick: no operation between the uploads and the queued readback "
          "waits for the card (sync debug mode 'error'); the pinned buffer "
          "equals packed.cpu()", flush=True)

    det = plain(frame.rgb[None])
    dcfg = cfg.depth
    with torch.inference_mode(), precision_scope(MODEL.matmul_precision):
        boxes = det["boxes_xywh"][0]
        matched, idx = relock_match(boxes, det["labels"][0], det["valid"][0],
                                    a[13:17], a[17:19],
                                    gate_px=cfg.tracking_gate_px)
        mask = mask_ops.synthesize_one_mask(det["coefs"][0], det["protos"][0],
                                            idx)
        box = mask_ops.select_row(boxes, idx)
        pts = df.extract_points(
            depth, mask, box, a[0:2], a[2:4], a[4:6], a[6:9], a[9:13],
            confidence_threshold=dcfg.confidence_threshold,
            min_depth=dcfg.min_depth_m, max_depth=dcfg.max_depth_m,
            sampling_step=dcfg.sampling_step, mask_hw=MODEL.mask_size)
    check(bool(matched.cpu()) and bool(got["matched"]),
          "packed vs parts: the tick did not match its target")
    parts = torch.cat([det["slate"][0].cpu(),
                       torch.stack([matched.float(), idx.float()]).cpu(),
                       mask.reshape(-1).cpu(),
                       pts["packed"].reshape(-1).cpu()])
    check(packed.shape == parts.shape and torch.equal(packed, parts),
          "packed differs from its parts run apart on the card")
    print(f"tick: packed [{packed.numel()}] equals slate | relock_match | "
          "synthesize_one_mask | extract_points run apart, bit for bit",
          flush=True)

    ref = df.extract_points_numpy(
        frame.depth_fp16, mask.cpu().numpy(), box.cpu().numpy(),
        intr.focal_length, intr.principal_point, intr.resolution,
        pose.position, pose.rotation,
        confidence_threshold=dcfg.confidence_threshold,
        min_depth=dcfg.min_depth_m, max_depth=dcfg.max_depth_m,
        sampling_step=dcfg.sampling_step)
    valid = pts["valid"].cpu().numpy()
    err = float(np.abs(pts["positions"].cpu().numpy()
                       - ref["positions"]).max())
    check(np.array_equal(valid, ref["valid"]) and valid.any(),
          "extract_points: valid differs from extract_points_numpy")
    check(err <= 1e-5, f"extract_points differs from extract_points_numpy "
                       f"by {err:.3e} m > 1e-5")
    print(f"tick: extract_points on the card equals extract_points_numpy "
          f"({int(valid.sum())} of {valid.size} points valid, max |err| "
          f"{err:.2e} m)", flush=True)


def phase_tick() -> dict:
    model = detection_params(torch.Generator().manual_seed(0), MODEL,
                             device=DEVICE)
    frames = xr_frames(N_TICKS + 2, FRAME_HW, DEPTH_HW, seed=3)
    loops = {}
    for name, fused in (("fused", True), ("classic", False)):
        cfg = ExecutorConfig(model=MODEL, fused_tick=fused, emit_masks="none")
        ex = Executor(cfg, params=model, frame_hw=FRAME_HW, device=DEVICE)
        loops[name] = XRLoop(ex)
    fused, classic = loops["fused"].executor, loops["classic"].executor

    # --- one tick each, not counted: the first fused dispatch binds and
    # warms the tick pipeline of this geometry
    for loop in loops.values():
        tick_until_result(loop, frames[0])

    # --- the main path (fused ticks only), with the launch counters zeroed
    # around it
    zero_counters()
    before = fused.tracer.counters["frames_dispatched"]
    start_tracking(loops["fused"], frames)
    first_locked = fused.tracker.locked_box
    for i, frame in enumerate(frames[2:]):
        prev = fused.tracker.locked_box
        rf, _ = tick_until_result(loops["fused"], frame)
        check_tracked(fused, prev, rf, f"fused tick {i}")
    torch.cuda.synchronize()
    launches = read_counters()
    dispatched = fused.tracer.counters["frames_dispatched"] - before
    check(launches[K1["name"]] == dispatched == N_TICKS + 2,
          f"fused ticks: K1 launched {launches[K1['name']]} times over "
          f"{dispatched} dispatches")
    st = fused.tracer.summary()
    check("mask_fetch" not in st or st["mask_fetch"]["count"] == 0,
          "a fused tracked tick fetched a mask on its own")
    print(f"tick: fused: target locked over {N_TICKS} ticks at full width, "
          f"device relock equals the host tracker on every tick, K1 "
          f"launched {launches[K1['name']]} times over {dispatched} "
          "dispatches", flush=True)

    # --- fused and classic in turns on the same frames
    release_and_reset(loops["fused"])
    for loop in loops.values():
        loop.executor.tracer.reset()
        start_tracking(loop, frames)
    ms = {"fused": [], "classic": []}
    worst, far, total = 0.0, 0, 0
    for i, frame in enumerate(frames[2:]):
        rf, t = tick_until_result(loops["fused"], frame)
        ms["fused"].append(t)
        rc, t = tick_until_result(loops["classic"], frame)
        ms["classic"].append(t)
        check(rc.tracked is not None and rf.tracked is not None
              and rc.tracked.index == rf.tracked.index,
              f"tick {i}: classic and fused track different boxes")
        pf, pc = rf.point_cloud.positions, rc.point_cloud.positions
        check(pf.shape == pc.shape and len(pf) > 0,
              f"tick {i}: {len(pf)} fused points, {len(pc)} classic")
        d = np.abs(pf - pc).max(-1)
        worst, far, total = max(worst, float(d.max())), \
            far + int((d > 1e-4).sum()), total + len(d)
    check(worst <= 2e-2 and far <= 0.01 * total,
          f"classic points differ from fused: max {worst:.3e} m, {far} of "
          f"{total} beyond 1e-4 m")
    print(f"tick: classic tracks the same box with the same points over "
          f"{N_TICKS} ticks (max |diff| {worst:.2e} m, {far} of {total} "
          "points beyond 1e-4 m)", flush=True)
    name = torch.cuda.get_device_name(0)
    for k in ("fused", "classic"):
        print(f"tick: {k} p50 {statistics.median(ms[k]):.3f} ms, p95 "
              f"{np.percentile(ms[k], 95):.3f} ms over {N_TICKS} ticks on "
              f"{name}; stage means (ms): "
              f"{stage_means(loops[k].executor)}", flush=True)

    check_packed_parts(fused.cfg, model, frames[2], first_locked)
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
             "cluster", "steps", "us_per_step", "inside_share")


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
            **{key: k[key] for key in ("launches_note", "launches_by_path")
               if key in k},
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
        tick = phase_tick()
        # each kernel's count on the paths that run it (K1: the segment
        # path and the fused ticks); K4 runs on none
        for k in kernels:
            k["launches"] = (obb if k["name"] == K3["name"] else seg)[k["name"]]
        kernels[0]["launches"] += tick[K1["name"]]
        kernels[0]["launches_by_path"] = {"segment": seg[K1["name"]],
                                          "tick": tick[K1["name"]]}
        kernels[-1]["launches"] = sum(p[K4["name"]] for p in (seg, obb, tick))
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
