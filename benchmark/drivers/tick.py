"""Drive the XR loop: one headset, XRLoop.tick over the fused-tick Executor.

Set-up builds the program on the seed's weights, then runs the loop on
the scene until a laser-lock has selected a detection (the controller
aimed at the first box, trigger down) and `warm_results` more results
have come back. The window is a closed loop: one tick after another,
unpaced, each tick handed the scene's next frame. A frame's latency runs
from the start of the tick that dispatched it to the end of the tick
that returned its FrameResult. The window's wall and CPU time (every
thread's), its frames and their p50 and p95 go to standard error.

Every completed frame's unpacked readback is kept (a reference to the
dict the executor unpacks); after the window a seeded sample of them,
the last included, is held against the reference (see _check). The
control (`control`) answers a chain of frames with the reference in a
lower precision in the program's place, and the same _check judges it.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmark.harness import compare, port, traffic
from benchmark.harness.stats import percentile
from benchmark.harness.trace import Trace, span
from benchmark.harness.weights import make_weights
from benchmark.reference import pipeline, post


def run(ctx) -> dict:
    import torch
    from xrseg_tpu_torch.perception.camera import CameraIntrinsics, Pose
    from xrseg_tpu_torch.runtime.executor import Executor
    from xrseg_tpu_torch.runtime.frame_source import FrameData
    from xrseg_tpu_torch.runtime.xr_loop import (XRLoop,
                                                 aim_controller_at_frame_point)

    cfg, p = ctx.cfg, ctx.cell["params"]
    frame_hw, depth_hw = tuple(cfg["frame_hw"]), tuple(p["depth_hw"])
    fps = p["camera_fps"]
    ctx.mark("imports")
    sd = make_weights(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    model = port.build_model(cfg, sd, ctx.device)
    ecfg = port.exec_config(cfg, fused_tick=True,
                            enable_ui_rendering=p["ui_rendering"])
    ex = Executor(ecfg, params=model, frame_hw=frame_hw, device=ctx.device)
    del model
    ctx.mark("executor")
    intr = CameraIntrinsics(traffic.INTRINSICS["focal"],
                            traffic.INTRINSICS["principal"],
                            traffic.INTRINSICS["sensor"])
    loop = XRLoop(ex, intrinsics=intr)
    scene = traffic.scene_frames(ctx.seed, p["scene_frames"], frame_hw,
                                 depth_hw)

    def frame(s: int) -> FrameData:
        rgb, depth = scene[s % len(scene)]
        pos, quat = traffic.head_pose(s)
        return FrameData(rgb=rgb, timestamp=s / fps, pose=Pose(pos, quat),
                         intrinsics=intr, depth_fp16=depth)

    # every frame's unpacked readback, in completion order
    hosts = []
    orig_process = ex._process_result

    def process():
        hosts.append(ex._host)
        return orig_process()

    ex._process_result = process
    dispatched = []      # (source index, locked box at dispatch)
    src = 0

    def tick(s, controller=None):
        if not ex.is_running():
            dispatched.append((s, ex.tracker.locked_box))
        return loop.tick(frame(s), controller)

    results = 0
    deadline = time.monotonic() + p["lock_timeout_s"]
    while results < p["warm_results"] or not loop.selected:
        if time.monotonic() > deadline:
            raise RuntimeError("the laser never locked a target")
        r = tick(src)
        src += 1
        if r is None:
            continue
        results += 1
        if not loop.selected and r.count > 0:
            b = r.boxes[0]
            # the laser's screen position has its origin bottom left
            aim = (b.center_x + ex.screen_wh[0] / 2,
                   b.center_y + ex.screen_wh[1] / 2)
            ctl = aim_controller_at_frame_point(intr, frame(src).pose, aim,
                                                ex.screen_wh)
            ctl.trigger = True
            tick(src, ctl)
            src += 1
            results = 0
    while ex.is_running():                  # drain the last warm-up frame
        if tick(src) is not None:
            break
        src += 1
    ctx.mark("locked and warm")
    n_warm = len(hosts)
    n_warm_dispatched = len(dispatched)

    def window(seconds, traced):
        nonlocal src
        lat, dispatch_s = [], []
        t_end = time.perf_counter() + seconds
        t_disp = None
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end and t_disp is None:
                break
            idle = not ex.is_running()
            with span("dispatch" if idle else "poll", traced):
                r = tick(src)
            t1 = time.perf_counter()
            src += 1
            if idle:
                t_disp = t0
                dispatch_s.append(t1 - t0)
            if r is not None:
                if t1 <= t_end:
                    lat.append(t1 - t_disp)
                t_disp = None
        return lat, dispatch_s

    out = {"setup_s": time.time() - ctx.t_start}
    t0, c0 = time.perf_counter(), time.process_time()
    lat, dispatch_s = window(ctx.seconds, False)
    out["window_s"] = time.perf_counter() - t0
    out["tick_latencies_s"] = lat
    out["frames"] = len(lat)
    print(f"window {out['window_s']:.3f} s wall, "
          f"{time.process_time() - c0:.3f} s cpu, {len(lat)} frames, p50 "
          f"{percentile(lat, 50) * 1e3:.3f} ms, p95 "
          f"{percentile(lat, 95) * 1e3:.3f} ms", file=sys.stderr, flush=True)
    out["spans"] = {"dispatch_tick_s": dispatch_s}
    out["attempted"], out["failed"] = len(lat), 0
    if ctx.trace:
        n0 = len(hosts)
        with Trace() as tr:
            window(ctx.cell["trace_seconds"], True)
        out["trace"] = tr.summary
        out["trace_frames"] = len(hosts) - n0
    out["device"] = ctx.read_device(out.get("trace"))

    window_hosts = hosts[n_warm:n_warm + len(lat)]
    window_disp = [(s, _prev_of(locked, cfg))
                   for s, locked in dispatched[n_warm_dispatched:]]
    sources = [s for s, _ in dispatched]
    del ex, loop, orig_process
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    out["numbers"] = _check(ctx, sd, scene, window_hosts, window_disp,
                            sources, n_warm_dispatched)
    return out


def _prev_of(locked, cfg) -> tuple:
    """The tracker's locked box at a dispatch -> the re-lock's previous
    target in model space: (cx, cy, label, locked)."""
    if locked is None:
        return (0.0, 0.0, -1.0, 0.0)
    mh, mw = cfg["input_size"]
    screen = (float(cfg["frame_hw"][1]), float(cfg["frame_hw"][0]))
    cx, cy, _, _ = post.box_to_model_space(
        (locked.center_x, locked.center_y, locked.width, locked.height),
        screen, (mh, mw))
    return (cx, cy, float(locked.label), 1.0)


def _fusion_pose(sources, k, fps, d):
    """The pose the point fusion uses for dispatch k: the head pose of
    its source frame compensated for the depth latency by the motion
    since the previous dispatch."""
    s = sources[k]
    prev_s = sources[k - 1] if k > 0 else None
    cur_pos, cur_rot = traffic.head_pose(s)
    prev_pos, prev_rot = (traffic.head_pose(prev_s) if prev_s is not None
                          else (None, None))
    dt = 1 / 30 if prev_s is None else max(1e-3, (s - prev_s) / fps)
    return post.compensate_pose(cur_pos, cur_rot, prev_pos, prev_rot, dt,
                                d["latency_seconds"])


def _fuse(cfg, depth, mask, box, pose) -> np.ndarray:
    d = cfg["depth"]
    return post.fuse_points(
        depth, mask, box, traffic.INTRINSICS["focal"],
        traffic.INTRINSICS["principal"], traffic.INTRINSICS["sensor"],
        *pose, confidence=d["confidence_threshold"],
        min_depth=d["min_depth_m"], max_depth=d["max_depth_m"],
        step=d["sampling_step"])


def _check(ctx, sd, scene, hosts, disp, sources, first) -> dict:
    """Hold a seeded sample of the answers against the reference: the
    slate (slate_miss, nms_miss, rank_gap, box_err), the re-lock over the answer's own slate from the tracker's
    state at dispatch (relock_miss), the target mask (mask_err) and the
    point cloud (points_err), the last two for the anchor the answer
    locked, fused with the depth pose compensated again from the
    dispatched frames' poses. hosts[i]: the answer of dispatch
    first + i; disp[i]: (its source frame, the re-lock's previous target
    in model space); sources: the source frame of every dispatch."""
    cfg, p = ctx.cfg, ctx.cell["params"]
    mh, mw = cfg["input_size"]
    scale = (cfg["frame_hw"][1] / mw, cfg["frame_hw"][0] / mh)
    ids = traffic.sample_ids(ctx.seed, len(hosts), p["check_frames"])
    nums: dict = {}
    answers = []
    for i in ids:
        h = hosts[i]
        s, prev = disp[i]
        rgb, depth = scene[s % len(scene)]
        ref = pipeline.run(sd, cfg, rgb[None], ctx.device)[0]
        n = int(h["count"])
        res = compare.slate_numbers(ref, h["boxes_xywh"][:n],
                                    h["scores"][:n], h["labels"][:n])
        compare.worst(nums, res)
        answer = {"box_err": res["box_err"]}
        answers.append(answer)
        m_ref, i_ref, d2 = post.relock_nearest(
            h["boxes_xywh"], h["labels"], h["valid"], prev, scale,
            cfg["tracking_gate_px"])
        j = h["matched_index"]
        miss = bool(h["matched"]) != m_ref or (
            m_ref and not d2[j] <= d2[i_ref] * (1 + 1e-5) + 1e-3)
        compare.worst(nums, {"relock_miss": float(miss)})
        if not h["matched"] or miss:
            continue
        a = res["anchor"][j] if j < len(res["anchor"]) else -1
        if a < 0:
            answer.update(mask_err=compare.UNMATCHED,
                          points_err=compare.UNMATCHED)
            compare.worst(nums, answer)
            continue
        ref_mask = pipeline.masks_of(ref, np.array([a]))[0]
        if "target_mask" in h:
            answer["mask_err"] = compare.mask_err(ref_mask[None],
                                                  h["target_mask"][None])
        pose = _fusion_pose(sources, first + i, p["camera_fps"],
                            cfg["depth"])
        pts = _fuse(cfg, depth, ref_mask, ref["boxes"][a], pose)
        answer["points_err"] = compare.points_err(pts, h["points_packed"])
        compare.worst(nums, answer)
    compare.add_means(nums, answers)
    nums["frames_checked"] = float(len(ids))
    return nums


def control(ctx, sd, quant) -> dict:
    """The control's numbers: the reference in `quant`, in the program's
    place, answers a chain of `control_frames` dispatches, one every
    `control_gap` source frames, as the loop would: a laser-lock on the
    first detection, then each answer re-locked from the previous one's
    target, with its target mask and point cloud; _check judges them."""
    cfg, p = ctx.cfg, ctx.cell["params"]
    D = cfg["max_detections"]
    mh, mw = cfg["input_size"]
    scale = (cfg["frame_hw"][1] / mw, cfg["frame_hw"][0] / mh)
    scene = traffic.scene_frames(ctx.seed, p["scene_frames"],
                                 tuple(cfg["frame_hw"]), tuple(p["depth_hw"]))
    sources = [p["control_gap"] * k for k in range(p["control_frames"])]
    hosts, disp, prev = [], [], None
    for k, s in enumerate(sources):
        rgb, depth = scene[s % len(scene)]
        out = pipeline.run(sd, cfg, rgb[None], ctx.device, quant=quant)[0]
        ans = pipeline.slate_of(out)
        c = len(ans["anchors"])
        boxes = np.zeros((D, 4), np.float32)
        boxes[:c] = ans["boxes"]
        scores = np.zeros(D, np.float32)
        scores[:c] = ans["scores"]
        labels = np.zeros(D, np.int64)
        labels[:c] = ans["labels"]
        valid = np.arange(D) < c
        if prev is None and c:
            prev = (float(boxes[0, 0]), float(boxes[0, 1]),
                    float(labels[0]), 1.0)
        prev = prev or (0.0, 0.0, -1.0, 0.0)
        disp.append((s, prev))
        matched, j, _ = post.relock_nearest(boxes, labels, valid, prev,
                                            scale, cfg["tracking_gate_px"])
        h = {"count": c, "boxes_xywh": boxes, "scores": scores,
             "labels": labels, "valid": valid, "matched": matched,
             "matched_index": j}
        if matched:
            mask = pipeline.masks_of(out, ans["anchors"][j:j + 1])[0]
            h["target_mask"] = mask
            h["points_packed"] = _fuse(
                cfg, depth, mask, boxes[j],
                _fusion_pose(sources, k, p["camera_fps"], cfg["depth"]))
            prev = (float(boxes[j, 0]), float(boxes[j, 1]),
                    float(labels[j]), 1.0)
        else:
            prev = (0.0, 0.0, -1.0, 0.0)
        hosts.append(h)
    return _check(ctx, sd, scene, hosts, disp, sources, 0)
