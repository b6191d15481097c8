"""Drive batched frames: StreamingRunner over build_pipeline(batch=B).

One caller feeds uint8 batches [B, H, W, 3] in a closed loop: a new
batch is submitted as soon as the runner hands back the oldest result,
with `depth` batches queued behind the one being read. The batches cycle
through a few distinct ones made from the seed. The window submits until
its seconds are up, then drains what is in flight: every batch it
submitted is counted, over the time from its first submit to its last
result.

The results' slates are all kept, and the masks of a seeded reservoir
of batches plus the last one; after the window those batches are held
against the reference, every row (see _check). The control (`control`)
answers the same batches with the reference in a lower precision in the
program's place, and the same _check judges it.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import compare, counts, port, traffic
from benchmark.harness.trace import Trace, span
from benchmark.harness.weights import make_weights
from benchmark.reference import pipeline


def run(ctx) -> dict:
    import torch
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner

    cfg, p = ctx.cfg, ctx.cell["params"]
    B = p["batch"]
    ctx.mark("imports")
    sd = make_weights(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    model = port.build_model(cfg, sd, ctx.device)
    pipe = build_pipeline(port.exec_config(cfg), model,
                          frame_hw=tuple(cfg["frame_hw"]), batch=B,
                          device=ctx.device).warmup()
    del model
    ctx.mark("pipeline")
    runner = StreamingRunner(pipe, depth=p["depth"])
    batches = traffic.batch_pool(ctx.seed, p["distinct_batches"], B,
                                 tuple(cfg["frame_hw"]))
    for i in range(p["warm_batches"]):
        runner.submit(batches[i % len(batches)])
    for _ in runner.drain():
        pass
    ctx.mark("warm")
    rng = traffic.rng_for(ctx.seed, 5)
    kept = {}                 # batch id -> (slate, masks) of the reservoir
    seen = [0]
    last = [None]

    def window(seconds, traced, keep):
        done = 0
        bid = 0
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            with span("submit", traced):
                r = runner.submit(batches[bid % len(batches)])
            bid += 1
            if r is not None:
                done += 1
                if keep:
                    _keep(r, kept, seen, last, rng, p["check_batches"])
        with span("drain", traced):
            for r in runner.drain():
                done += 1
                if keep:
                    _keep(r, kept, seen, last, rng, p["check_batches"])
        return done

    out = {"setup_s": time.time() - ctx.t_start}
    t0 = time.perf_counter()
    done = window(ctx.seconds, False, True)
    out["window_s"] = time.perf_counter() - t0
    out["frames"] = done * B
    out["attempted"], out["failed"] = done * B, 0
    c = counts.pipeline_counts(cfg, B)
    out["flops_per_frame"] = c["flops"] / B
    out["least_step_s"] = c["least_s"]
    if ctx.trace:
        with Trace() as tr:
            out["trace_steps"] = window(ctx.cell["trace_seconds"], True,
                                        False)
        out["trace"] = tr.summary
    out["device"] = ctx.read_device(out.get("trace"))
    if last[0] is not None:
        kept[last[0][0]] = last[0][1:]
    host = {k: (s, m.float().cpu().numpy()) for k, (s, m) in kept.items()}
    del runner, pipe, kept, last
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    out["numbers"] = _check(ctx, sd, batches, host)
    return out


def _keep(r, kept, seen, last, rng, k) -> None:
    """Reservoir-sample k of the window's batches (Algorithm R, seeded);
    the newest batch is held aside as `last`."""
    i = seen[0]
    seen[0] += 1
    item = (r.slate, r.device_out["masks"])
    if last[0] is not None:
        j = last[0][0]
        if j < k:
            kept[j] = last[0][1:]
        else:
            slot = int(rng.integers(0, j + 1))
            if slot < k:
                victim = sorted(kept)[slot]
                del kept[victim]
                kept[j] = last[0][1:]
    last[0] = (i, *item)


def _check(ctx, sd, batches, host) -> dict:
    """Every row of the kept batches: the slate (slate_miss, nms_miss,
    rank_gap, score_err, box_err) and every kept detection's mask
    (mask_err) against the reference's mask of the same anchor. host:
    batch id -> (its slate, its masks [B, D, h, w])."""
    cfg = ctx.cfg
    nums: dict = {}
    answers = []
    for bid, (slate, masks) in sorted(host.items()):
        frames = batches[bid % len(batches)]
        refs = pipeline.run(sd, cfg, frames, ctx.device)
        for row, ref in enumerate(refs):
            c = int(slate["count"][row])
            res = compare.slate_numbers(
                ref, np.asarray(slate["boxes_xywh"][row])[:c],
                np.asarray(slate["scores"][row])[:c],
                np.asarray(slate["labels"][row])[:c])
            compare.worst(nums, res)
            a = res["anchor"]
            answer = {"box_err": res["box_err"],
                      "mask_err": compare.UNMATCHED if (a < 0).any() else
                      compare.mask_err(pipeline.masks_of(ref, a),
                                       masks[row, :c])}
            compare.worst(nums, answer)
            answers.append(answer)
    compare.add_means(nums, answers)
    nums["frames_checked"] = float(len(answers))
    return nums


def control(ctx, sd, quant) -> dict:
    """The control's numbers: the reference in `quant`, in the program's
    place, answers `check_batches` + 1 batches of the pool, every row in
    the program's slate layout; _check judges them."""
    cfg, p = ctx.cfg, ctx.cell["params"]
    B, D = p["batch"], cfg["max_detections"]
    batches = traffic.batch_pool(ctx.seed, p["distinct_batches"], B,
                                 tuple(cfg["frame_hw"]))
    host = {}
    for bid in range(p["check_batches"] + 1):
        outs = pipeline.run(sd, cfg, batches[bid % len(batches)],
                            ctx.device, quant=quant)
        h, w = outs[0]["protos"].shape[:2]
        slate = {"boxes_xywh": np.zeros((B, D, 4), np.float32),
                 "scores": np.zeros((B, D), np.float32),
                 "labels": np.zeros((B, D), np.int64),
                 "count": np.zeros(B, np.int64)}
        masks = np.zeros((B, D, h, w), np.float32)
        for row, out in enumerate(outs):
            ans = pipeline.slate_of(out)
            c = len(ans["anchors"])
            slate["boxes_xywh"][row, :c] = ans["boxes"]
            slate["scores"][row, :c] = ans["scores"]
            slate["labels"][row, :c] = ans["labels"]
            slate["count"][row] = c
            masks[row, :c] = pipeline.masks_of(out, ans["anchors"])
        host[bid] = (slate, masks)
    return _check(ctx, sd, batches, host)
