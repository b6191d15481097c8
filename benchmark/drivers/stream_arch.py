"""Drive batched frames through a configuration of any arch the program
runs (`cfg["arch"]`: "yolo11" where it names none, "yolo12"):
StreamingRunner over build_pipeline(batch=B), as drivers/stream.py does.

The window, the reservoir of checked batches and the check are
stream.py's: its `_keep` is imported; `run`, `_check` and `control` are
its own with the program, the weights, the count and the reference
chosen by arch (harness/arch.py). A traced run also reads the program's
device-side ranges `xrseg.area_attn` and `xrseg.a2c2f`
(harness/ranges.py) for the per-layer metrics of the attention blocks.
The check also runs the bf16 witness on the checked frames and gives the
worst answer's score and mask errors in units of the witness's mean.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.drivers.stream import _keep
from benchmark.harness import arch, compare, traffic
from benchmark.harness.ranges import Trace
from benchmark.harness.trace import span
from benchmark.reference import pipeline

RANGES = ("xrseg.area_attn", "xrseg.a2c2f")
WITNESS = "bf16"


def run(ctx) -> dict:
    import torch
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner

    cfg, p = ctx.cfg, ctx.cell["params"]
    B = p["batch"]
    ctx.mark("imports")
    sd = arch.make_weights(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    model = arch.build_model(cfg, sd, ctx.device)
    pipe = build_pipeline(arch.exec_config(cfg), model,
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
    c = arch.pipeline_counts(cfg, B)
    out["flops_per_frame"] = c["flops"] / B
    out["least_step_s"] = c["least_s"]
    out["attn_least_s"] = c["attn_least_s"]
    if ctx.trace:
        with Trace(RANGES) as tr:
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


def _check(ctx, sd, batches, host) -> dict:
    """stream._check (its docstring) against cfg's arch's reference, and
    score_err and mask_err in units of the witness (WITNESS: the reference
    with its operands rounded to bfloat16), run on the same frames and
    read at the answers' own anchors: score_err_rel is the worst answer's
    score_err over the witness's mean score_err, mask_err_rel the same of
    mask_err. How far a random network carries rounding to its output
    differs from seed to seed by more than the fp8 control's error
    differs from the bf16 program's, so the absolute numbers do not tell
    the two apart across seeds; in units of the witness on the same seed
    they do (PERF.md §4). UNMATCHED where an answer has a detection that
    is no reference anchor's. Diagnostics: score_err_witness and
    mask_err_witness, the witness's means."""
    cfg = ctx.cfg
    nums: dict = {}
    answers = []
    witness = {"score_err": 0.0, "mask_err": 0.0}
    matched = True
    for bid, (slate, masks) in sorted(host.items()):
        frames = batches[bid % len(batches)]
        refs = arch.pipeline_run(sd, cfg, frames, ctx.device)
        wits = arch.pipeline_run(sd, cfg, frames, ctx.device, quant=WITNESS)
        for row, (ref, wit) in enumerate(zip(refs, wits)):
            c = int(slate["count"][row])
            res = compare.slate_numbers(
                ref, np.asarray(slate["boxes_xywh"][row])[:c],
                np.asarray(slate["scores"][row])[:c],
                np.asarray(slate["labels"][row])[:c])
            compare.worst(nums, res)
            a = res["anchor"]
            answer = {"box_err": res["box_err"],
                      "mask_err": compare.UNMATCHED}
            if (a < 0).any():
                matched = False
            else:
                ref_masks = pipeline.masks_of(ref, a)
                answer["mask_err"] = compare.mask_err(ref_masks,
                                                      masks[row, :c])
                gap = np.abs(wit["scores"][a] - ref["scores"][a])
                witness["score_err"] += float(np.mean(gap)) if c else 0.0
                witness["mask_err"] += compare.mask_err(
                    ref_masks, pipeline.masks_of(wit, a))
            compare.worst(nums, answer)
            answers.append(answer)
    compare.add_means(nums, answers)
    for k, total in witness.items():
        if matched and answers:
            nums[k + "_witness"] = total / len(answers)
            nums[k + "_rel"] = _ratio(nums.get(k, 0.0), total / len(answers))
        else:
            nums[k + "_rel"] = compare.UNMATCHED
    nums["frames_checked"] = float(len(answers))
    return nums


def _ratio(got: float, witness: float) -> float:
    if witness > 0:
        return got / witness
    return 0.0 if got == 0 else compare.UNMATCHED


def control(ctx, sd, quant) -> dict:
    """stream.control (its docstring) with cfg's arch's reference."""
    cfg, p = ctx.cfg, ctx.cell["params"]
    B, D = p["batch"], cfg["max_detections"]
    batches = traffic.batch_pool(ctx.seed, p["distinct_batches"], B,
                                 tuple(cfg["frame_hw"]))
    host = {}
    for bid in range(p["check_batches"] + 1):
        outs = arch.pipeline_run(sd, cfg, batches[bid % len(batches)],
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
