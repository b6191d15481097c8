"""Drive box-prompted batches through Segment Anything (arch "sam"):
StreamingRunner over build_pipeline(batch=B, prompts_per_frame=P), one
caller in a closed loop, as drivers/stream.py does for the detectors.

Each batch is B frames (traffic.batch_pool) with P boxes each
(harness/sam.box_pool), cycled through a few distinct ones made from the
seed; the window submits until its seconds are up, then drains. The
window's results are sampled by stream.py's `_keep` reservoir (its
seeded batches and the last), and after the window, once the program is
freed, every prompt of those batches is held against the plain float32
reference (reference/sam.py) and against the bf16 witness (the same
reference with every product's operands rounded to bfloat16), run on the
same frames and boxes, and the program itself in float32 on the last of
those batches (see `_check`). A traced run also reads the
program's device-side ranges `xrseg.relpos_attn` and `xrseg.sam_decoder`
(harness/ranges.py). The control (`control`) puts the reference in a
lower precision in the program's place and `_check` judges it.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.drivers.stream import _keep
from benchmark.harness import compare, traffic
from benchmark.harness import sam as sam_h
from benchmark.harness.ranges import Trace
from benchmark.harness.trace import span

RANGES = ("xrseg.relpos_attn", "xrseg.sam_decoder")
WITNESS = "bf16"


def _batches(ctx):
    cfg, p = ctx.cfg, ctx.cell["params"]
    hw = tuple(cfg["frame_hw"])
    frames = traffic.batch_pool(ctx.seed, p["distinct_batches"], p["batch"],
                                hw)
    boxes = sam_h.box_pool(ctx.seed, p["distinct_batches"], p["batch"],
                           p["prompts_per_frame"], hw)
    return list(zip(frames, boxes))


def run(ctx) -> dict:
    import torch
    # a program without arch "sam" stops here, at once
    from xrseg_tpu_torch.models import sam  # noqa: F401
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner

    cfg, p = ctx.cfg, ctx.cell["params"]
    B, P = p["batch"], p["prompts_per_frame"]
    ctx.mark("imports")
    sd = sam_h.make_weights(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    model = sam_h.build_model(cfg, sd, ctx.device)
    pipe = build_pipeline(sam_h.exec_config(cfg), model,
                          frame_hw=tuple(cfg["frame_hw"]), batch=B,
                          prompts_per_frame=P, device=ctx.device).warmup()
    del model
    ctx.mark("pipeline")
    runner = StreamingRunner(pipe, depth=p["depth"])
    batches = _batches(ctx)
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
    c = sam_h.pipeline_counts(cfg, B, P)
    out["flops_per_frame"] = c["flops"] / B
    out["least_step_s"] = c["least_s"]
    out["relpos_least_s"] = c["relpos_least_s"]
    if ctx.trace:
        with Trace(RANGES) as tr:
            out["trace_steps"] = window(ctx.cell["trace_seconds"], True,
                                        False)
        out["trace"] = tr.summary
    out["device"] = ctx.read_device(out.get("trace"))
    if last[0] is not None:
        kept[last[0][0]] = last[0][1:]
    host = {k: s for k, (s, _) in kept.items()}
    del runner, pipe, kept, last
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    out["numbers"] = _check(
        ctx, sd, batches, host,
        lambda bid, inputs: _float32_program(ctx, sd, inputs))
    return out


def _float32_program(ctx, sd, inputs):
    """The program built at float32 with TF32 off on `inputs` (frames,
    boxes): its low-resolution logits [B, P, 4g, 4g] on the device."""
    import torch
    from xrseg_tpu_torch.compile import build_pipeline
    cfg = {**ctx.cfg, "dtype": "float32", "matmul_precision": "highest"}
    p = ctx.cell["params"]
    model = sam_h.build_model(cfg, sd, ctx.device)
    pipe = build_pipeline(sam_h.exec_config(cfg), model,
                          frame_hw=tuple(cfg["frame_hw"]), batch=p["batch"],
                          prompts_per_frame=p["prompts_per_frame"],
                          device=ctx.device)
    low = pipe(inputs)["low_res_logits"]
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return low


def _check(ctx, sd, batches, host, float32_program) -> dict:
    """Every prompt of the kept batches (host: batch id -> its host rows:
    iou [B, P], low_res_logits [B, P, 4g, 4g], masks [B, P, H, W]) against
    the reference, in units of the witness on the same frames and boxes:

    - mask_err_rel: the worst prompt's mean |low-resolution logit - the
      reference's| over the witness's mean of the same over the prompts;
    - iou_err_rel: the worst prompt's |IoU prediction - the reference's|
      over the witness's mean;
    - mask_miss: frame-size pixels whose mask (logit above 0) is not the
      reference's where the reference's logit lies further from 0 than the
      witness's logit ever strays from it on these prompts (exact);
    - f32_mask_err_rel: mask_err_rel of the program built at float32
      (`float32_program(bid, (frames, boxes))`: its low-resolution
      logits) on the last of the batches: a fault in the function smaller
      than bf16's rounding (a tanh GELU moves the logits by a twentieth of
      the witness's error) shows there, where the program's own rounding
      is float32's.

    How far a random network carries rounding differs from seed to seed by
    more than a bf16 program differs from an fp8 one, so the absolute
    errors do not tell them apart across seeds; in units of the witness on
    the same seed they do (PERF.md §4). Diagnostics: mask_err_max and
    iou_err_max (the worst prompt's), mask_err_witness and
    iou_err_witness (the witness's means), stray (the witness's largest
    frame-logit gap), mask_sure (the pixels past it) and prompts_checked."""
    import torch
    cfg, dev = ctx.cfg, ctx.device
    last = max(host)
    mask_err, iou_err, wit_mask, wit_iou = [], [], [], []
    stray = 0.0
    sure = []                  # (the reference's frame logits, the masks)
    for bid, rows in sorted(host.items()):
        frames, boxes = batches[bid % len(batches)]
        ref = sam_h.pipeline_run(sd, cfg, frames, boxes, dev)
        wit = sam_h.pipeline_run(sd, cfg, frames, boxes, dev, quant=WITNESS)
        low = torch.as_tensor(np.asarray(rows["low_res_logits"])).to(dev)
        iou = torch.as_tensor(np.asarray(rows["iou"])).to(dev)
        mask_err.append((low - ref["low_res"]).abs().mean((-2, -1))
                        .flatten())
        wit_mask.append((wit["low_res"] - ref["low_res"]).abs()
                        .mean((-2, -1)).flatten())
        iou_err.append((iou - ref["iou"]).abs().flatten())
        wit_iou.append((wit["iou"] - ref["iou"]).abs().flatten())
        stray = max(stray, float((wit["frame_logits"] - ref["frame_logits"])
                                 .abs().max()))
        sure.append((ref["frame_logits"],
                     torch.as_tensor(np.asarray(rows["masks"])).to(dev)))
        if bid == last:
            f32 = (float32_program(bid, (frames, boxes))
                   - ref["low_res"]).abs().mean((-2, -1)).max()
        del wit
    nums: dict = {}
    for name, got, wit in (("mask_err", mask_err, wit_mask),
                           ("iou_err", iou_err, wit_iou)):
        got, wit = torch.cat(got), torch.cat(wit)
        nums[name + "_max"] = float(got.max())
        nums[name + "_witness"] = float(wit.mean())
        nums[name + "_rel"] = _ratio(nums[name + "_max"],
                                     nums[name + "_witness"])
    nums["f32_mask_err_max"] = float(f32)
    nums["f32_mask_err_rel"] = _ratio(nums["f32_mask_err_max"],
                                      nums["mask_err_witness"])
    miss = past = 0
    for logits, masks in sure:
        far = logits.abs() > stray
        past += int(far.sum())
        miss += int((far & ((logits > 0) != (masks > 0))).sum())
    nums["mask_miss"] = float(miss)
    nums["stray"] = stray
    nums["mask_sure"] = float(past)
    nums["prompts_checked"] = float(sum(len(e) for e in mask_err))
    return nums


def _ratio(got: float, witness: float) -> float:
    if witness > 0:
        return got / witness
    return 0.0 if got == 0 else compare.UNMATCHED


def control(ctx, sd, quant) -> dict:
    """The reference in `quant` in the program's place on the cell's
    check batches (the first check_batches + 1 of the pool), judged by
    `_check` (its float32 program too)."""
    import torch
    p = ctx.cell["params"]
    batches = _batches(ctx)
    host = {}
    for bid in range(p["check_batches"] + 1):
        frames, boxes = batches[bid % len(batches)]
        out = sam_h.pipeline_run(sd, ctx.cfg, frames, boxes, ctx.device,
                                 quant=quant)
        host[bid] = {"iou": out["iou"].cpu().numpy(),
                     "low_res_logits": out["low_res"].cpu().numpy(),
                     "masks": (out["frame_logits"] > 0).cpu().numpy()
                     .astype(np.uint8)}
    return _check(ctx, sd, batches, host, lambda bid, _: torch.as_tensor(
        host[bid]["low_res_logits"]).to(ctx.device))
