"""Per-stage device timing and roofline of the deployed pipeline (the
port's tools/stage_profile.py).

Splits the YOLO11n-seg pipeline at batch `batch` (default 128, the bench's
headline batch) into 8 stages, in the JAX tool's order: preprocess, the
backbone thirds (b0-b2, b3-b6, b7-b10), the neck, the detect heads with
the DFL decode, the segment heads with the proto, and postprocess (K1 on
the card). Each stage gets its own random input in the compute dtype at
the shape the stage sees in the pipeline (uint8 frames for preprocess,
NCHW feature maps for the network stages, a float32 forward's raw heads
for postprocess with scores_are_logits=True), drawn from a seeded
torch.Generator. Weights are random (init_params from seed 0), computed
in bf16 (ModelConfig's default dtype, under its precision scope).

Timing: eager torch on one stream orders the calls, so each stage is
timed as 20 calls between two CUDA events after a warm-up call, under
no_grad, best of 2 (on the CPU with the host clock). No carry is threaded
through the calls: in eager mode that would be an extra full-tensor pass
per call, timed as part of the stage.

FLOPs: torch.utils.flop_counter.FlopCounterMode over one call, as
models/yolo11.model_info counts. It counts convolutions and matrix
products only; the JAX tool reads XLA's cost_analysis(), which also counts
elementwise work. So preprocess (a scale and, for another frame size, a
lerp) reads 0 GFLOPs and 0 TF/s here, and the stages 2-7 sum to the
forward's count exactly. The JAX tool's jitted detect- and seg-head stages
return only their first output, so XLA drops the class branches and the
mask-coefficient branches from what it times; here every stage computes
all of its outputs.

The WHOLE_PIPELINE row times compile.build_pipeline at the same batch on
device-resident uint8 frames the same way (20 calls, best of 2) and
prints sum_of_stages_ms beside it.

    python -m xrseg_tpu_torch.tools.stage_profile [batch]
    python -m xrseg_tpu_torch.tools.stage_profile 2 --size 64 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

STAGES = ("preprocess", "backbone_stem_b0-2", "backbone_mid_b3-6",
          "backbone_deep_b7-10", "neck", "detect_heads+dfl",
          "seg_heads+proto", "postprocess")
# the network's stages: together they are the forward
FORWARD_STAGES = STAGES[1:7]


def build_stages(model, cfg, batch: int, gen: torch.Generator, device
                 ) -> Dict[str, Tuple[Callable, tuple]]:
    """{stage name: (fn, inputs)} in STAGES order for `model` (a YOLO11
    for the segment task) under `cfg` (an ExecutorConfig). Inputs are drawn
    from `gen` on its own device, then moved to `device`; each fn runs
    under cfg.model's precision scope and returns its stage's outputs
    (NCHW maps, as the modules hold them; the flattened anchor rows for the
    heads)."""
    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.ops import preprocess as pre_ops
    from xrseg_tpu_torch.ops.postprocess import postprocess_batch_parts
    from xrseg_tpu_torch.precision import precision_scope

    mcfg, pcfg = cfg.model, cfg.post
    if mcfg.task != "segment":
        raise ValueError(f"stage_profile splits the segment pipeline, not "
                         f"task {mcfg.task!r}")
    m = model.to(device).eval()
    dt = m.dtype
    s = yolo11.Spec(mcfg)
    H, W = mcfg.input_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device
                           ).to(device, dt)

    def scoped(fn):
        def run(*args):
            with precision_scope(mcfg.matmul_precision):
                return fn(*args)
        return run

    def stem(x):                          # b0-b2 (H -> H/4)
        return m.b2(m.b1(m.b0(x)))

    def mid(x):                           # b3-b6 (H/4 -> H/16)
        x4 = m.b4(m.b3(x))
        return x4, m.b6(m.b5(x4))

    def deep(x):                          # b7-b10 (H/16 -> H/32)
        return m.b10(m.b9(m.b8(m.b7(x))))

    def neck(a, b, d):
        return m.neck((a, b, d))

    def det_heads(*feats):
        box = yolo11._flatten([br(f) for br, f in zip(m.det.cv2, feats)],
                              4 * mcfg.reg_max)
        cls = yolo11._flatten([br(f) for br, f in zip(m.det.cv3, feats)],
                              mcfg.num_classes)
        return yolo11.dfl_decode(box, mcfg.reg_max), cls

    def seg_heads(*feats):
        protos = m.proto(feats[0])
        return protos, yolo11._flatten(
            [br(f) for br, f in zip(m.seg_cv4, feats)], mcfg.num_masks)

    def postprocess(bx, cl, mc, pr):
        return postprocess_batch_parts(
            bx, cl, mc, pr, pcfg, False, mcfg.input_size, mask_dtype=dt,
            scores_are_logits=True)

    frames = torch.randint(0, 255, (batch, H, W, 3), generator=gen,
                           device=gen.device, dtype=torch.uint8).to(device)
    x640 = normal(batch, H, W, 3)         # NHWC, as the pipeline feeds it
    x160 = normal(batch, s.c256, H // 4, W // 4)
    x40 = normal(batch, s.c512, H // 16, W // 16)
    # the backbone's skips into the neck: x4 [c512, H/8], x6 [c512, H/16],
    # x10 [c1024, H/32]
    sk80 = normal(batch, s.c512, H // 8, W // 8)
    sk20 = normal(batch, s.c1024, H // 32, W // 32)
    # the neck's outputs into the heads: P3, P4, P5
    p80 = normal(batch, s.head_ch[0], H // 8, W // 8)
    p40 = normal(batch, s.head_ch[1], H // 16, W // 16)
    p20 = normal(batch, s.head_ch[2], H // 32, W // 32)
    with torch.no_grad():
        out = m(x640.float(), concat_preds=False)
    stages = {
        "preprocess": (lambda fr: pre_ops.preprocess(
            fr, mcfg.input_size, dtype=dt), (frames,)),
        "backbone_stem_b0-2": (stem, (x640.permute(0, 3, 1, 2),)),
        "backbone_mid_b3-6": (mid, (x160,)),
        "backbone_deep_b7-10": (deep, (x40,)),
        "neck": (neck, (sk80, x40, sk20)),
        "detect_heads+dfl": (det_heads, (p80, p40, p20)),
        "seg_heads+proto": (seg_heads, (p80, p40, p20)),
        "postprocess": (postprocess, (out["boxes_xywh"], out["cls_logits"],
                                      out["mask_coefs"], out["protos"])),
    }
    return {name: (scoped(fn), args) for name, (fn, args) in stages.items()}


def count_flops(fn: Callable, args: tuple) -> int:
    """FLOPs of one call as FlopCounterMode counts them (convolutions and
    matrix products, 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return int(counter.get_total_flops())


def best_ms(call: Callable[[], object], device, n: int = 20,
            repeats: int = 2) -> float:
    """ms per call: one warm-up call, then `repeats` windows of `n` calls
    between two CUDA events (the host clock on the CPU); the best window
    over n."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    with torch.no_grad():
        call()
        if on_card:
            torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(repeats):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    call()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms)
    return best / n


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--size", type=int, default=640,
                    help="model input size (the CPU smoke runs 64)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.device import resolve_device
    from xrseg_tpu_torch.models import yolo11

    dev = resolve_device(args.device)
    cfg = ExecutorConfig(model=ModelConfig(
        scale="n", input_size=(args.size, args.size)))
    model = yolo11.init_params(torch.Generator().manual_seed(0), cfg.model)
    stages = build_stages(model, cfg, args.batch,
                          torch.Generator().manual_seed(0), dev)

    total_ms = 0.0
    for name, (fn, ops) in stages.items():
        flops = count_flops(fn, ops)
        ms = best_ms(lambda: fn(*ops), dev)
        total_ms += ms
        print(json.dumps({"stage": name, "ms": round(ms, 3),
                          "gflops": round(flops / 1e9, 1),
                          "tf_per_s": round(flops / (ms / 1e3) / 1e12, 1)}),
              flush=True)

    # the whole pipeline on the same device-resident frames
    frames = stages["preprocess"][1][0]
    pipe = build_pipeline(cfg, model, batch=args.batch, device=dev).warmup()
    ms = best_ms(lambda: pipe(frames), dev)
    print(json.dumps({"stage": "WHOLE_PIPELINE", "ms": round(ms, 2),
                      "sum_of_stages_ms": round(total_ms, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
