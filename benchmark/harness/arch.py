"""The bridge from a configuration file to the program and the reference
by the configuration's `arch` ("yolo11" where it names none, or
"yolo12"): the program's config objects and network, the seeded weights,
the reference's frame pipeline and the step's count.

Each is the YOLO11-only helper of `port.py`, `weights.py`,
`reference/pipeline.py` or `counts.py` with the reference's module
(`reference/yolo.py` or `reference/yolo12.py`) chosen by `arch`; the
arithmetic is theirs, and so are the names and defaults.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import counts, port, traffic
from benchmark.harness.weights import _UnitRMS, seed63
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import post, yolo, yolo12

REFERENCES = {"yolo11": yolo, "yolo12": yolo12}


def reference(cfg: dict):
    """The reference module of cfg's arch."""
    arch = cfg.get("arch", "yolo11")
    if arch not in REFERENCES:
        raise ValueError(f"no reference for arch {arch!r}")
    return REFERENCES[arch]


def model_config(cfg: dict):
    return dataclasses.replace(port.model_config(cfg),
                               arch=cfg.get("arch", "yolo11"))


def exec_config(cfg: dict, **kw):
    return dataclasses.replace(port.exec_config(cfg, **kw),
                               model=model_config(cfg))


def build_model(cfg: dict, sd, device):
    """port.build_model for cfg's arch: a strict load of `sd`."""
    from xrseg_tpu_torch.models import yolo11
    with torch.device(device):
        model = yolo11.YOLO11(model_config(cfg))
    model.load_state_dict(sd, strict=True)
    return model.to(device)


# weights.make_weights' defaults: class 0 at logit 2.0 +- at most 1.0,
# DFL bin 3 at logit 6.0 moved by at most 1.0
LABEL, SCORE_LOGIT, CLS_MAX, DIST_BIN, BOX_LOGIT, BOX_MAX = \
    0, 2.0, 1.0, 3, 6.0, 1.0
GAMMA_SPREAD = 0.1


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """weights.make_weights (its docstring) for cfg's arch, with its
    default calibration. A2C2f's residual scale gamma is drawn uniform in
    1 +- GAMMA_SPREAD: at Ultralytics' initial 0.01 the attention blocks
    would barely reach the output, and a fault in them would stay inside
    the check's limits."""
    ref = reference(cfg)
    specs = ref.param_specs(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed63(seed))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    pool = torch.rand(total, generator=gen, device=dev)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = pool[off:off + n].view(shape)
        off += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if kind == "gamma":
            t.mul_(2).sub_(1).mul_(GAMMA_SPREAD).add_(1)
        elif name.endswith(".bias") or name.endswith(".up_b"):
            if kind == "head":
                cin = sd[name[:-len("bias")] + "weight"].shape[1]
                t.mul_(2).sub_(1).mul_(math.sqrt(1.0 / cin))
            else:
                t.zero_()
        elif kind == "head":
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / shape[1]))
        elif kind == "up":
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / (shape[0] * 4)))
        else:
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / fan_in))
        sd[name] = t
    rgb = traffic.scene_frames(seed, 1, tuple(cfg["frame_hw"]), (8, 8))[0][0]
    x = ref_pipeline.preprocess(torch.as_tensor(rgb[None]).to(dev),
                                cfg["input_size"])
    with torch.no_grad(), yolo.float32_scope():
        ref.forward(_UnitRMS(sd), cfg, x)
    _fire_every_anchor(ref, cfg, sd, x, gen, dev)
    return sd


def _fire_every_anchor(ref, cfg, sd, x, gen, dev) -> None:
    """weights._fire_every_anchor on `ref`'s backbone and neck."""
    reg_max = cfg["reg_max"]
    plan = ref.Plan(cfg)
    n_cls = sum(sd[f"det.cv3.{i}.out.weight"].numel() for i in range(3))
    n_box = sum(sd[f"det.cv2.{i}.out.weight"].numel() for i in range(3))
    normal = torch.randn(n_cls + n_box, generator=gen, device=dev)
    with torch.no_grad(), yolo.float32_scope():
        o = yolo.Ops(sd)
        feats = ref.backbone_neck(o, plan, x.permute(0, 3, 1, 2))
        off = 0
        for i, f in enumerate(feats):
            hidden = yolo.cls_hidden(o, f"det.cv3.{i}", f, plan.c3)
            w = sd[f"det.cv3.{i}.out.weight"]
            row = normal[off:off + hidden.shape[1]].clone()
            off += w.numel()
            z = (hidden[0] * row[:, None, None]).sum(0)
            row *= CLS_MAX / float(z.abs().max().clamp_min(1e-12))
            w.zero_()
            w[LABEL, :, 0, 0] = row
            b = sd[f"det.cv3.{i}.out.bias"]
            b.fill_(-8.0)
            b[LABEL] = SCORE_LOGIT
        for i, f in enumerate(feats):
            name = f"det.cv2.{i}"
            hidden = o.conv(f"{name}.conv1", o.conv(f"{name}.conv0", f,
                                                    plan.c2, 3), plan.c2, 3)
            w = sd[f"{name}.out.weight"]
            rows = normal[off:off + w.numel()].view(w.shape[:2]).clone()
            off += w.numel()
            z = torch.einsum("oh,hyx->oyx", rows, hidden[0])
            rows *= BOX_MAX / z.abs().amax((1, 2)).clamp_min(1e-12)[:, None]
            w.copy_(rows.view_as(w))
            b = sd[f"{name}.out.bias"]
            b.zero_()
            b[DIST_BIN::reg_max] = BOX_LOGIT


def pipeline_run(sd: Dict[str, torch.Tensor], cfg: dict, frames, device,
                 quant: Optional[str] = None, chunk: int = 8) -> List[Dict]:
    """reference/pipeline.run (its docstring) through cfg's arch."""
    ref = reference(cfg)
    out = []
    frames = torch.as_tensor(np.asarray(frames))
    strides = yolo.anchors(cfg["input_size"])[1][:, 0].double().numpy()
    with torch.no_grad(), yolo.float32_scope():
        for s in range(0, frames.shape[0], chunk):
            x = ref_pipeline.preprocess(frames[s:s + chunk].to(device),
                                        cfg["input_size"])
            raw = ref.forward(yolo.Ops(sd, quant=quant), cfg, x)
            det = post.detect(raw, cfg["iou_threshold"],
                              cfg["score_threshold"], cfg["max_detections"])
            for i in range(x.shape[0]):
                out.append({
                    "boxes": det["boxes_xywh"][i].double().cpu().numpy(),
                    "scores": det["scores"][i].double().cpu().numpy(),
                    "labels": det["labels"][i].cpu().numpy(),
                    "indices": det["indices"][i].cpu().numpy(),
                    "valid": det["valid"][i].cpu().numpy(),
                    "count": int(det["count"][i]),
                    "cutoff": float(det["cutoff"][i]),
                    "nms": (cfg["iou_threshold"], cfg["score_threshold"],
                            cfg["max_detections"]),
                    "strides": strides,
                    "coefs": det["coefs"][i],
                    "protos": det["protos"][i],
                })
    return out


def pipeline_counts(cfg: dict, batch: int) -> Dict[str, float]:
    """counts.pipeline_counts (its docstring) through cfg's arch, and
    attn_least_s: the least time of the step's fused attention calls."""
    fwd = reference(cfg).count_forward(cfg, batch)
    lt = counts.least_time
    least = sum(lt(f, bi + bw + bo) for _, f, bi, bw, bo in fwd.layers)
    attn = sum(lt(f, bi + bw + bo) for kind, f, bi, bw, bo in fwd.layers
               if kind == "attention")
    fh, fw = cfg["frame_hw"]
    mh, mw = cfg["input_size"]
    least += lt(0, batch * (fh * fw * 3 + mh * mw * 3 * 2))
    anchors = sum((mh // s) * (mw // s) for s in (8, 16, 32))
    D, nm = cfg["max_detections"], cfg["num_masks"]
    least += lt(0, batch * (anchors * (4 + 1 + 1) * 4 + D * 7 * 4))
    ph, pw = mh // 4, mw // 4
    mask_flops = 2 * batch * D * nm * ph * pw
    least += lt(mask_flops, batch * (D * nm * 4 + ph * pw * nm * 4
                                     + D * ph * pw * 4))
    return {"flops": float(fwd.flops + mask_flops), "least_s": least,
            "attn_least_s": attn}
