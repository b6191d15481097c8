"""Deterministic fixture weights that are guaranteed to detect.

The port's counterpart of xrseg_tpu/testing.py: random-init weights fire
detections only by seed luck, so `detection_params` patches the detect
head's final 1x1 convs so that EVERY anchor emits a confident box:

- cls out-conv bias: class `label` at `score_logit`, every other class at
  -8; its weights are random, scaled so the per-anchor logit spread is
  ~cls_spread (one calibration forward measures the penultimate
  activation RMS, since random-init activations decay by the head).
- box (DFL) out-conv bias: each side's mass on bin `dist_bin`, so each
  anchor decodes to a (2*dist_bin*stride)-px square centred on itself,
  small enough that neighbouring boxes stay under NMS IoU gates and the
  slate fills to max_det.

The rest of the network keeps its random init. The numbers come from the
port's own generator and differ from the JAX package's.
"""
from __future__ import annotations

import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.models import yolo11

_CALIBRATION_SEED = 20260817


def detection_params(gen: torch.Generator, cfg: ModelConfig, *,
                     label: int = 0, score_logit: float = 2.0,
                     dist_bin: int = 1, cls_spread: float = 0.3,
                     device="cuda") -> yolo11.YOLO11:
    """init_params + head patch => a YOLO11 on `device` that always
    detects: every anchor predicts class `label` at sigmoid(score_logit
    +- ~cls_spread) with a (2*dist_bin*stride)-px box centred on itself."""
    nc, reg_max = cfg.num_classes, cfg.reg_max
    if not 0 <= label < nc:
        raise ValueError(f"label {label} out of range [0, {nc})")
    if not 0 < dist_bin < reg_max:
        raise ValueError(f"dist_bin {dist_bin} out of range (0, {reg_max})")
    dev = resolve_device(device)
    model = yolo11.init_params(gen, cfg).to(dev)
    calib = torch.Generator().manual_seed(_CALIBRATION_SEED)
    x = torch.rand((1, 3) + tuple(cfg.input_size), generator=calib)
    with torch.no_grad():
        feats = model.backbone_neck(x.to(dev, model.dtype))
        for i, f in enumerate(feats):
            d3 = model.det.cv3[i]
            c = d3.hidden(f).float()
            rms = float(c.square().mean().sqrt()) + 1e-12
            w_scale = cls_spread / (rms * c.shape[1] ** 0.5)
            d3.out.weight.copy_(
                torch.randn(d3.out.weight.shape, generator=gen) * w_scale)
            bias = torch.full((nc,), -8.0)
            bias[label] = score_logit
            d3.out.bias.copy_(bias)
            box_out = model.det.cv2[i].out
            box_b = torch.zeros(4 * reg_max)
            box_b[dist_bin::reg_max] = 8.0
            box_out.bias.copy_(box_b)
            box_out.weight.copy_(
                torch.randn(box_out.weight.shape, generator=gen) * 1e-3)
    return model
