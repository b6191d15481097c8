"""The one bridge from a configuration file to the program under test:
its config objects and a network holding the benchmark's weights."""
from __future__ import annotations

import dataclasses


def model_config(cfg: dict):
    from xrseg_tpu_torch.config import ModelConfig
    return ModelConfig(scale=cfg["scale"], num_classes=cfg["num_classes"],
                       num_masks=cfg["num_masks"], reg_max=cfg["reg_max"],
                       input_size=tuple(cfg["input_size"]),
                       dtype=cfg["dtype"], param_dtype=cfg["param_dtype"])


def exec_config(cfg: dict, **kw):
    from xrseg_tpu_torch.config import (DepthConfig, ExecutorConfig,
                                        PostprocessConfig)
    d = cfg["depth"]
    base = ExecutorConfig(
        model=model_config(cfg),
        post=PostprocessConfig(iou_threshold=cfg["iou_threshold"],
                               score_threshold=cfg["score_threshold"],
                               max_detections=cfg["max_detections"]),
        depth=DepthConfig(sampling_step=d["sampling_step"],
                          confidence_threshold=d["confidence_threshold"],
                          min_depth_m=d["min_depth_m"],
                          max_depth_m=d["max_depth_m"],
                          latency_seconds=d["latency_seconds"]),
        tracking_gate_px=cfg["tracking_gate_px"])
    return dataclasses.replace(base, **kw)


def build_model(cfg: dict, sd, device):
    """The program's network for `cfg` on `device`, holding a copy of the
    state dict `sd` (a strict load: every name and shape must agree)."""
    import torch
    from xrseg_tpu_torch.models import yolo11
    with torch.device(device):
        model = yolo11.YOLO11(model_config(cfg))
    model.load_state_dict(sd, strict=True)
    return model.to(device)
