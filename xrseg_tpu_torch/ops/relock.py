"""Device-side target re-lock: the tracker's per-frame match as tensor ops
(counterpart of xrseg_tpu/ops/relock.py).

The reference re-locks its single tracked target every frame on the CPU:
same-class detections, nearest centre, 300 px gate
(Assets/Scripts/InferenceEngine/IEExecutor.cs:485-526), mirrored on the
host by perception.tracking.TargetTracker.update. Here the match runs
inside the fused tick (compile.build_xr_tick_pipeline): the previous
target rides in with the frame, the matched index feeds the mask
synthesis and the depth fusion on the device, and nothing is read back
in between. The host tracker stays as the parity oracle.
"""
from __future__ import annotations

import numpy as np
import torch


def relock_match(boxes_xywh: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, prev: torch.Tensor,
                 screen_scale: torch.Tensor, gate_px: float = 300.0):
    """TargetTracker.update on the device (IEExecutor.cs:485-526).

    boxes_xywh: [D,4] model-space (cx,cy,w,h); labels: [D] int;
    valid: [D] bool: the padded NMS slate.
    prev: [4] f32: previous target (cx_model, cy_model, label, valid).
    screen_scale: [2] f32: (screen_w/model_w, screen_h/model_h); the gate
      is measured in SCREEN pixels (distances there are the model-space
      deltas scaled per axis; the Y flip cannot change a magnitude).

    Returns (matched [] bool, index [] int32), both tensors on the inputs'
    device: the nearest same-class valid detection strictly inside the
    gate, or matched=False (index is then the argmin over an all-inf row,
    0, and must be ignored). torch.argmin, like jnp.argmin, returns the
    first of equal minima.
    """
    dx = (boxes_xywh[:, 0] - prev[0]) * screen_scale[0]
    dy = (boxes_xywh[:, 1] - prev[1]) * screen_scale[1]
    d2 = dx * dx + dy * dy
    cand = valid & (labels == prev[2].to(labels.dtype)) & (prev[3] > 0.5)
    d2m = torch.where(cand, d2, torch.inf)
    idx = torch.argmin(d2m)
    gate2 = float(np.float32(gate_px) ** 2)
    matched = d2m.gather(0, idx[None])[0] < gate2
    return matched, idx.to(torch.int32)
