"""The work of one pipeline step, counted from the configuration's shapes,
and the published peaks of one NVIDIA H100 SXM (dense, no sparsity).

Per layer the least time is the larger of FLOPs / peak and bytes /
bandwidth, each input, weight and output counted once at the compute
dtype's width (bfloat16: 2 bytes). The step is the forward's convs and
matmuls (reference/yolo.count_forward), the preprocess (a uint8 frame
read, the model input written), the NMS (each anchor's box, score and
label read once, the slate written) and the mask synthesis (coefficients
and prototypes read, float32 masks written).
"""
from __future__ import annotations

from typing import Dict

from benchmark.reference import yolo

PEAK_FLOPS = 989e12          # bfloat16 dense tensor-core FLOP/s
PEAK_BYTES = 3.35e12         # HBM3 bytes/s


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def pipeline_counts(cfg: dict, batch: int) -> Dict[str, float]:
    """FLOPs and least time (seconds) of one step of `batch` frames."""
    fwd = yolo.count_forward(cfg, batch)
    least = sum(least_time(f, bi + bw + bo) for _, f, bi, bw, bo
                in fwd.layers)
    fh, fw = cfg["frame_hw"]
    mh, mw = cfg["input_size"]
    least += least_time(0, batch * (fh * fw * 3 + mh * mw * 3 * 2))
    anchors = sum((mh // s) * (mw // s) for s in (8, 16, 32))
    D, nm = cfg["max_detections"], cfg["num_masks"]
    least += least_time(0, batch * (anchors * (4 + 1 + 1) * 4 + D * 7 * 4))
    ph, pw = mh // 4, mw // 4
    mask_flops = 2 * batch * D * nm * ph * pw
    least += least_time(mask_flops, batch * (D * nm * 4 + ph * pw * nm * 4
                                             + D * ph * pw * 4))
    return {"flops": float(fwd.flops + mask_flops), "least_s": least}
