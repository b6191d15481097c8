"""Configuration dataclasses of the PyTorch port.

The port's own copy of `xrseg_tpu/config.py` (the port imports nothing of
the JAX package): the same frozen dataclasses, fields, defaults and the two
scene presets, so a config written for one package means the same thing
in the other. Only the comments that describe a backend differ.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """YOLO11 family model configuration (arch "yolo12", the port's own,
    runs the segment and detect tasks only; arch "sam", also the port's
    own, is Segment Anything at scale b, l or h, box-prompted, at a square
    input_size of 1024: models/sam.py).

    Reference contract: 640x640 input, 80 COCO classes, 32 mask
    prototypes at 160x160.
    """
    scale: str = "n"                 # one of n / s / m / l / x
    arch: str = "yolo11"             # "yolo11" | "yolov8" | "yolo12" | "sam"
    num_classes: int = 80
    num_masks: int = 32              # mask coefficients (segmentation only)
    reg_max: int = 16                # DFL bins per box side
    input_size: Tuple[int, int] = (640, 640)   # (H, W)
    # "segment" | "detect" | "obb" | "pose" | "classify"
    task: str = "segment"
    kpt_shape: Tuple[int, int] = (17, 3)   # pose: (num_kpts, dims)
    # NMS-free one-to-one head beside the detect head (detect / segment)
    o2o: bool = False
    dtype: str = "bfloat16"          # compute dtype of the network
    param_dtype: str = "float32"
    # float32 matmul/conv precision: "default" | "high" | "tensorfloat32" |
    # "bfloat16" allow TF32 on the card; "highest" | "float32" forbid it
    # (the exact-parity mode; see xrseg_tpu_torch/precision.py)
    matmul_precision: str = "default"

    @property
    def mask_size(self) -> Tuple[int, int]:
        # prototypes are produced at input/4
        return (self.input_size[0] // 4, self.input_size[1] // 4)

    @property
    def num_anchors(self) -> int:
        h, w = self.input_size
        return (h // 8) * (w // 8) + (h // 16) * (w // 16) + (h // 32) * (w // 32)


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Baked postprocess knobs: NMS thresholds, the max_detections slate
    (the reference's 50-box parse cap), candidate cap and backend."""
    iou_threshold: float = 0.6
    score_threshold: float = 0.23
    max_detections: int = 50
    # Static cap on NMS candidates (threshold compaction, ops/nms.py).
    # 0 = every anchor is a candidate (exact at any scene density).
    pre_nms_topk: int = 0
    # NMS execution backend: "scan" = the plain torch select-and-suppress
    # loop; "cuda" = the hand-written kernel (ops/nms_kernels.py);
    # "auto" = the kernel for CUDA tensors, the plain loop for CPU tensors.
    # Both are exact greedy NMS with identical results. Under merge="wbf"
    # it picks the WBF scan the same way (ops/wbf.py: K5/K6 or the plain
    # scan).
    nms_backend: str = "auto"
    class_aware: bool = True
    # Candidate merge: "nms" keeps the best of overlapping candidates,
    # "wbf" fuses them (weighted box fusion, ops/wbf.py; the batched
    # detect/segment/obb paths, as in the JAX package)
    merge: str = "nms"


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """RGBD point-cloud extraction knobs."""
    max_points: int = 8000
    sampling_step: int = 4
    confidence_threshold: float = 0.5
    min_depth_m: float = 0.1
    max_depth_m: float = 3.0
    latency_seconds: float = 0.033   # depth sensor latency compensation


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Inference runtime knobs: build_pipeline reads `model`, `post` and
    `batch_size`; runtime.executor.Executor reads the rest (nothing reads
    `max_inflight`, in either package)."""
    model: ModelConfig = ModelConfig()
    post: PostprocessConfig = PostprocessConfig()
    depth: DepthConfig = DepthConfig()
    confidence_threshold: float = 0.5
    max_inflight: int = 2
    enable_ui_rendering: bool = True
    tracking_gate_px: float = 300.0
    select_margin_px: float = 50.0
    batch_size: int = 1
    multi_tracking: bool = False
    motion_model: bool = False
    reid_threshold: float = 0.0
    track_high_score: float = 0.0
    emit_masks: str = "all"
    fused_tick: bool = False


# The reference's two scenes as presets (both deploy stretch resize).
TEST_PRESET = ExecutorConfig(
    post=PostprocessConfig(iou_threshold=0.6, score_threshold=0.23),
    enable_ui_rendering=True,
)
XR_PRESET = ExecutorConfig(
    post=PostprocessConfig(iou_threshold=0.43, score_threshold=0.301),
    depth=DepthConfig(sampling_step=5),
    enable_ui_rendering=False,
)
