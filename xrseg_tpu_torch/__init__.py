"""xrseg_tpu_torch — the PyTorch/CUDA port of xrseg_tpu.

A second package beside the JAX one: the same configs, network, ops and
frame pipeline in PyTorch, with the TPU's Pallas kernels rewritten by hand
for Hopper (csrc/). It imports nothing of JAX or of xrseg_tpu.

Quick start (on a card):

    import torch
    from xrseg_tpu_torch import ExecutorConfig, build_pipeline, init_params
    cfg = ExecutorConfig()
    model = init_params(torch.Generator().manual_seed(0), cfg.model)
    pipe = build_pipeline(cfg, model).warmup()     # device="cuda"
    det = pipe(frames_uint8)                       # [B,H,W,3] -> slate

Importing the package touches no device and builds nothing.
"""
from xrseg_tpu_torch.compile import (CompiledPipeline, build_pipeline,
                                     decode_task_outputs, load_model,
                                     pack_slate, unpack_slate)
from xrseg_tpu_torch.config import (TEST_PRESET, XR_PRESET, DepthConfig,
                                    ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.models.yolo11 import YOLO11, init_params
from xrseg_tpu_torch.ops.postprocess import postprocess

__all__ = [
    "CompiledPipeline", "build_pipeline", "decode_task_outputs", "load_model",
    "pack_slate", "unpack_slate", "TEST_PRESET", "XR_PRESET", "DepthConfig",
    "ExecutorConfig", "ModelConfig", "PostprocessConfig", "YOLO11",
    "init_params", "postprocess",
]
