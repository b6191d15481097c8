"""Pipeline parallelism (PP): stage-split serving across two devices
(counterpart of xrseg_tpu/parallel/pipeline.py).

The network splits at the backbone|neck boundary into two stages on two
devices; the backbone's three feature maps cross as a device-to-device
copy. The JAX runner splits its params by the key prefix "b"; the port
splits the module by submodule (the backbone's b* blocks on device 0,
everything else on device 1), so each device holds only its stage's
weights.

run_stream enqueues stage A, the hop and stage B of every frame without
waiting for the card: frames are uploaded from pinned host memory without
blocking, and the host waits only on the event of frame i - max_inflight.
While stage B of frame i runs on device 1, stage A of frame i+1 runs on
device 0. With the same device twice ([cuda:0, cuda:0]) both stages queue
on that device's one stream, in order.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.compile import CompiledPipeline, bind_params
from xrseg_tpu_torch.config import ExecutorConfig
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.parallel.batch import on_device


def _stage(model: yolo11.YOLO11, backbone: bool, dev: torch.device
           ) -> yolo11.YOLO11:
    """A copy of `model` holding only the backbone's blocks (b*) or only
    the rest, on `dev`; the submodules left out are never copied."""
    memo = {id(m): None for name, m in model.named_children()
            if name.startswith("b") != backbone}
    part = copy.deepcopy(model, memo)
    for name in [n for n, m in part._modules.items() if m is None]:
        del part._modules[name]
    return part.to(dev).eval()


def _upload(frames, dev: torch.device) -> torch.Tensor:
    """Host frames to `dev` without blocking the host: a pinned copy, then
    a non-blocking upload. The one form beside device.to_device, which is
    pageable and may wait for dev's queue: run_stream queues frame i+1
    while the card still works on frame i."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    if dev.type == "cuda" and frames.device.type == "cpu":
        frames = frames.pin_memory()
    return frames.to(dev, non_blocking=True)


@dataclasses.dataclass(kw_only=True)
class _StagedPipeline(CompiledPipeline):
    """The frame program with its forward split at the backbone|neck
    boundary: `params` (stage A: preprocess and backbone) on `device`,
    `stage_b` (neck, heads and decode) on `stage_b_device`."""
    stage_b: yolo11.YOLO11
    stage_b_device: torch.device

    def forward(self, x: torch.Tensor):
        a, b, d1 = self.params, self.stage_b, self.stage_b_device
        feats = a.backbone(a.to_input(x))
        # the stage boundary: device 0's maps to device 1
        feats = tuple(f.to(d1, non_blocking=True) for f in feats)
        with on_device(d1):
            return b.head_outputs(b.neck(feats), concat_preds=False)

    def decode(self, out) -> Dict[str, torch.Tensor]:
        with on_device(self.stage_b_device):
            return super().decode(out)


class PipelinedRunner:
    """Two-stage pipelined inference over two devices.

    stage A (device 0): preprocess + backbone
    stage B (device 1): neck + task heads + decode_task_outputs
    """

    def __init__(self, cfg: ExecutorConfig, params: yolo11.YOLO11,
                 devices: Optional[Sequence] = None, *,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 batch: int = 1, resize_mode: str = "stretch"):
        yolo11.refuse_arch(cfg.model, "pipeline parallelism")
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass devices (e.g. "
                    "[torch.device('cpu')] * 2) to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devs = [torch.device(d) for d in devices]
        if len(devs) < 2:
            raise ValueError("pipeline parallelism needs >= 2 devices")
        mcfg = cfg.model
        if mcfg.task == "classify":
            # classify has no neck or heads to split at the backbone|neck
            # boundary (its head hangs off x10 directly)
            raise ValueError("pipeline parallelism does not apply to "
                             "task 'classify' (no neck stage)")
        params = bind_params(cfg, params, None)
        self.d0, self.d1 = devs[0], devs[1]
        self.input_shape = (batch, *(frame_hw or mcfg.input_size), 3)
        self.program = _StagedPipeline(
            cfg=cfg, params=_stage(params, True, self.d0),
            input_shape=self.input_shape, device=self.d0,
            resize_mode=resize_mode, stage_b=_stage(params, False, self.d1),
            stage_b_device=self.d1)
        self.stage_a_model = self.program.params
        self.stage_b_model = self.program.stage_b

    def warmup(self) -> "PipelinedRunner":
        if self.d0.type == "cuda" or self.d1.type == "cuda":
            _build.build_all()
        self(np.zeros(self.input_shape, np.uint8))["slate"].cpu()
        return self

    def __call__(self, frames) -> Dict[str, torch.Tensor]:
        with on_device(self.d0):
            return self.program.enqueue(_upload(frames, self.d0))

    def run_stream(self, frames_iter, max_inflight: int = 2
                   ) -> List[Dict[str, Any]]:
        """Pipelined streaming: one result per input batch, in order. The
        host enqueues each frame's stages and hop without waiting; it
        waits only on frame i - max_inflight (device-memory backpressure)
        when it enqueues frame i, and on the rest at the end."""
        results: List[Dict[str, Any]] = []
        pending: "deque" = deque()
        for frames in frames_iter:
            det = self(frames)
            done = None
            if self.d1.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.d1))
            pending.append((det, done))
            if len(pending) > max_inflight:
                results.append(_wait(*pending.popleft()))
        while pending:
            results.append(_wait(*pending.popleft()))
        return results


def _wait(det, done) -> Dict[str, Any]:
    if done is not None:
        done.synchronize()
    return det
