"""Frame pipeline: preprocess + network + postprocess behind one call
(counterpart of xrseg_tpu/compile.py).

`build_pipeline(cfg, model)` returns a CompiledPipeline that maps uint8
frames [B, H, W, 3] to the detection dict of the JAX package (boxes_xywh
in model space, labels, scores, coefs, masks or protos, valid, count) plus
the packed `slate`. There is no jit: PyTorch runs eagerly, and `warmup()`
builds the CUDA kernels and runs one dummy frame instead.

This slice ports the segment/detect NMS path with rgb input, stretch and
letterbox resize, crop_masks, emit_masks "all"/"none", mask_dtype, batch
and frame_hw, and the obb task (rotated NMS; the slate carries 5-wide
boxes_xywhr). The other options raise NotImplementedError naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.device import resolve_device, to_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops.postprocess import (_check_merge,
                                             postprocess_batch_parts,
                                             postprocess_obb_batch)
from xrseg_tpu_torch.precision import precision_scope


@dataclasses.dataclass
class CompiledPipeline:
    """A frame -> detections program bound to one model and geometry."""
    cfg: ExecutorConfig
    params: yolo11.YOLO11
    input_shape: Tuple[int, ...]
    device: torch.device
    resize_mode: str = "stretch"
    crop_masks: bool = False
    mask_dtype: torch.dtype = torch.float32
    emit_masks: str = "all"

    def __call__(self, frames) -> Dict[str, torch.Tensor]:
        """frames: uint8 [B,H,W,3], numpy or tensor, on any device."""
        mcfg = self.cfg.model
        x = to_device(frames, self.device)
        with torch.inference_mode(), precision_scope(mcfg.matmul_precision):
            x = pre_ops.preprocess(x, mcfg.input_size, mode=self.resize_mode,
                                   dtype=getattr(torch, mcfg.dtype))
            out = self.params(x, concat_preds=False)
            return decode_task_outputs(
                out, mcfg, self.cfg.post, crop_masks=self.crop_masks,
                mask_dtype=self.mask_dtype, emit_masks=self.emit_masks)

    def warmup(self) -> "CompiledPipeline":
        """Build the kernels, run one dummy frame and read its slate back."""
        if self.device.type == "cuda":
            _build.build_all()
        out = self(np.zeros(self.input_shape, np.uint8))
        out["slate"].cpu()
        return self


def build_pipeline(cfg: ExecutorConfig, params: yolo11.YOLO11, *,
                   frame_hw: Optional[Tuple[int, int]] = None,
                   batch: Optional[int] = None,
                   resize_mode: str = "stretch",
                   crop_masks: bool = False,
                   mask_dtype: str = "float32",
                   input_format: str = "rgb",
                   params_dtype: Optional[str] = None,
                   emit_masks: str = "all",
                   mask_display_hw: Optional[Tuple[int, int]] = None,
                   tta: bool = False,
                   device="cuda") -> CompiledPipeline:
    """Bind `params` (a YOLO11 module, moved to `device`) into a pipeline
    for frames [batch, frame_h, frame_w, 3] uint8.

    emit_masks "all" materialises every survivor's [h,w] mask; "none" is
    the coefs-only mode (the slate carries coefs and protos instead)."""
    if emit_masks not in ("all", "none"):
        raise ValueError(f"emit_masks {emit_masks!r}: expected 'all'|'none'")
    if tta:
        raise NotImplementedError("tta is not ported yet (ROADMAP queue 1, "
                                  "accuracy modes)")
    if input_format != "rgb":
        raise NotImplementedError(
            f"input_format {input_format!r} is not ported yet (ROADMAP "
            "queue 1, yuv420 / mask_display_hw / params_dtype)")
    if mask_display_hw is not None:
        raise NotImplementedError("mask_display_hw is not ported yet "
                                  "(ROADMAP queue 1, yuv420 / "
                                  "mask_display_hw / params_dtype)")
    if params_dtype is not None:
        raise NotImplementedError("params_dtype is not ported yet (ROADMAP "
                                  "queue 1, yuv420 / mask_display_hw / "
                                  "params_dtype)")
    _check_merge(cfg.post)
    if not isinstance(params, yolo11.YOLO11):
        raise TypeError("params must be a YOLO11 module (JAX params go "
                        "through xrseg_tpu_torch.io.bridge.params_from_jax)")
    if params.cfg != cfg.model:
        raise ValueError("params were built for another ModelConfig")
    dev = resolve_device(device)
    B = batch or cfg.batch_size
    fh, fw = frame_hw or cfg.model.input_size
    return CompiledPipeline(cfg=cfg, params=params.to(dev).eval(),
                            input_shape=(B, fh, fw, 3), device=dev,
                            resize_mode=resize_mode, crop_masks=crop_masks,
                            mask_dtype=getattr(torch, mask_dtype),
                            emit_masks=emit_masks)


def decode_task_outputs(out, mcfg: ModelConfig, pcfg: PostprocessConfig, *,
                        crop_masks: bool = False, mask_dtype=torch.float32,
                        emit_masks: str = "all") -> Dict[str, torch.Tensor]:
    """Raw forward outputs (concat_preds=False) -> the detection dict with
    the packed slate. The obb branch, like the JAX one, leaves the NMS
    backend to postprocess_obb_batch's own "auto" (K3 on CUDA tensors)."""
    yolo11.check_supported(mcfg)
    if mcfg.task == "obb":
        det = postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                    pcfg, scores_are_logits=True)
    else:
        det = postprocess_batch_parts(
            out["boxes_xywh"], out["cls_logits"], out.get("mask_coefs"),
            out.get("protos"), pcfg, crop_masks, mcfg.input_size,
            mask_dtype=mask_dtype, scores_are_logits=True,
            with_masks=(emit_masks == "all"))
    det["slate"] = pack_slate(det, pcfg.max_detections)
    return det


def pack_slate(det: Dict[str, torch.Tensor], max_det: int) -> torch.Tensor:
    """Small per-frame outputs -> ONE flat [B, D*(bd+3)+1] f32 array
    (boxes | scores | labels | valid | count): one host copy per frame.
    bd = 4 for axis-aligned boxes, 5 for obb (cx, cy, w, h, angle)."""
    boxes = det.get("boxes_xywhr", det.get("boxes_xywh"))
    bd = boxes.shape[-1]
    return torch.cat([
        boxes.reshape(-1, max_det * bd),
        det["scores"],
        det["labels"].float(),
        det["valid"].float(),
        det["count"].float()[:, None],
    ], -1)


def unpack_slate(slate_row, max_det: int, box_dim: int = 4
                 ) -> Dict[str, Any]:
    """Host-side inverse of pack_slate for one image's row (numpy out).
    box_dim=5 decodes an obb slate (key "boxes_xywhr")."""
    if isinstance(slate_row, torch.Tensor):
        slate_row = slate_row.detach().cpu().numpy()
    s = np.asarray(slate_row)
    D, bd = max_det, box_dim
    return {
        ("boxes_xywhr" if bd == 5 else "boxes_xywh"): s[:D * bd].reshape(D, bd),
        "scores": s[D * bd:D * (bd + 1)],
        "labels": s[D * (bd + 1):D * (bd + 2)].astype(np.int32),
        "valid": s[D * (bd + 2):D * (bd + 3)] > 0.5,
        "count": int(s[D * (bd + 3)]),
    }


def load_model(cfg: ExecutorConfig, params: Optional[yolo11.YOLO11] = None,
               seed: int = 0, device="cuda", **kw) -> CompiledPipeline:
    """Build (random weights from `seed` when params is None), then warm up."""
    if params is None:
        params = yolo11.init_params(torch.Generator().manual_seed(seed),
                                    cfg.model)
    return build_pipeline(cfg, params, device=device, **kw).warmup()
