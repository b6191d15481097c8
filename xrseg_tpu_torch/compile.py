"""Frame pipeline: preprocess + network + postprocess behind one call
(counterpart of xrseg_tpu/compile.py).

`build_pipeline(cfg, model)` returns a CompiledPipeline that maps uint8
frames [B, H, W, 3] to the detection dict of the JAX package (boxes_xywh
in model space, labels, scores, coefs, masks or protos, valid, count) plus
the packed `slate`. There is no jit: PyTorch runs eagerly, and `warmup()`
builds the CUDA kernels and runs one dummy frame instead.

Ported: the segment/detect NMS path with rgb input, stretch and letterbox
resize, crop_masks, emit_masks "all"/"none", mask_dtype, batch and
frame_hw, the obb task (rotated NMS; the slate carries 5-wide
boxes_xywhr), and the fused XR tick (`build_xr_tick_pipeline`: frame,
re-lock, target mask and RGBD fusion as one program with one packed
readback). The other options raise NotImplementedError naming their
ROADMAP item.

Every pipeline owns a `device.Readback` (one pinned host buffer, one copy
stream) of its slate's or packed output's length; the executor starts it
at dispatch and polls it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.device import Readback, resolve_device, to_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops import depth_fusion as df
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops.masks import select_row, synthesize_one_mask
from xrseg_tpu_torch.ops.postprocess import (_check_merge,
                                             postprocess_batch_parts,
                                             postprocess_obb_batch)
from xrseg_tpu_torch.ops.relock import relock_match
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
    readback: Optional[Readback] = None     # of the [B, L] slate

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
    bd = 5 if cfg.model.task == "obb" else 4
    return CompiledPipeline(cfg=cfg, params=params.to(dev).eval(),
                            input_shape=(B, fh, fw, 3), device=dev,
                            resize_mode=resize_mode, crop_masks=crop_masks,
                            mask_dtype=getattr(torch, mask_dtype),
                            emit_masks=emit_masks,
                            readback=Readback(
                                B * slate_length(cfg.post.max_detections, bd),
                                dev))


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


def slate_length(max_det: int, box_dim: int = 4) -> int:
    """Floats in one image's slate row: boxes | scores | labels | valid |
    count."""
    return max_det * (box_dim + 3) + 1


def unpack_slate(slate_row, max_det: int, box_dim: int = 4
                 ) -> Dict[str, Any]:
    """Host-side inverse of pack_slate for one image's row (numpy out).
    box_dim=5 decodes an obb slate (key "boxes_xywhr"). The row is copied
    first: it may be a view of a readback buffer that the next frame
    overwrites."""
    if isinstance(slate_row, torch.Tensor):
        slate_row = slate_row.detach().cpu().numpy()
    s = np.array(slate_row)
    D, bd = max_det, box_dim
    return {
        ("boxes_xywhr" if bd == 5 else "boxes_xywh"): s[:D * bd].reshape(D, bd),
        "scores": s[D * bd:D * (bd + 1)],
        "labels": s[D * (bd + 1):D * (bd + 2)].astype(np.int32),
        "valid": s[D * (bd + 2):D * (bd + 3)] > 0.5,
        "count": int(s[D * (bd + 3)]),
    }


@dataclasses.dataclass
class XRTickPipeline:
    """The reference's WHOLE tracked-frame workload as ONE program and ONE
    packed readback (ExecutorConfig.fused_tick).

    Per tracked frame the reference (and the classic executor path) pays
    three serialized device round trips: detection readback, target-mask
    copy, depth-fusion result (IEExecutor.cs:446-449, 615-621, 653-682).
    Here the re-lock match (ops/relock.py), the matched target's mask
    synthesis and the RGBD fusion all run behind the frame's network with
    no host decision in between (the previous target box is an input) and
    the frame emits

      [ slate | matched, index | target mask? | fused points ]

    as one flat f32 tensor: a single device-to-host copy. Mask and point
    rows are zeroed when unmatched, so consumers read validity from the
    packed flags.
    """
    cfg: ExecutorConfig
    params: yolo11.YOLO11
    input_shape: Tuple[int, ...]
    depth_hw: Tuple[int, int]
    slate_len: int
    mask_hw: Optional[Tuple[int, int]]   # None = mask not emitted
    n_points: int
    device: torch.device
    readback: Readback                   # of the packed output
    input_format: str = "rgb"

    # aux layout: focal 2 | principal 2 | sensor 2 | cam_pos 3 |
    #             cam_quat 4 | prev(cx,cy,label,valid) 4 | screen_scale 2
    AUX_LEN = 19

    @property
    def packed_len(self) -> int:
        mask = 0 if self.mask_hw is None else self.mask_hw[0] * self.mask_hw[1]
        return self.slate_len + 2 + mask + self.n_points * 5

    def __call__(self, frames, depth_fp16, aux) -> Dict[str, torch.Tensor]:
        """frames: uint8 [1,H,W,3]; depth_fp16: [dh,dw] raw fp16 bits,
        uint16 numpy or an int16 tensor (ops/depth_fusion.depth_bits);
        aux: f32 [19] (pack_aux). Uploads the three, queues the whole tick
        and returns {"packed", "coefs", "protos"} on the device."""
        depth = depth_fp16.to(self.device) \
            if isinstance(depth_fp16, torch.Tensor) \
            else df.depth_bits(depth_fp16, self.device)
        return self.run(to_device(frames, self.device), depth,
                        to_device(aux, self.device))

    def run(self, x: torch.Tensor, depth: torch.Tensor, aux: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        """The tick on tensors that already lie on the device (uint8
        frames, int16 depth bits, f32 aux). Nothing in here reads a value
        back or depends on a device value in Python, so the host only
        queues work."""
        mcfg, pcfg, dcfg = self.cfg.model, self.cfg.post, self.cfg.depth
        with torch.inference_mode(), precision_scope(mcfg.matmul_precision):
            x = pre_ops.preprocess(x, mcfg.input_size,
                                   dtype=getattr(torch, mcfg.dtype))
            out = self.params(x, concat_preds=False)
            det = decode_task_outputs(out, mcfg, pcfg, emit_masks="none")
            boxes = det["boxes_xywh"][0]
            prev = aux[13:17]
            matched, idx = relock_match(
                boxes, det["labels"][0], det["valid"][0], prev, aux[17:19],
                gate_px=self.cfg.tracking_gate_px)
            mask = synthesize_one_mask(det["coefs"][0], det["protos"][0], idx)
            pts = df.extract_points(
                depth, mask, select_row(boxes, idx),
                aux[0:2], aux[2:4], aux[4:6], aux[6:9], aux[9:13],
                confidence_threshold=dcfg.confidence_threshold,
                min_depth=dcfg.min_depth_m, max_depth=dcfg.max_depth_m,
                sampling_step=dcfg.sampling_step,
                mask_hw=mcfg.mask_size)["packed"]
            m = matched.to(torch.float32)
            parts = [det["slate"][0], torch.stack([m, idx.to(torch.float32)])]
            if self.mask_hw is not None:
                parts.append(mask.reshape(-1).to(torch.float32) * m)
            parts.append((pts * m).reshape(-1))
            # coefs/protos stay on the device for re-ID embeddings and
            # between-frame laser extraction; never part of the copy
            return {"packed": torch.cat(parts), "coefs": det["coefs"],
                    "protos": det["protos"]}

    def warmup(self) -> "XRTickPipeline":
        """Build the kernels, run one zero tick and wait for its readback."""
        if self.device.type == "cuda":
            _build.build_all()
        out = self(np.zeros(self.input_shape, np.uint8),
                   np.zeros(self.depth_hw, np.uint16),
                   np.zeros((self.AUX_LEN,), np.float32))
        self.readback.start(out["packed"])
        self.readback.wait()
        return self

    @staticmethod
    def pack_aux(focal, principal, sensor, cam_pos, cam_quat, prev,
                 screen_scale) -> np.ndarray:
        return np.concatenate([
            np.asarray(focal, np.float32).ravel(),
            np.asarray(principal, np.float32).ravel(),
            np.asarray(sensor, np.float32).ravel(),
            np.asarray(cam_pos, np.float32).ravel(),
            np.asarray(cam_quat, np.float32).ravel(),
            np.asarray(prev, np.float32).ravel(),
            np.asarray(screen_scale, np.float32).ravel(),
        ]).astype(np.float32)

    def unpack(self, packed) -> Dict[str, Any]:
        """Host-side split of the one readback into the executor's
        contract: unpack_slate keys + matched / matched_index /
        target_mask? / points_packed [N,5]. `packed` is copied first (it
        may be the readback buffer, which the next tick overwrites)."""
        if isinstance(packed, torch.Tensor):
            packed = packed.detach().cpu().numpy()
        s = np.array(packed)
        h = unpack_slate(s[:self.slate_len], self.cfg.post.max_detections)
        off = self.slate_len
        h["matched"] = s[off] > 0.5
        h["matched_index"] = int(s[off + 1])
        off += 2
        if self.mask_hw is not None:
            mh, mw = self.mask_hw
            h["target_mask"] = s[off:off + mh * mw].reshape(mh, mw)
            off += mh * mw
        h["points_packed"] = s[off:off + self.n_points * 5].reshape(
            self.n_points, 5)
        return h


def build_xr_tick_pipeline(cfg: ExecutorConfig, params: yolo11.YOLO11, *,
                           frame_hw: Optional[Tuple[int, int]] = None,
                           depth_hw: Tuple[int, int] = (128, 128),
                           emit_target_mask: bool = True,
                           params_dtype: Optional[str] = None,
                           device="cuda") -> XRTickPipeline:
    """Bind the fused XR tick for fixed frame + depth geometry.

    See XRTickPipeline. Segment task only (the XR product task: the tick's
    mask and point stages are mask-defined). emit_target_mask adds the
    matched target's [mh,mw] sigmoid mask to the packed readback for UI
    rendering; headless consumers skip it.
    """
    mcfg = cfg.model
    if mcfg.task != "segment":
        raise ValueError(f"fused_tick requires task='segment', "
                         f"got {mcfg.task!r}")
    if params_dtype is not None:
        raise NotImplementedError("params_dtype is not ported yet (ROADMAP "
                                  "queue 1 item 6, yuv420 / mask_display_hw "
                                  "/ params_dtype)")
    _check_merge(cfg.post)
    if not isinstance(params, yolo11.YOLO11):
        raise TypeError("params must be a YOLO11 module (JAX params go "
                        "through xrseg_tpu_torch.io.bridge.params_from_jax)")
    if params.cfg != mcfg:
        raise ValueError("params were built for another ModelConfig")
    dev = resolve_device(device)
    fh, fw = frame_hw or mcfg.input_size
    mh4, mw4 = mcfg.mask_size
    step = cfg.depth.sampling_step
    pipe = XRTickPipeline(
        cfg=cfg, params=params.to(dev).eval(), input_shape=(1, fh, fw, 3),
        depth_hw=tuple(depth_hw),
        slate_len=slate_length(cfg.post.max_detections),
        mask_hw=(mh4, mw4) if emit_target_mask else None,
        n_points=(mh4 // step) * (mw4 // step), device=dev, readback=None)
    pipe.readback = Readback(pipe.packed_len, dev)
    return pipe


def load_model(cfg: ExecutorConfig, params: Optional[yolo11.YOLO11] = None,
               seed: int = 0, device="cuda", **kw) -> CompiledPipeline:
    """Build (random weights from `seed` when params is None), then warm up."""
    if params is None:
        params = yolo11.init_params(torch.Generator().manual_seed(seed),
                                    cfg.model)
    return build_pipeline(cfg, params, device=device, **kw).warmup()
