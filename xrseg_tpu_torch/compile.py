"""Frame pipeline: preprocess + network + postprocess behind one call
(counterpart of xrseg_tpu/compile.py).

`build_pipeline(cfg, model)` returns a CompiledPipeline that maps uint8
frames [B, H, W, 3] to the detection dict of the JAX package (boxes_xywh
in model space, labels, scores, coefs, masks or protos, valid, count) plus
the packed `slate`. There is no jit: PyTorch runs eagerly, and `warmup()`
builds the CUDA kernels and runs one dummy frame instead.

Ported: the segment/detect NMS path, stretch and letterbox resize,
crop_masks, emit_masks "all"/"none", mask_dtype, batch and frame_hw; rgb
or planar yuv420 input; masks upsampled to a display size
(mask_display_hw); weight storage in bfloat16 (params_dtype, cast once
at build); the NMS-free one-to-one head (ModelConfig.o2o); the obb task
(rotated NMS; the slate carries 5-wide boxes_xywhr); the pose task (its
slate is the box slate, the survivors' keypoints ride beside it as
det["kpts"]); the classify task (its slate IS the [B, nc] prob row);
both archs; weighted box fusion (PostprocessConfig.merge="wbf": K5, K6
for obb; pose keeps NMS, as in JAX); test-time augmentation (tta,
tta_views, tta_kpt_flip_idx: every view in ONE batched forward, the
candidates of all views in ONE merge); the model ensemble
(`build_ensemble_pipeline`: every member's candidates in one merge); the
fused XR tick (`build_xr_tick_pipeline`: frame, re-lock, target mask and
RGBD fusion as one program with one packed readback); and the compiled
artifact (`export_compiled`/`load_compiled`: a torch.export program, the
kernels inside as custom ops) with its converter CLI,

    python -m xrseg_tpu_torch.compile weights.{pt|onnx|npz} --out model.xrseg
        [--device cuda]

which writes an ultralytics-contract .onnx instead for an .onnx --out.

For arch "sam" (Segment Anything, models/sam.py) `build_pipeline` returns
a SAMPipeline: frames and their box prompts in, a mask, an IoU and the
low-resolution logits for each box out, packed as bytes into one row a
frame for its readback (no NMS and no slate).

A frame's two copies each leave the compute stream for a copy stream of
their own (`device.py`). On the way in, `CompiledPipeline.upload` stages
host frames for a card through the pipeline's `device.Upload` (a ring of
pinned slots; the compute stream waits on the slot's event, the host
never waits on the card), the one way every runner's batch reaches the
program. On the way out, every pipeline owns a `device.Readback` (one
pinned host buffer, one copy stream) of its slate's or packed output's
length; the executor starts it at dispatch and polls it. It holds one
frame; the streaming runners, which keep several frames of one pipeline
in flight, take a slot per frame from `runtime/streaming.ReadbackSlots`
of their own. The fused XR tick uploads its three inputs with
`to_device`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.device import (Readback, Upload, on_host,
                                    resolve_device, to_device)
from xrseg_tpu_torch.io.onnx_export import export_onnx
from xrseg_tpu_torch.io.weights import cast_params, load_params_auto
from xrseg_tpu_torch.models import sam, yolo11
from xrseg_tpu_torch.ops import depth_fusion as df
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops import masks as mask_ops
from xrseg_tpu_torch.ops.masks import (select_row, synthesize_one_mask,
                                       upsample_masks)
from xrseg_tpu_torch.ops.postprocess import (_check_merge,
                                             postprocess_batch_parts,
                                             postprocess_o2o_batch,
                                             postprocess_obb_batch,
                                             postprocess_pose_batch)
from xrseg_tpu_torch.ops.relock import relock_match
from xrseg_tpu_torch.ops.yuv import yuv420_to_rgb
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
    input_format: str = "rgb"
    mask_display_hw: Optional[Tuple[int, int]] = None
    staging: Optional[Upload] = None        # host frames' way to the card

    def __call__(self, frames) -> Dict[str, torch.Tensor]:
        """frames: uint8 [B,H,W,3], or with input_format="yuv420" a tuple
        (y [B,H,W], u [B,H/2,W/2], v [B,H/2,W/2]) of uint8 planes; numpy
        or tensors, on any device."""
        return self.enqueue(self.upload(frames))

    def upload(self, frames):
        """`frames`, as `__call__` takes them, on the device in the form
        `enqueue` takes. Host frames for a card go through `staging`
        (made at the first such call, the warmup's): pinned, on a copy
        stream of their own, the compute stream waiting on the copy.
        Frames already on the device pass through; a CPU pipeline copies
        with `to_device`."""
        if self.input_format == "yuv420":
            return self._stage(tuple(frames))
        return self._stage((frames,))[0]

    def _stage(self, planes: tuple) -> tuple:
        """`upload`'s copy of each plane: through `staging` for host
        planes and a card, else as they lie or with `to_device`."""
        if self.device.type == "cuda" and all(map(on_host, planes)):
            if self.staging is None:
                self.staging = Upload(self.device)
            return self.staging.put(planes)
        return tuple(to_device(p, self.device) for p in planes)

    def enqueue(self, frames) -> Dict[str, torch.Tensor]:
        """`run` on what `upload` returned, under inference mode and the
        model's matmul precision: every runner enters the program here."""
        with torch.inference_mode(), \
                precision_scope(self.cfg.model.matmul_precision):
            return self.run(*frames) if isinstance(frames, tuple) \
                else self.run(frames)

    def run(self, *frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The program on frames that already lie on the device (one uint8
        tensor, or the three yuv420 planes): what export_compiled traces.
        The caller sets the grad mode and the matmul precision."""
        return self.decode(self.forward(self.preprocess(*frames)))

    def preprocess(self, *frames: torch.Tensor) -> torch.Tensor:
        """Uploaded frames -> the network's NHWC input, compute dtype."""
        mcfg = self.cfg.model
        x = yuv420_to_rgb(*frames) if self.input_format == "yuv420" \
            else frames[0]
        return pre_ops.preprocess(x, mcfg.input_size, mode=self.resize_mode,
                                  dtype=getattr(torch, mcfg.dtype))

    def forward(self, x: torch.Tensor):
        """The network's raw-head dict (concat_preds=False); TTA, the
        ensemble and the parallel runners replace it."""
        return self.params(x, concat_preds=False)

    def decode(self, out) -> Dict[str, torch.Tensor]:
        """The forward's outputs -> the detection dict with the slate."""
        return decode_task_outputs(
            out, self.cfg.model, self.cfg.post, crop_masks=self.crop_masks,
            mask_dtype=self.mask_dtype, emit_masks=self.emit_masks,
            mask_display_hw=self.mask_display_hw)

    def unpack_rows(self, rows: np.ndarray, out) -> Dict[str, Any]:
        """The batch's slate rows, read back to the host ([B, L], a view of
        a readback buffer), as copies: each frame's unpack_slate, or its
        prob row for classify; a dict of per-frame lists for B > 1."""
        boxes = out.get("boxes_xywhr", out.get("boxes_xywh"))
        if boxes is None:    # classify: the slate IS the prob row
            slates = [{"probs": np.array(row)} for row in rows]
        else:
            max_det, box_dim = boxes.shape[1], boxes.shape[2]
            slates = [unpack_slate(row, max_det, box_dim=box_dim)
                      for row in rows]
        return slates[0] if len(slates) == 1 else {
            k: [s[k] for s in slates] for k in slates[0]}

    def dummy_input(self):
        """Zero frames of the pipeline's geometry and input format."""
        B, H, W, _ = self.input_shape
        if self.input_format == "yuv420":
            return (np.zeros((B, H, W), np.uint8),
                    np.zeros((B, H // 2, W // 2), np.uint8),
                    np.zeros((B, H // 2, W // 2), np.uint8))
        return np.zeros(self.input_shape, np.uint8)

    def warmup(self) -> "CompiledPipeline":
        """Build the kernels, run one dummy frame and read its slate back."""
        if self.device.type == "cuda":
            _build.build_all()
        out = self(self.dummy_input())
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
                   tta_kpt_flip_idx: Optional[Sequence[int]] = None,
                   tta_views: Optional[Sequence[Tuple[float, bool]]] = None,
                   prompts_per_frame: Optional[int] = None,
                   device="cuda") -> CompiledPipeline:
    """Bind `params` (a YOLO11 module, moved to `device`) into a pipeline
    for frames [batch, frame_h, frame_w, 3] uint8.

    For arch "sam" `params` is a models.sam.SAM and the pipeline a
    SAMPipeline: its input is the frames and `prompts_per_frame` boxes a
    frame; none of the options below applies to it.

    input_format="yuv420" takes planar camera frames instead, a tuple
    (y [B,H,W], u [B,H/2,W/2], v [B,H/2,W/2]) of uint8 planes, converted
    to RGB on the device (ops/yuv.py).

    params_dtype ("float32" | "bfloat16") sets the weight storage: the
    module is copied and cast once here (io/weights.cast_params), so no
    conv casts its weight at run time when storage and compute dtype
    agree.

    emit_masks "all" materialises every survivor's [h,w] mask; "none" is
    the coefs-only mode (the slate carries coefs and protos instead).
    mask_display_hw (with emit_masks "all") resizes the masks to that
    (H, W) on the device, bilinearly (ops/masks.upsample_masks).

    tta=True: test-time augmentation, by default 2 views (identity and
    horizontal flip; `tta_views` gives (scale, flip) pairs instead,
    ULTRALYTICS_TTA_VIEWS upstream's three). Every view rides ONE
    [V*B, ...] forward; flipped views are mirrored back (obb: angle
    negated; pose: keypoints mirrored, then permuted by tta_kpt_flip_idx,
    the skeleton's left/right joint permutation), scaled views divided by
    their scale, and the candidates of all views concatenate along the
    anchor axis (A -> V*A) before one NMS call. Segment survivors
    synthesize their masks against the protos of their own view (flipped
    protos flipped back). The validations are the JAX package's."""
    if tta:
        _check_tta(cfg.model, emit_masks, tta_kpt_flip_idx, tta_views)
    if cfg.model.arch == "sam" or prompts_per_frame is not None:
        given = {"resize_mode": resize_mode != "stretch",
                 "crop_masks": crop_masks,
                 "mask_dtype": mask_dtype != "float32",
                 "input_format": input_format != "rgb",
                 "params_dtype": params_dtype is not None,
                 "emit_masks": emit_masks != "all",
                 "mask_display_hw": mask_display_hw is not None}
        return _build_sam_pipeline(
            cfg, params, frame_hw=frame_hw, batch=batch,
            prompts_per_frame=prompts_per_frame, device=device,
            refused=[k for k, v in given.items() if v])
    check_output_options(emit_masks, mask_display_hw, input_format)
    _check_merge(cfg.post)
    params = bind_params(cfg, params, params_dtype)
    dev = resolve_device(device)
    B = batch or cfg.batch_size
    fh, fw = frame_hw or cfg.model.input_size
    pipe = dict(cfg=cfg, params=params.to(dev).eval(),
                input_shape=(B, fh, fw, 3), device=dev,
                resize_mode=resize_mode, crop_masks=crop_masks,
                mask_dtype=getattr(torch, mask_dtype), emit_masks=emit_masks,
                readback=Readback(B * task_slate_length(
                    cfg.model, cfg.post.max_detections), dev),
                input_format=input_format,
                mask_display_hw=(None if mask_display_hw is None
                                 else tuple(mask_display_hw)))
    if not tta:
        return CompiledPipeline(**pipe)
    return TTAPipeline(
        **pipe, views=tuple(tta_views) if tta_views else DEFAULT_TTA_VIEWS,
        kpt_flip_idx=(None if tta_kpt_flip_idx is None
                      else tuple(int(i) for i in tta_kpt_flip_idx)))


def check_output_options(emit_masks: str, mask_display_hw,
                         input_format: str) -> None:
    """build_pipeline's option checks, shared with parallel/batch."""
    if emit_masks not in ("all", "none"):
        raise ValueError(f"emit_masks {emit_masks!r}: expected 'all'|'none'")
    if mask_display_hw is not None and emit_masks != "all":
        raise ValueError("mask_display_hw requires emit_masks='all'")
    if input_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown input_format {input_format!r}")


def _check_tta(mcfg: ModelConfig, emit_masks: str, kpt_flip_idx,
               views) -> None:
    """build_pipeline(tta=True)'s checks, word for word the JAX
    package's."""
    yolo11.refuse_arch(mcfg, "test-time augmentation")
    if mcfg.task == "classify":
        raise ValueError("tta unsupported for task 'classify'"
                         " (nothing to merge pre-NMS)")
    if mcfg.o2o:
        raise ValueError(
            "tta is incompatible with o2o (NMS-free) serving: "
            "multi-view candidates NEED a merge step (NMS/WBF). "
            "Serve the same checkpoint's classic path instead: "
            "replace(cfg.model, o2o=False)")
    if mcfg.task == "pose" and kpt_flip_idx is None:
        raise ValueError("pose tta needs tta_kpt_flip_idx: the"
                         " skeleton's left/right joint permutation"
                         " under a mirror is model-specific (COCO-17:"
                         " TrainConfig's kpt_flip_idx values)")
    if kpt_flip_idx is not None and \
            sorted(kpt_flip_idx) != list(range(mcfg.kpt_shape[0])):
        raise ValueError("tta_kpt_flip_idx must be a permutation of"
                         f" range({mcfg.kpt_shape[0]})")
    if mcfg.task == "segment" and emit_masks != "all":
        raise ValueError("tta segment requires emit_masks='all' (the"
                         " coefs-only contract has one protos tensor;"
                         " TTA candidates pair with per-view protos)")
    if views is not None:
        if not views or any(not (0.0 < s <= 1.0) for s, _ in views):
            raise ValueError("tta_views scales must lie in (0, 1]")
        if mcfg.task in ("segment", "pose") and any(
                s != 1.0 for s, _ in views):
            raise ValueError(f"scaled tta views are detect/obb-only"
                             f" ({mcfg.task} protos/keypoints"
                             " don't unscale exactly)")


DEFAULT_TTA_VIEWS: Tuple[Tuple[float, bool], ...] = ((1.0, False),
                                                     (1.0, True))
# ultralytics augment=True runs scales (1, 0.83-flipped, 0.67); detect and
# obb take these through tta_views (each scaled view is letterboxed top
# left into the same canvas, gray fill, so all views keep one shape)
ULTRALYTICS_TTA_VIEWS: Tuple[Tuple[float, bool], ...] = (
    (1.0, False), (0.83, True), (0.67, False))


@functools.lru_cache(maxsize=8)
def _flip_index_on(idx: Tuple[int, ...], device: torch.device
                   ) -> torch.Tensor:
    """The keypoint flip permutation on `device`, uploaded once."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


@dataclasses.dataclass(kw_only=True)
class TTAPipeline(CompiledPipeline):
    """build_pipeline(tta=True): every view of the batch in one forward,
    the candidates of all views in one merge."""
    views: Tuple[Tuple[float, bool], ...]
    kpt_flip_idx: Optional[Tuple[int, ...]]   # pose: checked at build

    def forward(self, x: torch.Tensor):
        """Every view of the preprocessed [B,H,W,3] batch, stacked
        [V*B, ...], in one forward: each scaled view letterboxed top left
        into the same canvas (gray fill), each flipped view mirrored."""
        H, W = x.shape[1], x.shape[2]

        def make_view(scale, flip):
            xv = x
            if scale != 1.0:
                sh, sw = int(round(H * scale)), int(round(W * scale))
                xv = torch.full_like(x, 114.0 / 255.0)
                xv[:, :sh, :sw] = pre_ops.resize_bilinear(x, (sh, sw))
            return xv.flip(2) if flip else xv

        return self.params(torch.cat([make_view(s, f)
                                      for s, f in self.views]),
                           concat_preds=False)

    def decode(self, out) -> Dict[str, torch.Tensor]:
        """The views' candidates mapped back to the frame (flipped views
        mirrored, scaled ones divided by their scale), merged, decoded."""
        mcfg, pcfg, views = self.cfg.model, self.cfg.post, self.views
        W = mcfg.input_size[1]
        B = out["cls_logits"].shape[0] // len(views)

        def per_view(v):
            return v.split(B)

        cls_logits = torch.cat(per_view(out["cls_logits"]), 1)  # [B,VA,nc]
        if mcfg.task == "pose":
            flip_idx = _flip_index_on(self.kpt_flip_idx, out["kpts"].device)
            bs, ks = [], []
            for (scale, flip), b, k in zip(
                    views, per_view(out["boxes_xywh"]), per_view(out["kpts"])):
                if flip:
                    b = torch.cat([W - b[..., 0:1], b[..., 1:]], -1)
                    k = torch.cat([W - k[..., 0:1], k[..., 1:]], -1)
                    k = k.index_select(2, flip_idx)
                bs.append(b / scale)
                ks.append(torch.cat([k[..., :2] / scale, k[..., 2:]], -1))
            det = postprocess_pose_batch(torch.cat(bs, 1), cls_logits,
                                         torch.cat(ks, 1), pcfg,
                                         scores_are_logits=True)
        elif mcfg.task == "obb":
            bs = []
            for (scale, flip), b in zip(views, per_view(out["boxes_xywhr"])):
                if flip:
                    b = torch.cat(
                        [W - b[..., 0:1], b[..., 1:4], -b[..., 4:5]], -1)
                bs.append(torch.cat([b[..., :4] / scale, b[..., 4:]], -1))
            det = postprocess_obb_batch(torch.cat(bs, 1), cls_logits, pcfg,
                                        scores_are_logits=True)
        else:
            bs = []
            for (scale, flip), b in zip(views, per_view(out["boxes_xywh"])):
                if flip:
                    b = torch.cat([W - b[..., 0:1], b[..., 1:]], -1)
                bs.append(b / scale)
            coefs = protos = None
            if mcfg.task == "segment":
                coefs = torch.cat(per_view(out["mask_coefs"]), 1)
                protos = [p.flip(2) if flip else p for (_, flip), p
                          in zip(views, per_view(out["protos"]))]
            return _merge_sources(self, torch.cat(bs, 1), cls_logits, coefs,
                                  protos)
        det["slate"] = pack_slate(det, pcfg.max_detections)
        return det


def _merge_sources(pipe: CompiledPipeline, boxes, cls_logits, coefs, protos
                   ) -> Dict[str, torch.Tensor]:
    """The candidates of several sources (TTA views or ensemble members,
    A anchors each, concatenated along the anchor axis) in one merge by
    cfg.post. With `protos` (one per source) each survivor's mask is made
    against the protos of its own source (indices // A)."""
    mcfg, dt = pipe.cfg.model, pipe.mask_dtype
    det = postprocess_batch_parts(
        boxes, cls_logits, coefs, protos[0] if protos else None,
        pipe.cfg.post, False, mcfg.input_size, mask_dtype=dt,
        scores_are_logits=True, with_masks=False)
    if protos:
        det.pop("protos", None)
        c = det["coefs"].to(dt)
        A = boxes.shape[1] // len(protos)
        source = (det["indices"] // A)[..., None, None]        # [B,D,1,1]
        m = mask_ops.synthesize_masks(c, protos[0].to(dt))
        for i in range(1, len(protos)):
            mi = mask_ops.synthesize_masks(c, protos[i].to(dt))
            m = torch.where(source == i, mi, m)
        if pipe.crop_masks:
            m = mask_ops.crop_masks(m, det["boxes_xywh"], mcfg.input_size)
        if pipe.mask_display_hw is not None:
            m = upsample_masks(m, pipe.mask_display_hw)
        det["masks"] = m.to(dt)
    det["slate"] = pack_slate(det, pipe.cfg.post.max_detections)
    return det


class EnsemblePipeline(CompiledPipeline):
    """A model ensemble as one frame -> detections program: `params` is the
    tuple of member modules, each built for its own ModelConfig
    (build_ensemble_pipeline)."""

    def forward(self, x: torch.Tensor):
        """Every member's raw-head dict on the same frames."""
        return [m(x, concat_preds=False) for m in self.params]

    def decode(self, outs) -> Dict[str, torch.Tensor]:
        """The members' candidates merged (A -> M*A) and decoded."""
        coefs = protos = None
        if self.cfg.model.task == "segment":
            coefs = torch.cat([o["mask_coefs"] for o in outs], 1)
            protos = [o["protos"] for o in outs]
        return _merge_sources(
            self, torch.cat([o["boxes_xywh"] for o in outs], 1),
            torch.cat([o["cls_logits"] for o in outs], 1), coefs, protos)


def build_ensemble_pipeline(cfg: ExecutorConfig, params_list,
                            model_cfgs=None, *,
                            frame_hw: Optional[Tuple[int, int]] = None,
                            batch: Optional[int] = None,
                            resize_mode: str = "stretch",
                            crop_masks: bool = False,
                            mask_dtype: str = "float32",
                            device="cuda") -> EnsemblePipeline:
    """A model ensemble in one program (the JAX package's
    build_ensemble_pipeline): every member's forward runs on the same
    preprocessed frames, the candidates concatenate along the anchor axis
    (A -> M*A) and merge through cfg.post: merge="wbf" fuses what the
    members agree on (K5 at M*A on the card), "nms" keeps the best single
    candidate (K1 at M*A).

    params_list: YOLO11 modules; model_cfgs: their ModelConfigs when the
    members differ in scale (n + s + ...; the same task, classes and input
    size, validated as in the JAX package), else cfg.model for each.
    Segment masks stay exact per member: each survivor synthesizes against
    its own member's protos (indices // A), as TTA does per view."""
    mcfg = cfg.model
    yolo11.refuse_arch(mcfg, "the model ensemble", ("sam",))
    model_cfgs = list(model_cfgs or [mcfg] * len(params_list))
    if len(model_cfgs) != len(params_list) or not params_list:
        raise ValueError("params_list and model_cfgs must be equal-length"
                         " and non-empty")
    for mc in model_cfgs:
        if (mc.task, mc.num_classes, mc.input_size) != \
                (mcfg.task, mcfg.num_classes, mcfg.input_size):
            raise ValueError("ensemble members must share task/classes/"
                             f"input_size; got {mc.task}/{mc.num_classes}"
                             f"/{mc.input_size} vs {mcfg.task}/"
                             f"{mcfg.num_classes}/{mcfg.input_size}")
    if mcfg.task not in ("detect", "segment"):
        raise ValueError("ensemble pipeline supports detect/segment"
                         f" (got {mcfg.task!r})")
    _check_merge(cfg.post)
    dev = resolve_device(device)
    members = tuple(
        bind_params(dataclasses.replace(cfg, model=mc), p, None).to(dev)
        .eval() for p, mc in zip(params_list, model_cfgs))
    B = batch or cfg.batch_size
    fh, fw = frame_hw or mcfg.input_size
    return EnsemblePipeline(
        cfg=cfg, params=members, input_shape=(B, fh, fw, 3), device=dev,
        resize_mode=resize_mode, crop_masks=crop_masks,
        mask_dtype=getattr(torch, mask_dtype),
        readback=Readback(B * slate_length(cfg.post.max_detections), dev))


@dataclasses.dataclass(kw_only=True)
class SAMPipeline(CompiledPipeline):
    """Segment Anything, box-prompted, as one frame program: frames and
    boxes -> a mask, an IoU and the low-resolution logits for each box.

    Its input is a tuple (frames uint8 [B, H, W, 3], boxes [B, P, 4] xyxy
    in frame pixels), staged through `device.Upload` as two planes. `run`
    is preprocess (ops/preprocess.sam_preprocess, sam_boxes) -> the image
    encoder -> the prompt encoder and the mask decoder -> the masks at the
    frame's size (ops/masks.sam_postprocess_masks); the last three inside a
    profiler range `xrseg.sam_decoder` while a profiler records. No NMS and
    no slate: the output holds masks uint8 [B, P, H, W] (logit > 0), iou
    [B, P] float32 and low_res_logits [B, P, 4g, 4g] float32 (mask 0 and
    IoU 0 of the four), and `slate`, the three packed as bytes into one
    row a frame ([B, row_bytes] uint8: iou | logits | masks), the one copy
    `readback` (a uint8 Readback) takes to the host; `unpack_rows` splits
    it back."""
    prompts: int

    @property
    def spec(self):
        return self.params.spec

    @property
    def row_bytes(self) -> int:
        """Bytes of one frame's packed row."""
        P, (H, W), lr = self.prompts, self.input_shape[1:3], \
            self.spec.low_res
        return P * 4 + P * lr * lr * 4 + P * H * W

    def upload(self, frames):
        """(frames, boxes) on the device, staged as two planes."""
        return self._stage(tuple(frames))

    def run(self, frames: torch.Tensor, boxes: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        x, b = self.preprocess(frames, boxes)
        emb = self.params.encode(x)
        with sam.profiler_range("xrseg.sam_decoder"):
            return self.decode(self.params.decode(emb, b))

    def preprocess(self, frames: torch.Tensor, boxes: torch.Tensor):
        """The encoder's input [B, S, S, 3] (compute dtype) and the boxes
        in its pixels."""
        S = self.spec.img_size
        x = pre_ops.sam_preprocess(frames, S, sam.PIXEL_MEAN, sam.PIXEL_STD,
                                   self.params.dtype)
        return x, pre_ops.sam_boxes(boxes, tuple(frames.shape[1:3]), S)

    def decode(self, out) -> Dict[str, torch.Tensor]:
        """The decoder's four masks and IoUs -> mask 0 at the frame's
        size, its IoU and logits, and the packed rows."""
        B, P = out["iou"].shape[:2]
        hw, S = tuple(self.input_shape[1:3]), self.spec.img_size
        low = out["masks"][:, :, 0].float()
        iou = out["iou"][:, :, 0].contiguous()
        masks = (mask_ops.sam_postprocess_masks(
            low, pre_ops.sam_input_hw(hw, S), hw, S) > 0).to(torch.uint8)
        slate = torch.cat([iou.view(torch.uint8).reshape(B, -1),
                           low.view(torch.uint8).reshape(B, -1),
                           masks.reshape(B, -1)], 1)
        return {"masks": masks, "iou": iou, "low_res_logits": low,
                "slate": slate}

    def unpack_rows(self, rows: np.ndarray, out) -> Dict[str, Any]:
        """The packed rows [B, row_bytes] -> copies: iou [B, P] and
        low_res_logits [B, P, 4g, 4g] float32, masks [B, P, H, W] uint8."""
        B, P, lr = rows.shape[0], self.prompts, self.spec.low_res
        a, b = P * 4, P * 4 + P * lr * lr * 4
        return {"iou": np.array(rows[:, :a]).view(np.float32).reshape(B, P),
                "low_res_logits": np.array(rows[:, a:b]).view(
                    np.float32).reshape(B, P, lr, lr),
                "masks": np.array(rows[:, b:]).reshape(
                    B, P, *self.input_shape[1:3])}

    def dummy_input(self):
        """Zero frames, each box the whole frame."""
        B, H, W, _ = self.input_shape
        boxes = np.tile(np.array([0, 0, W, H], np.float32),
                        (B, self.prompts, 1))
        return np.zeros(self.input_shape, np.uint8), boxes

    def warmup(self) -> "SAMPipeline":
        """Run one dummy batch and read its rows back (SAM launches no
        kernel of this repository, so nothing is built)."""
        self(self.dummy_input())["slate"].cpu()
        return self


def _build_sam_pipeline(cfg: ExecutorConfig, params, *,
                       frame_hw: Optional[Tuple[int, int]] = None,
                       batch: Optional[int] = None,
                       prompts_per_frame: Optional[int] = None,
                       device="cuda", refused=()) -> SAMPipeline:
    """build_pipeline for arch "sam": `params` a models.sam.SAM built for
    cfg.model, frames [batch, *frame_hw, 3] with prompts_per_frame boxes
    each. `refused` names build_pipeline options that were given: SAM has
    none of them."""
    if cfg.model.arch != "sam":
        raise ValueError(f"prompts_per_frame is for arch 'sam', not "
                         f"{cfg.model.arch!r}")
    if refused:
        raise ValueError(f"arch 'sam' takes none of the options "
                         f"{sorted(refused)}")
    if not prompts_per_frame or prompts_per_frame < 1:
        raise ValueError("arch 'sam' needs prompts_per_frame >= 1 (the "
                         "boxes a frame)")
    if not isinstance(params, sam.SAM):
        raise TypeError("arch 'sam' needs a models.sam.SAM")
    if params.cfg != cfg.model:
        raise ValueError("params were built for another ModelConfig")
    dev = resolve_device(device)
    B = batch or cfg.batch_size
    fh, fw = frame_hw or cfg.model.input_size
    pipe = SAMPipeline(cfg=cfg, params=params.to(dev).eval(),
                       input_shape=(B, fh, fw, 3), device=dev,
                       prompts=int(prompts_per_frame))
    pipe.readback = Readback(B * pipe.row_bytes, dev, torch.uint8)
    return pipe


def bind_params(cfg: ExecutorConfig, params, params_dtype
                ) -> yolo11.YOLO11:
    """Check that `params` is a YOLO11 built for cfg.model and apply the
    weight-storage dtype (a cast copy; the caller's module is untouched)."""
    if not isinstance(params, yolo11.YOLO11):
        raise TypeError("params must be a YOLO11 module (JAX params go "
                        "through xrseg_tpu_torch.io.bridge.params_from_jax)")
    if params.cfg != cfg.model:
        raise ValueError("params were built for another ModelConfig")
    if params_dtype is not None:
        params = cast_params(params, params_dtype)
    return params


def decode_task_outputs(out, mcfg: ModelConfig, pcfg: PostprocessConfig, *,
                        crop_masks: bool = False, mask_dtype=torch.float32,
                        emit_masks: str = "all",
                        mask_display_hw: Optional[Tuple[int, int]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Raw forward outputs (concat_preds=False) -> the detection dict with
    the packed slate. The obb and pose branches, like the JAX ones, leave
    the NMS backend to their postprocess's own "auto" (K3 and K1 on CUDA
    tensors); classify returns logits and probs, its slate the prob row;
    outputs of the one-to-one head (ModelConfig.o2o) take the NMS-free
    selection. mask_display_hw resizes the masks last."""
    yolo11.check_supported(mcfg)
    if mcfg.task == "classify":
        # the classify slate IS the prob row
        return {"logits": out["logits"], "probs": out["probs"],
                "slate": out["probs"]}
    if mcfg.task == "pose":
        det = postprocess_pose_batch(out["boxes_xywh"], out["cls_logits"],
                                     out["kpts"], pcfg,
                                     scores_are_logits=True)
    elif mcfg.task == "obb":
        det = postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                    pcfg, scores_are_logits=True)
    else:
        o2o = "o2o_boxes_xywh" in out
        decode = postprocess_o2o_batch if o2o else postprocess_batch_parts
        det = decode(
            out["o2o_boxes_xywh" if o2o else "boxes_xywh"],
            out["o2o_cls_logits" if o2o else "cls_logits"],
            out.get("mask_coefs"), out.get("protos"), pcfg, crop_masks,
            mcfg.input_size, mask_dtype=mask_dtype, scores_are_logits=True,
            with_masks=(emit_masks == "all"))
    if mask_display_hw is not None and "masks" in det:
        det["masks"] = upsample_masks(det["masks"],
                                      mask_display_hw).to(mask_dtype)
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


def task_slate_length(mcfg: ModelConfig, max_det: int) -> int:
    """Floats in one image's slate row for mcfg's task: the prob row's nc
    for classify, else slate_length with 5-wide boxes for obb."""
    if mcfg.task == "classify":
        return mcfg.num_classes
    return slate_length(max_det, 5 if mcfg.task == "obb" else 4)


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


@dataclasses.dataclass(kw_only=True)
class XRTickPipeline(CompiledPipeline):
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
    packed flags. The frame's part is CompiledPipeline's, coefs only.
    """
    depth_hw: Tuple[int, int]
    slate_len: int
    mask_hw: Optional[Tuple[int, int]]   # None = mask not emitted
    n_points: int

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
        return self.enqueue(self.upload(frames, depth_fp16, aux))

    def upload(self, frames, depth_fp16, aux):
        """The three on the device, as `run` takes them."""
        depth = depth_fp16.to(self.device) \
            if isinstance(depth_fp16, torch.Tensor) \
            else df.depth_bits(depth_fp16, self.device)
        return to_device(frames, self.device), depth, \
            to_device(aux, self.device)

    def run(self, x: torch.Tensor, depth: torch.Tensor, aux: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        """The tick on tensors that already lie on the device (uint8
        frames, int16 depth bits, f32 aux). Nothing in here reads a value
        back or depends on a device value in Python, so the host only
        queues work."""
        mcfg, dcfg = self.cfg.model, self.cfg.depth
        det = super().run(x)
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
        self.readback.release()
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
    rendering; headless consumers skip it. params_dtype sets the weight
    storage, as in build_pipeline.
    """
    mcfg = cfg.model
    yolo11.refuse_arch(mcfg, "the XR tick")
    if mcfg.task != "segment":
        raise ValueError(f"fused_tick requires task='segment', "
                         f"got {mcfg.task!r}")
    _check_merge(cfg.post)
    params = bind_params(cfg, params, params_dtype)
    dev = resolve_device(device)
    fh, fw = frame_hw or mcfg.input_size
    mh4, mw4 = mcfg.mask_size
    step = cfg.depth.sampling_step
    pipe = XRTickPipeline(
        cfg=cfg, params=params.to(dev).eval(), input_shape=(1, fh, fw, 3),
        device=dev, emit_masks="none", depth_hw=tuple(depth_hw),
        slate_len=slate_length(cfg.post.max_detections),
        mask_hw=(mh4, mw4) if emit_target_mask else None,
        n_points=(mh4 // step) * (mw4 // step))
    pipe.readback = Readback(pipe.packed_len, dev)
    return pipe


def load_model(cfg: ExecutorConfig, params: Optional[yolo11.YOLO11] = None,
               seed: int = 0, device="cuda", **kw) -> CompiledPipeline:
    """Build (random weights from `seed` when params is None), then warm up."""
    if params is None:
        params = yolo11.init_params(torch.Generator().manual_seed(seed),
                                    cfg.model)
    return build_pipeline(cfg, params, device=device, **kw).warmup()


# ---------------------------------------------------------------------------
# The compiled artifact and the converter CLI
# ---------------------------------------------------------------------------

ARTIFACT_META = "xrseg.json"         # the artifact's own entry: its geometry


class _Program(torch.nn.Module):
    """A pipeline's run() as a module with its weights registered, so that
    torch.export lifts them into the program."""

    def __init__(self, pipe: CompiledPipeline):
        super().__init__()
        params = pipe.params
        self.models = torch.nn.ModuleList(
            params if isinstance(params, tuple) else (params,))
        self.pipe = pipe

    def forward(self, *frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.pipe.run(*frames)


def export_compiled(pipe: CompiledPipeline, path: str) -> None:
    """Serialize the frame -> detections pipeline, weights inside, to one
    artifact (the JAX package's StableHLO export, here a torch.export
    program written by torch.export.save). The NMS and WBF kernels are
    torch.library custom ops, so on the card the program holds the
    kernels themselves; on the CPU it holds their plain versions. The
    program runs on the pipeline's device at its batch and frame size;
    load_compiled reads it back."""
    pipe(pipe.dummy_input())         # the cached device constants, for real
    frames = pipe.upload(pipe.dummy_input())
    frames = frames if isinstance(frames, tuple) else (frames,)
    with torch.no_grad(), precision_scope(pipe.cfg.model.matmul_precision):
        program = torch.export.export(_Program(pipe), frames, strict=False)
    meta = {"device": str(pipe.device), "input_shape": pipe.input_shape,
            "input_format": pipe.input_format,
            "matmul_precision": pipe.cfg.model.matmul_precision,
            "cfg": dataclasses.asdict(pipe.cfg)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:      # a file object: any name, not only .pt2
        torch.export.save(program, f,
                          extra_files={ARTIFACT_META: json.dumps(meta)})


def load_compiled(path: str):
    """Load an export_compiled artifact. Returns fn(frames) -> the
    detection dict; frames (numpy or tensors, uint8 [B,H,W,3] or the three
    yuv420 planes) are moved to the device the artifact was made for."""
    extra = {ARTIFACT_META: ""}
    with open(path, "rb") as f:
        program = torch.export.load(f, extra_files=extra).module()
    meta = json.loads(extra[ARTIFACT_META])
    dev = resolve_device(meta["device"])

    def run(frames) -> Dict[str, torch.Tensor]:
        frames = tuple(frames) if meta["input_format"] == "yuv420" \
            else (frames,)
        with torch.no_grad(), precision_scope(meta["matmul_precision"]):
            return program(*(to_device(f, dev) for f in frames))

    run.meta = meta
    return run


def _main(argv: Optional[Sequence[str]] = None) -> int:
    """Offline model converter:

      python -m xrseg_tpu_torch.compile weights.{pt|onnx|npz|sentis} \\
          --out model.xrseg [--scale n] [--iou 0.6] [--score 0.23] \\
          [--frame-hw 480 640] [--batch 1] [--device cuda]

    Loads the weights, builds preprocess + network + decode + NMS + masks
    as one pipeline on --device and saves it with export_compiled. With an
    .onnx --out it writes an ultralytics-contract ONNX file instead
    (io/onnx_export, on the host), the format the reference's Unity
    converter consumes."""
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("weights")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--task", default="segment",
                    choices=["segment", "detect"])
    ap.add_argument("--classes", type=int, default=80,
                    help="num classes (npz checkpoints carry no metadata; "
                         ".pt infers it)")
    ap.add_argument("--size", type=int, default=640,
                    help="input size (multiple of 32)")
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--score", type=float, default=0.23)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device the artifact runs on (default: the "
                         "card); an .onnx --out is written on the host")
    args = ap.parse_args(argv)

    params, mcfg = load_params_auto(
        args.weights, ModelConfig(arch=args.arch, scale=args.scale,
                                  task=args.task, num_classes=args.classes,
                                  input_size=(args.size, args.size)))
    if args.out.endswith(".onnx"):
        export_onnx(params, mcfg, args.out)
        print(f"exported {args.weights} -> {args.out} "
              f"({os.path.getsize(args.out) / 1e6:.1f} MB, ONNX opset 13)")
        return 0
    cfg = ExecutorConfig(model=mcfg, post=PostprocessConfig(
        iou_threshold=args.iou, score_threshold=args.score))
    pipe = build_pipeline(cfg, params, frame_hw=(tuple(args.frame_hw)
                                                 if args.frame_hw else None),
                          batch=args.batch, device=args.device)
    export_compiled(pipe, args.out)
    print(f"compiled {args.weights} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, {pipe.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
