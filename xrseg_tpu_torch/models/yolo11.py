"""YOLO11 detect/segment network as a torch module (counterpart of
xrseg_tpu/models/yolo11.py).

`YOLO11(cfg)(x)` takes NHWC input [B, H, W, 3] and returns the JAX
package's raw-head dict: boxes_xywh [B,A,4] f32 (input pixels), scores
[B,A,nc] f32, cls_logits [B,A,nc] in the compute dtype; for the segment
task mask_coefs [B,A,nm] f32 and protos [B,H/4,W/4,nm] f32; for the obb
task angle [B,A] f32 (radians) and boxes_xywhr [B,A,5] f32 (the rotated
boxes). With concat_preds also preds: [B,A,4+nc(+nm)], or [xywh of the
rotated box, scores, angle] for obb. The anchor axis is P3, P4, P5,
row-major within a level, channels last: each level's NCHW map is
permuted to NHWC before it is flattened.

With cfg.o2o (detect and segment) a second detect head, det_o2o, of the
same structure runs beside det and adds o2o_boxes_xywh [B,A,4] and
o2o_cls_logits [B,A,nc]: the NMS-free one-to-one head
(ops/postprocess.postprocess_o2o_batch).

This slice ports arch "yolo11" with tasks "segment", "detect" and "obb".
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.precision import precision_scope

# scale: (depth_mult, width_mult, max_channels) — the standard YOLO11 ladder.
YOLO11_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what this slice of the port does not run yet."""
    if cfg.arch != "yolo11":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP queue 1, "
            "task family: the YOLOv8 arch)")
    if cfg.task not in ("segment", "detect", "obb"):
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (ROADMAP queue 1, "
            "task family)")
    if cfg.o2o and cfg.task not in ("detect", "segment"):
        raise ValueError(
            f"o2o (NMS-free) supports detect/segment, not {cfg.task}")


class Spec:
    """Resolved channel/repeat plan for one scale."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        if cfg.scale not in YOLO11_SCALES:
            raise ValueError(f"Unknown yolo11 scale {cfg.scale!r}; expected "
                             f"one of {sorted(YOLO11_SCALES)}")
        if cfg.input_size[0] % 32 or cfg.input_size[1] % 32:
            raise ValueError(f"input_size {cfg.input_size} must be a "
                             "multiple of 32 (the P5 stride)")
        depth, width, max_ch = YOLO11_SCALES[cfg.scale]
        self.force_c3k = cfg.scale in ("m", "l", "x")

        def ch(c: int) -> int:
            return make_divisible(min(c, max_ch) * width, 8)

        self.c64, self.c128, self.c256 = ch(64), ch(128), ch(256)
        self.c512, self.c1024 = ch(512), ch(1024)
        self.n2 = max(round(2 * depth), 1)
        nc, reg_max = cfg.num_classes, cfg.reg_max
        self.head_ch = (self.c256, self.c512, self.c1024)   # P3, P4, P5
        self.c2 = max(16, self.head_ch[0] // 4, reg_max * 4)
        self.c3 = max(self.head_ch[0], min(nc, 100))
        self.c4 = max(self.head_ch[0] // 4, cfg.num_masks)
        self.c4_obb = max(self.head_ch[0] // 4, 1)         # angle branch
        self.proto_c = ch(256)
        self.strides = (8, 16, 32)

    def c3k(self, flag: bool) -> bool:
        return True if self.force_c3k else flag


class Branch3(nn.Module):
    """Per-level (conv3x3, conv3x3, 1x1 out) branch: the box branch of the
    detect head, the mask-coefficient branch and the obb angle branch."""

    def __init__(self, c1: int, c_hidden: int, c_out: int, dtype):
        super().__init__()
        self.conv0 = L.Conv(c1, c_hidden, 3, dtype=dtype)
        self.conv1 = L.Conv(c_hidden, c_hidden, 3, dtype=dtype)
        self.out = L.HeadConv(c_hidden, c_out, dtype=dtype)

    def forward(self, x):
        return self.out(self.conv1(self.conv0(x)))


class ClsBranch(nn.Module):
    """YOLO11's depthwise-separable class branch."""

    def __init__(self, c1: int, c3: int, nc: int, dtype):
        super().__init__()
        self.dw0 = L.dwconv(c1, 3, dtype=dtype)
        self.pw0 = L.Conv(c1, c3, 1, dtype=dtype)
        self.dw1 = L.dwconv(c3, 3, dtype=dtype)
        self.pw1 = L.Conv(c3, c3, 1, dtype=dtype)
        self.out = L.HeadConv(c3, nc, dtype=dtype)

    def hidden(self, x):
        return self.pw1(self.dw1(self.pw0(self.dw0(x))))

    def forward(self, x):
        return self.out(self.hidden(x))


class DetectHead(nn.Module):
    def __init__(self, s: Spec, cfg: ModelConfig, dtype):
        super().__init__()
        self.cv2 = nn.ModuleList(Branch3(ci, s.c2, 4 * cfg.reg_max, dtype)
                                 for ci in s.head_ch)
        self.cv3 = nn.ModuleList(ClsBranch(ci, s.c3, cfg.num_classes, dtype)
                                 for ci in s.head_ch)


def make_anchors(input_size: Tuple[int, int], strides=(8, 16, 32)
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor cell centres (grid units) [A,2] and per-anchor stride [A,1];
    level order P3, P4, P5, row-major within a level."""
    pts, strs = [], []
    H, W = input_size
    for s in strides:
        h, w = H // s, W // s
        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                             indexing="ij")
        pts.append(np.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        strs.append(np.full((h * w, 1), s, np.float32))
    return np.concatenate(pts).astype(np.float32), np.concatenate(strs)


def dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution Focal Loss decode: [B,A,4*reg_max] -> [B,A,4] ltrb.
    The expectation is an elementwise product and sum, so it stays float32
    whatever the TF32 switches say."""
    B, A, _ = box_logits.shape
    probs = box_logits.reshape(B, A, 4, reg_max).float().softmax(-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=probs.device)
    return (probs * bins).sum(-1)


def decode_rbox(ltrb: torch.Tensor, angle: torch.Tensor,
                anchors: torch.Tensor, strides: torch.Tensor) -> torch.Tensor:
    """DFL ltrb distances [B,A,4] + angle [B,A] -> rotated boxes [B,A,5]
    (cx, cy, w, h in input pixels, angle in radians), ultralytics
    dist2rbox: the centre offset rotates by the angle; w and h stay
    axis-local."""
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    c, s = torch.cos(angle), torch.sin(angle)
    off = (rb - lt) * 0.5
    xf, yf = off[..., 0], off[..., 1]
    x = xf * c - yf * s
    y = xf * s + yf * c
    xy = (torch.stack([x, y], -1) + anchors) * strides
    wh = (lt + rb) * strides
    return torch.cat([xy, wh, angle[..., None]], -1)


def _flatten(maps, c: int) -> torch.Tensor:
    """Per-level NCHW maps -> [B, A, c] in anchor order (channels last)."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, c)
                      for m in maps], 1)


class YOLO11(nn.Module):
    """The YOLO11 detect/segment/obb network at one scale."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s = Spec(cfg)
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.dtype = cfg, dt
        self.b0 = L.Conv(3, s.c64, 3, 2, dtype=dt)
        self.b1 = L.Conv(s.c64, s.c128, 3, 2, dtype=dt)
        self.b2 = L.C3k2(s.c128, s.c256, s.n2, s.c3k(False), 0.25, dtype=dt)
        self.b3 = L.Conv(s.c256, s.c256, 3, 2, dtype=dt)
        self.b4 = L.C3k2(s.c256, s.c512, s.n2, s.c3k(False), 0.25, dtype=dt)
        self.b5 = L.Conv(s.c512, s.c512, 3, 2, dtype=dt)
        self.b6 = L.C3k2(s.c512, s.c512, s.n2, True, 0.5, dtype=dt)
        self.b7 = L.Conv(s.c512, s.c1024, 3, 2, dtype=dt)
        self.b8 = L.C3k2(s.c1024, s.c1024, s.n2, True, 0.5, dtype=dt)
        self.b9 = L.SPPF(s.c1024, s.c1024, dtype=dt)
        self.b10 = L.C2PSA(s.c1024, s.n2, 0.5, dtype=dt)
        self.h13 = L.C3k2(s.c1024 + s.c512, s.c512, s.n2, s.c3k(False), 0.5,
                          dtype=dt)
        self.h16 = L.C3k2(s.c512 + s.c512, s.c256, s.n2, s.c3k(False), 0.5,
                          dtype=dt)
        self.h17 = L.Conv(s.c256, s.c256, 3, 2, dtype=dt)
        self.h19 = L.C3k2(s.c256 + s.c512, s.c512, s.n2, s.c3k(False), 0.5,
                          dtype=dt)
        self.h20 = L.Conv(s.c512, s.c512, 3, 2, dtype=dt)
        self.h22 = L.C3k2(s.c512 + s.c1024, s.c1024, s.n2, True, 0.5,
                          dtype=dt)
        self.det = DetectHead(s, cfg, dt)
        if cfg.o2o:
            self.det_o2o = DetectHead(s, cfg, dt)
        if cfg.task == "segment":
            self.proto = L.Proto(s.head_ch[0], s.proto_c, cfg.num_masks, dt)
            self.seg_cv4 = nn.ModuleList(
                Branch3(ci, s.c4, cfg.num_masks, dt) for ci in s.head_ch)
        elif cfg.task == "obb":
            self.obb_cv4 = nn.ModuleList(
                Branch3(ci, s.c4_obb, 1, dt) for ci in s.head_ch)
        anchors, strides = make_anchors(cfg.input_size, s.strides)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.register_buffer("strides", torch.from_numpy(strides),
                             persistent=False)

    def backbone_neck(self, x: torch.Tensor):
        """NCHW input -> (P3, P4, P5) features."""
        x = self.b2(self.b1(self.b0(x)))
        x4 = self.b4(self.b3(x))
        x6 = self.b6(self.b5(x4))
        x10 = self.b10(self.b9(self.b8(self.b7(x6))))
        x13 = self.h13(torch.cat([L.upsample2x_nearest(x10), x6], 1))
        x16 = self.h16(torch.cat([L.upsample2x_nearest(x13), x4], 1))
        x19 = self.h19(torch.cat([self.h17(x16), x13], 1))
        x22 = self.h22(torch.cat([self.h20(x19), x10], 1))
        return x16, x19, x22

    def _detect(self, head: DetectHead, feats):
        """One detect head: (DFL ltrb [B,A,4], xywh [B,A,4] in input
        pixels, class logits [B,A,nc] in the compute dtype)."""
        cfg = self.cfg
        box_flat = _flatten([b(f) for b, f in zip(head.cv2, feats)],
                            4 * cfg.reg_max)
        cls_flat = _flatten([c(f) for c, f in zip(head.cv3, feats)],
                            cfg.num_classes)
        ltrb = dfl_decode(box_flat, cfg.reg_max)
        x1y1 = self.anchors - ltrb[..., :2]
        x2y2 = self.anchors + ltrb[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) * 0.5 * self.strides,
                          (x2y2 - x1y1) * self.strides], -1)
        return ltrb, xywh, cls_flat

    def head_outputs(self, feats, concat_preds: bool = True
                     ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        ltrb, xywh, cls_flat = self._detect(self.det, feats)
        scores = torch.sigmoid(cls_flat.float())
        out = {"boxes_xywh": xywh, "scores": scores, "cls_logits": cls_flat}
        if cfg.o2o:
            _, out["o2o_boxes_xywh"], out["o2o_cls_logits"] = self._detect(
                self.det_o2o, feats)
        if cfg.task == "segment":
            protos = self.proto(feats[0])
            mc = _flatten([m(f) for m, f in zip(self.seg_cv4, feats)],
                          cfg.num_masks)
            out["mask_coefs"] = mc.float()
            out["protos"] = protos.permute(0, 2, 3, 1).float().contiguous()
            if concat_preds:
                out["preds"] = torch.cat([xywh, scores, out["mask_coefs"]], -1)
        elif cfg.task == "obb":
            raw = _flatten([m(f) for m, f in zip(self.obb_cv4, feats)], 1)
            # ultralytics OBB: angle = (sigmoid(raw) - 0.25) * pi, decoded
            # before the box (the ltrb offsets rotate by it)
            angle = (torch.sigmoid(raw[..., 0].float()) - 0.25) * math.pi
            out["boxes_xywhr"] = decode_rbox(ltrb, angle, self.anchors,
                                             self.strides)
            out["angle"] = angle
            if concat_preds:
                out["preds"] = torch.cat([out["boxes_xywhr"][..., :4], scores,
                                          angle[..., None]], -1)
        elif concat_preds:
            out["preds"] = torch.cat([xywh, scores], -1)
        return out

    def forward(self, x: torch.Tensor, concat_preds: bool = True
                ) -> Dict[str, torch.Tensor]:
        """x: NHWC [B, H, W, 3] -> raw-head dict (module docstring)."""
        if tuple(x.shape[1:3]) != tuple(self.cfg.input_size):
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"cfg.input_size {self.cfg.input_size} "
                             "(NHWC expected)")
        with precision_scope(self.cfg.matmul_precision):
            feats = self.backbone_neck(x.permute(0, 3, 1, 2).to(self.dtype))
            return self.head_outputs(feats, concat_preds)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> YOLO11:
    """A freshly initialised YOLO11 on the CPU. Kaiming-uniform convs and
    the standard YOLO head-bias recipe, drawn from `gen` (the numbers
    differ from the JAX package's; tests carry JAX weights across with
    io/bridge.py instead)."""
    model = YOLO11(cfg)
    L.reset_parameters(model, gen)
    nc = cfg.num_classes
    heads = [model.det] + ([model.det_o2o] if cfg.o2o else [])
    with torch.no_grad():
        for head in heads:
            for i, stride in enumerate((8, 16, 32)):
                head.cv2[i].out.bias.fill_(1.0)
                head.cv3[i].out.bias.fill_(
                    math.log(5 / nc / (640 / stride) ** 2))
    return model


def count_params(model: nn.Module) -> int:
    """Number of parameter values (the JAX package's leaf-size sum)."""
    return sum(p.numel() for p in model.parameters())
