"""YOLO11, YOLOv8 and YOLO12 networks as torch modules (counterpart of
xrseg_tpu/models/yolo11.py).

`YOLO11(cfg)(x)` takes NHWC input [B, H, W, 3] and returns the JAX
package's raw-head dict: boxes_xywh [B,A,4] f32 (input pixels), scores
[B,A,nc] f32, cls_logits [B,A,nc] in the compute dtype; for the segment
task mask_coefs [B,A,nm] f32 and protos [B,H/4,W/4,nm] f32; for the obb
task angle [B,A] f32 (radians) and boxes_xywhr [B,A,5] f32 (the rotated
boxes); for the pose task kpts [B,A,K,D] f32 (decoded keypoints, input
pixels, visibility as a probability when D == 3). With concat_preds also
preds: [B,A,4+nc(+nm)], [B,A,4+nc+K*D] for pose, or [xywh of the rotated
box, scores, angle] for obb. The anchor axis is P3, P4, P5, row-major
within a level, channels last: each level's [B, C, H, W] map is permuted
to NHWC before it is flattened (a view: the maps are channels-last in
memory; models/layers.py). The classify task returns logits [B,nc] and
probs [B,nc] (softmax), both f32.

With cfg.o2o (detect and segment) a second detect head, det_o2o, of the
same structure runs beside det and adds o2o_boxes_xywh [B,A,4] and
o2o_cls_logits [B,A,nc]: the NMS-free one-to-one head
(ops/postprocess.postprocess_o2o_batch).

`YOLO11.forward_train(x)` is the training forward (JAX yolo11.forward_train):
raw float32 box_logits [B,A,4*reg_max] and cls_logits [B,A,nc], decoded
boxes_xywh, and per task mask_coefs/protos, kpts or boxes_xywhr/angle, plus
o2o_box_logits/o2o_cls_logits/o2o_boxes_xywh with cfg.o2o; the classify
task returns the head's logits and probs. Its anchors follow the batch's
own (H, W), so multi-scale batches need no config of their own.

Both archs of the JAX package ("yolo11", "yolov8") and every task of
it ("segment", "detect", "obb", "pose", "classify") are ported. The port
adds "yolo12" (Ultralytics yolo12-seg.yaml: area attention in A2C2f
blocks at P4 and P5), for the segment and detect tasks only; the JAX
package has no twin of it.
"""
from __future__ import annotations

import copy
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


# The published YOLOv8 ladder (cfg.arch == "yolov8"): C2f blocks (inner
# Bottleneck e=1.0), no C2PSA, 3/6/6/3 backbone repeats, a plain-conv class
# branch, shortcut-free neck blocks.
YOLOV8_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}


# The published YOLO12 ladder (cfg.arch == "yolo12", yolo12-seg.yaml): at
# l and x every A2C2f takes residual=True and mlp_ratio=1.2, at m, l and x
# every C3k2 runs C3k (Ultralytics parse_model).
YOLO12_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

SCALES = {"yolo11": YOLO11_SCALES, "yolov8": YOLOV8_SCALES,
          "yolo12": YOLO12_SCALES}


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the JAX package refuses: an unknown arch or scale, and
    the one-to-one head (o2o) with a task that has no detect head to pair
    it with (the classify init ignores o2o, as JAX's does); and yolo12
    with a task other than segment and detect. The port also builds
    yolo12 (YOLO12_SCALES), which the JAX package has not; the message for
    an unknown arch stays the JAX package's."""
    if cfg.arch not in SCALES:
        raise ValueError(
            f"Unknown arch {cfg.arch!r}; expected 'yolo11' or 'yolov8'")
    table = SCALES[cfg.arch]
    if cfg.scale not in table:
        raise ValueError(f"Unknown {cfg.arch} scale {cfg.scale!r}; expected "
                         f"one of {sorted(table)}")
    if cfg.arch == "yolo12" and cfg.task not in ("segment", "detect"):
        raise ValueError(f"arch 'yolo12' runs the segment and detect tasks, "
                         f"not {cfg.task!r}")
    if cfg.o2o and cfg.task not in ("detect", "segment", "classify"):
        raise ValueError(
            f"o2o (NMS-free) supports detect/segment, not {cfg.task}")


def refuse_yolo12(cfg: ModelConfig, path: str) -> None:
    """Raise for a path that knows only the YOLO11 and YOLOv8 layers (a
    weight format, a parallel layout, a pipeline variant) when cfg is a
    yolo12: it would build, load or split the wrong network."""
    if cfg.arch == "yolo12":
        raise ValueError(f"{path} does not support arch 'yolo12' (it runs "
                         "build_pipeline and StreamingRunner, segment and "
                         "detect)")


class Spec:
    """Resolved channel/repeat plan for one scale."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        if cfg.input_size[0] % 32 or cfg.input_size[1] % 32:
            raise ValueError(f"input_size {cfg.input_size} must be a "
                             "multiple of 32 (the P5 stride)")
        self.arch = cfg.arch
        depth, width, max_ch = SCALES[cfg.arch][cfg.scale]
        # the wide scales force C3k blocks (v8 has none)
        self.force_c3k = cfg.arch != "yolov8" and cfg.scale in ("m", "l", "x")
        # YOLO12's A2C2f at l and x: the gamma residual, a 1.2x MLP
        self.a2_residual = cfg.arch == "yolo12" and cfg.scale in ("l", "x")
        self.mlp_ratio = 1.2 if self.a2_residual else 2.0

        def ch(c: int) -> int:
            return make_divisible(min(c, max_ch) * width, 8)

        self.c64, self.c128, self.c256 = ch(64), ch(128), ch(256)
        self.c512, self.c1024 = ch(512), ch(1024)
        self.n2 = max(round(2 * depth), 1)
        self.n3 = max(round(3 * depth), 1)      # v8 backbone/neck repeats
        self.n6 = max(round(6 * depth), 1)
        self.n4 = max(round(4 * depth), 1)      # v12 backbone A2C2f repeats
        nc, reg_max = cfg.num_classes, cfg.reg_max
        self.head_ch = (self.c256, self.c512, self.c1024)   # P3, P4, P5
        self.c2 = max(16, self.head_ch[0] // 4, reg_max * 4)
        self.c3 = max(self.head_ch[0], min(nc, 100))
        self.c4 = max(self.head_ch[0] // 4, cfg.num_masks)
        self.c4_obb = max(self.head_ch[0] // 4, 1)         # angle branch
        self.nk = cfg.kpt_shape[0] * cfg.kpt_shape[1]
        self.c4_pose = max(self.head_ch[0] // 4, self.nk)  # keypoints
        self.cls_hidden = 1280                             # classify head
        self.proto_c = ch(256)
        self.strides = (8, 16, 32)

    def c3k(self, flag: bool) -> bool:
        return True if self.force_c3k else flag


class Branch3(nn.Module):
    """Per-level (conv3x3, conv3x3, 1x1 out) branch: the box branch of the
    detect head, the mask-coefficient, keypoint and obb angle branches,
    and YOLOv8's ("legacy") class branch."""

    def __init__(self, c1: int, c_hidden: int, c_out: int, dtype):
        super().__init__()
        self.conv0 = L.Conv(c1, c_hidden, 3, dtype=dtype)
        self.conv1 = L.Conv(c_hidden, c_hidden, 3, dtype=dtype)
        self.out = L.HeadConv(c_hidden, c_out, dtype=dtype)

    def hidden(self, x):
        return self.conv1(self.conv0(x))

    def forward(self, x):
        return self.out(self.hidden(x))


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
    """Box (cv2) and class (cv3) branches per level. The class branch is
    YOLO11's depthwise-separable one, or for v8 two plain 3x3 convs (the
    JAX package tells them apart by whether "dw0" is present)."""

    def __init__(self, s: Spec, cfg: ModelConfig, dtype):
        super().__init__()
        cls = Branch3 if s.arch == "yolov8" else ClsBranch
        self.cv2 = nn.ModuleList(Branch3(ci, s.c2, 4 * cfg.reg_max, dtype)
                                 for ci in s.head_ch)
        self.cv3 = nn.ModuleList(cls(ci, s.c3, cfg.num_classes, dtype)
                                 for ci in s.head_ch)


class ClassifyHead(nn.Module):
    """ultralytics Classify: Conv(c1, 1280, 1), a float32 mean over H and
    W, then `y @ lin_w + lin_b` in float32 (lin_w [1280, nc], the JAX
    layout)."""

    def __init__(self, c1: int, hidden: int, nc: int, dtype):
        super().__init__()
        self.conv = L.Conv(c1, hidden, 1, dtype=dtype)
        self.lin_w = nn.Parameter(torch.zeros(hidden, nc))
        self.lin_b = nn.Parameter(torch.zeros(nc))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.conv(x).float().mean((2, 3))
        logits = y @ self.lin_w.float() + self.lin_b.float()
        return {"logits": logits, "probs": logits.softmax(-1)}


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


def decode_kpts(kpt_flat: torch.Tensor, anchors: torch.Tensor,
                strides: torch.Tensor, kpt_shape) -> torch.Tensor:
    """Raw keypoint maps [B,A,K*D] -> decoded [B,A,K,D]: per keypoint
    xy = (raw*2 + anchor - 0.5) * stride (input pixels), visibility =
    sigmoid(raw) when D == 3 (ultralytics Pose.kpts_decode)."""
    B, A, _ = kpt_flat.shape
    K, D = kpt_shape
    y = kpt_flat.reshape(B, A, K, D)
    xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) \
        * strides[None, :, None, :]
    if D == 3:
        return torch.cat([xy, torch.sigmoid(y[..., 2:3])], -1)
    return xy


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


def _call(module: nn.Module, x):
    return module(x)


def _flatten(maps, c: int) -> torch.Tensor:
    """Per-level [B, c, H, W] maps -> [B, A, c] in anchor order (channels
    last; each level's permute a free view of a channels-last map)."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, c)
                      for m in maps], 1)


class YOLO11(nn.Module):
    """A YOLO11, YOLOv8 or YOLO12 network (cfg.arch) for one task at one
    scale."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s = Spec(cfg)
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.dtype = cfg, dt
        if s.arch == "yolov8":
            self._init_backbone_v8(s, dt, with_sppf=cfg.task != "classify")
        elif s.arch == "yolo12":
            self._init_backbone_v12(s, dt)
        else:
            self._init_backbone(s, dt)
        if cfg.task == "classify":
            self.cls_head = ClassifyHead(s.c1024, s.cls_hidden,
                                         cfg.num_classes, dt)
            return
        if s.arch == "yolov8":
            self._init_neck_v8(s, dt)
        elif s.arch == "yolo12":
            self._init_neck_v12(s, dt)
        else:
            self._init_neck(s, dt)
        self.det = DetectHead(s, cfg, dt)
        if cfg.o2o:
            self.det_o2o = DetectHead(s, cfg, dt)
        if cfg.task == "segment":
            self.proto = L.Proto(s.head_ch[0], s.proto_c, cfg.num_masks, dt)
            self.seg_cv4 = nn.ModuleList(
                Branch3(ci, s.c4, cfg.num_masks, dt) for ci in s.head_ch)
        elif cfg.task == "pose":
            self.pose_cv4 = nn.ModuleList(
                Branch3(ci, s.c4_pose, s.nk, dt) for ci in s.head_ch)
        elif cfg.task == "obb":
            self.obb_cv4 = nn.ModuleList(
                Branch3(ci, s.c4_obb, 1, dt) for ci in s.head_ch)
        anchors, strides = make_anchors(cfg.input_size, s.strides)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.register_buffer("strides", torch.from_numpy(strides),
                             persistent=False)
        # forward_train's anchors per (H, W, device), made on first use
        self._train_anchors: Dict[tuple, Tuple[torch.Tensor,
                                               torch.Tensor]] = {}

    def _init_backbone(self, s: Spec, dt) -> None:
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

    def _init_backbone_v8(self, s: Spec, dt, with_sppf: bool) -> None:
        """ultralytics yolov8.yaml layers 0-9: C2f blocks with 3/6/6/3
        repeats, channel-preserving (the downsampling convs widen), SPPF
        last and no C2PSA. v8-cls ends at the C2f(1024), with no SPPF."""
        self.b0 = L.Conv(3, s.c64, 3, 2, dtype=dt)
        self.b1 = L.Conv(s.c64, s.c128, 3, 2, dtype=dt)
        self.b2 = L.C2f(s.c128, s.c128, s.n3, dtype=dt)
        self.b3 = L.Conv(s.c128, s.c256, 3, 2, dtype=dt)
        self.b4 = L.C2f(s.c256, s.c256, s.n6, dtype=dt)
        self.b5 = L.Conv(s.c256, s.c512, 3, 2, dtype=dt)
        self.b6 = L.C2f(s.c512, s.c512, s.n6, dtype=dt)
        self.b7 = L.Conv(s.c512, s.c1024, 3, 2, dtype=dt)
        self.b8 = L.C2f(s.c1024, s.c1024, s.n3, dtype=dt)
        if with_sppf:
            self.b9 = L.SPPF(s.c1024, s.c1024, dtype=dt)

    def _init_backbone_v12(self, s: Spec, dt) -> None:
        """yolo12-seg.yaml layers 0-8: the P2 and P3 downsampling convs in
        2 and 4 groups, four A2C2f (area attention) at P4 in 4 row bands
        and at P5 over the whole map, no SPPF and no C2PSA."""
        self.b0 = L.Conv(3, s.c64, 3, 2, dtype=dt)
        self.b1 = L.Conv(s.c64, s.c128, 3, 2, groups=2, dtype=dt)
        self.b2 = L.C3k2(s.c128, s.c256, s.n2, s.c3k(False), 0.25, dtype=dt)
        self.b3 = L.Conv(s.c256, s.c256, 3, 2, groups=4, dtype=dt)
        self.b4 = L.C3k2(s.c256, s.c512, s.n2, s.c3k(False), 0.25, dtype=dt)
        self.b5 = L.Conv(s.c512, s.c512, 3, 2, dtype=dt)
        self.b6 = L.A2C2f(s.c512, s.c512, s.n4, True, 4, s.a2_residual,
                          s.mlp_ratio, dtype=dt)
        self.b7 = L.Conv(s.c512, s.c1024, 3, 2, dtype=dt)
        self.b8 = L.A2C2f(s.c1024, s.c1024, s.n4, True, 1, s.a2_residual,
                          s.mlp_ratio, dtype=dt)

    def _init_neck(self, s: Spec, dt) -> None:
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

    def _init_neck_v8(self, s: Spec, dt) -> None:
        """The v8 neck: shortcut-free C2f blocks; its h16 takes c512+c256
        (the backbone's P3 is c256 wide), YOLO11's c512+c512."""
        self.h13 = L.C2f(s.c1024 + s.c512, s.c512, s.n3, shortcut=False,
                         dtype=dt)
        self.h16 = L.C2f(s.c512 + s.c256, s.c256, s.n3, shortcut=False,
                         dtype=dt)
        self.h17 = L.Conv(s.c256, s.c256, 3, 2, dtype=dt)
        self.h19 = L.C2f(s.c256 + s.c512, s.c512, s.n3, shortcut=False,
                         dtype=dt)
        self.h20 = L.Conv(s.c512, s.c512, 3, 2, dtype=dt)
        self.h22 = L.C2f(s.c512 + s.c1024, s.c1024, s.n3, shortcut=False,
                         dtype=dt)

    def _init_neck_v12(self, s: Spec, dt) -> None:
        """yolo12-seg.yaml layers 9-20: A2C2f without attention (C3k
        modules) at layers 11, 14 and 17, C3k2 at layer 20."""
        self.h11 = L.A2C2f(s.c1024 + s.c512, s.c512, s.n2, False, dtype=dt)
        self.h14 = L.A2C2f(s.c512 + s.c512, s.c256, s.n2, False, dtype=dt)
        self.h15 = L.Conv(s.c256, s.c256, 3, 2, dtype=dt)
        self.h17 = L.A2C2f(s.c256 + s.c512, s.c512, s.n2, False, dtype=dt)
        self.h18 = L.Conv(s.c512, s.c512, 3, 2, dtype=dt)
        self.h20 = L.C3k2(s.c512 + s.c1024, s.c1024, s.n2, True, 0.5,
                          dtype=dt)

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [B, H, W, 3] frames -> the network's [B, 3, H, W] input in
        the compute dtype (the first step of every forward, split or not)."""
        return x.permute(0, 3, 1, 2).to(self.dtype)

    def backbone(self, x: torch.Tensor):
        """[B, 3, H, W] input -> the (x4, x6, x10) skip features: x10 is
        C2PSA's output for yolo11, SPPF's (or for v8-cls the last C2f's)
        for v8, the last A2C2f's (layer 8) for yolo12. The input is made
        channels-last here, and every map after it stays so."""
        x = self.b2(self.b1(self.b0(L.channels_last(x))))
        x4 = self.b4(self.b3(x))
        x6 = self.b6(self.b5(x4))
        x = self.b8(self.b7(x6))
        if hasattr(self, "b9"):
            x = self.b9(x)
        if hasattr(self, "b10"):
            x = self.b10(x)
        return x4, x6, x

    def backbone_neck(self, x: torch.Tensor):
        """[B, 3, H, W] input -> (P3, P4, P5) features."""
        return self.neck(self.backbone(x))

    def neck(self, feats):
        """The backbone's (x4, x6, x10) -> (P3, P4, P5) features: the stage
        boundary of parallel/pipeline.PipelinedRunner."""
        x4, x6, x10 = feats
        if self.cfg.arch == "yolo12":
            x11 = self.h11(torch.cat([L.upsample2x_nearest(x10), x6], 1))
            x14 = self.h14(torch.cat([L.upsample2x_nearest(x11), x4], 1))
            x17 = self.h17(torch.cat([self.h15(x14), x11], 1))
            x20 = self.h20(torch.cat([self.h18(x17), x10], 1))
            return x14, x17, x20
        x13 = self.h13(torch.cat([L.upsample2x_nearest(x10), x6], 1))
        x16 = self.h16(torch.cat([L.upsample2x_nearest(x13), x4], 1))
        x19 = self.h19(torch.cat([self.h17(x16), x13], 1))
        x22 = self.h22(torch.cat([self.h20(x19), x10], 1))
        return x16, x19, x22

    def _detect(self, head: DetectHead, feats, anchors=None, strides=None,
                apply=_call):
        """One detect head: (box logits [B,A,4*reg_max] and class logits
        [B,A,nc] in the compute dtype, DFL ltrb [B,A,4], xywh [B,A,4] in
        input pixels). The anchors default to those of cfg.input_size.
        `apply(branch, feat)` runs one branch on one level's features."""
        cfg = self.cfg
        anchors = self.anchors if anchors is None else anchors
        strides = self.strides if strides is None else strides
        box_flat = _flatten([apply(b, f) for b, f in zip(head.cv2, feats)],
                            4 * cfg.reg_max)
        cls_flat = _flatten([apply(c, f) for c, f in zip(head.cv3, feats)],
                            cfg.num_classes)
        ltrb = dfl_decode(box_flat, cfg.reg_max)
        x1y1 = anchors - ltrb[..., :2]
        x2y2 = anchors + ltrb[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) * 0.5 * strides,
                          (x2y2 - x1y1) * strides], -1)
        return box_flat, cls_flat, ltrb, xywh

    def _task_outputs(self, feats, ltrb, anchors, strides, apply=_call
                      ) -> Dict[str, torch.Tensor]:
        """The task head's float32 outputs: protos and mask_coefs
        (segment), decoded kpts (pose), boxes_xywhr and angle (obb)."""
        cfg = self.cfg
        if cfg.task == "segment":
            protos = apply(self.proto, feats[0])
            mc = _flatten([apply(m, f) for m, f in zip(self.seg_cv4, feats)],
                          cfg.num_masks)
            return {"mask_coefs": mc.float(),
                    "protos": protos.permute(0, 2, 3, 1).float().contiguous()}
        if cfg.task == "pose":
            nk = cfg.kpt_shape[0] * cfg.kpt_shape[1]
            kf = _flatten([apply(m, f) for m, f in zip(self.pose_cv4, feats)],
                          nk)
            return {"kpts": decode_kpts(kf.float(), anchors, strides,
                                        cfg.kpt_shape)}
        if cfg.task == "obb":
            raw = _flatten([apply(m, f) for m, f in zip(self.obb_cv4, feats)],
                           1)
            # ultralytics OBB: angle = (sigmoid(raw) - 0.25) * pi, decoded
            # before the box (the ltrb offsets rotate by it)
            angle = (torch.sigmoid(raw[..., 0].float()) - 0.25) * math.pi
            return {"boxes_xywhr": decode_rbox(ltrb, angle, anchors,
                                               strides), "angle": angle}
        return {}

    def head_outputs(self, feats, concat_preds: bool = True, apply=_call
                     ) -> Dict[str, torch.Tensor]:
        """(P3, P4, P5) -> the raw-head dict. `apply(branch, feat)` runs
        each per-level branch (and the Proto) and returns its [B, C, H, W]
        map; parallel/spatial.py passes one that runs it on row bands."""
        cfg = self.cfg
        _, cls_flat, ltrb, xywh = self._detect(self.det, feats, apply=apply)
        scores = torch.sigmoid(cls_flat.float())
        out = {"boxes_xywh": xywh, "scores": scores, "cls_logits": cls_flat}
        if cfg.o2o:
            _, out["o2o_cls_logits"], _, out["o2o_boxes_xywh"] = self._detect(
                self.det_o2o, feats, apply=apply)
        out.update(self._task_outputs(feats, ltrb, self.anchors,
                                      self.strides, apply))
        if not concat_preds:
            return out
        if cfg.task == "segment":
            out["preds"] = torch.cat([xywh, scores, out["mask_coefs"]], -1)
        elif cfg.task == "pose":
            out["preds"] = torch.cat(
                [xywh, scores, out["kpts"].flatten(2)], -1)
        elif cfg.task == "obb":
            out["preds"] = torch.cat([out["boxes_xywhr"][..., :4], scores,
                                      out["angle"][..., None]], -1)
        else:
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
            x = self.to_input(x)
            if self.cfg.task == "classify":
                return self.cls_head(self.backbone(x)[2])
            return self.head_outputs(self.backbone_neck(x), concat_preds)

    def _anchors_for(self, hw: Tuple[int, int], device: torch.device):
        """(anchors [A,2], strides [A,1]) for an input of `hw` on `device`,
        made once per shape and device."""
        key = (int(hw[0]), int(hw[1]), device)
        hit = self._train_anchors.get(key)
        if hit is None:
            anchors, strides = make_anchors(key[:2])
            hit = (torch.from_numpy(anchors).to(device),
                   torch.from_numpy(strides).to(device))
            self._train_anchors[key] = hit
        return hit

    def forward_train(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The training forward (JAX yolo11.forward_train): x NHWC
        [B, H, W, 3] of any (H, W) that are multiples of 32 -> raw float32
        logits and decoded boxes on anchors of the batch's own (H, W)
        (module docstring). Nothing is sigmoided or concatenated."""
        cfg = self.cfg
        if x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 32 \
                or x.shape[2] % 32:
            raise ValueError(f"input {tuple(x.shape)}: expected NHWC "
                             "[B, H, W, 3] with H and W multiples of 32")
        H, W = int(x.shape[1]), int(x.shape[2])
        with precision_scope(cfg.matmul_precision):
            x = self.to_input(x)
            if cfg.task == "classify":
                return self.cls_head(self.backbone(x)[2])
            feats = self.backbone_neck(x)
            anchors, strides = self._anchors_for((H, W), x.device)
            box_flat, cls_flat, ltrb, xywh = self._detect(
                self.det, feats, anchors, strides)
            out = {"box_logits": box_flat.float(),
                   "cls_logits": cls_flat.float(), "boxes_xywh": xywh}
            if cfg.o2o:
                obox, ocls, _, oxywh = self._detect(self.det_o2o, feats,
                                                    anchors, strides)
                out.update(o2o_box_logits=obox.float(),
                           o2o_cls_logits=ocls.float(),
                           o2o_boxes_xywh=oxywh)
            out.update(self._task_outputs(feats, ltrb, anchors, strides))
        return out


def raw_outputs_onnx_layout(out: Dict[str, torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference ONNX layout of a forward's preds and protos:
    ([B,116,A], [B,nm,H,W]) (IEModelEditorConverter.cs:50-58)."""
    return out["preds"].transpose(1, 2), out["protos"].permute(0, 3, 1, 2)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> YOLO11:
    """A freshly initialised YOLO11 on the CPU. Kaiming-uniform convs and
    the standard YOLO head-bias recipe, drawn from `gen` (the numbers
    differ from the JAX package's; tests carry JAX weights across with
    io/bridge.py instead)."""
    model = YOLO11(cfg)
    L.reset_parameters(model, gen)
    nc = cfg.num_classes
    if cfg.task == "classify":
        bound = math.sqrt(3.0 / model.cls_head.lin_w.shape[0])
        with torch.no_grad():
            model.cls_head.lin_w.uniform_(-bound, bound, generator=gen)
        return model
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


def model_info(cfg: ModelConfig, model: nn.Module | None = None,
               device="cuda") -> Dict[str, object]:
    """Model summary (the JAX package's model_info, ultralytics'
    `model.info()`): scale, task, input size, parameter count and anchors,
    and `gflops`, the multiply-adds x 2 that torch's FlopCounterMode counts
    in one forward at batch 1 on `device` (convolutions and matmuls; JAX
    reads XLA's cost analysis instead, so the two are readings of the same
    work, not equal numbers). `model` defaults to a fresh
    init_params(seed 0); a model on another device is copied there, not
    moved."""
    from torch.utils.flop_counter import FlopCounterMode

    from xrseg_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if model is None:
        model = init_params(torch.Generator().manual_seed(0), cfg)
    n_params = count_params(model)
    if next(model.parameters()).device.type != dev.type:
        model = copy.deepcopy(model).to(dev)
    x = torch.zeros((1,) + tuple(cfg.input_size) + (3,), device=dev)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return {"scale": cfg.scale, "task": cfg.task,
            "input_size": tuple(cfg.input_size),
            "params": n_params, "params_m": round(n_params / 1e6, 3),
            "anchors": cfg.num_anchors,
            "gflops": round(counter.get_total_flops() / 1e9, 2)}


def yolo11_for_state(cfg: ModelConfig, state: Dict[str, torch.Tensor]
                     ) -> YOLO11:
    """YOLO11(cfg) with each detect head's class branches built to the
    shapes in `state` (a state dict), then `state` loaded strictly: a
    missing or extra parameter, or a wrong shape, raises.

    A model that io/weights.transfer_params grafted keeps its donor's
    class-branch hidden stack (dw0, pw0, dw1, pw1) when the class count
    changes, and that stack's width c3 = max(P3 channels, min(nc, 100))
    follows the donor's class count, not cfg's; the JAX package's forward
    reads any width from its pytree, a module needs it at construction."""
    model = YOLO11(cfg)
    s = Spec(cfg)
    for head in ("det", "det_o2o"):
        if cfg.task == "classify" or not hasattr(model, head):
            continue
        cv3 = getattr(model, head).cv3
        for i in range(len(cv3)):
            pre = f"{head}.cv3.{i}."
            kind, hid = ((ClsBranch, "pw1") if pre + "dw0.weight" in state
                         else (Branch3, "conv1"))
            w = state.get(f"{pre}{hid}.weight")
            if w is None:
                continue                       # the strict load reports it
            if isinstance(cv3[i], kind) and \
                    cv3[i].out.weight.shape[1] == w.shape[0]:
                continue
            cv3[i] = kind(s.head_ch[i], int(w.shape[0]), cfg.num_classes,
                          model.dtype)
    model.load_state_dict(state, strict=True)
    return model
