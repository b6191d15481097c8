"""The plain float32 YOLO12 segment network: the reference of the
benchmark's YOLO12 cells.

Written from Ultralytics' published `yolo12-seg.yaml` and its modules
(AAttn, ABlock, A2C2f in `ultralytics/nn/modules/block.py`; Tian, Ye and
Doermann, "YOLOv12: Attention-Centric Real-Time Object Detectors",
arXiv:2502.12524), with batch norm folded into each conv's bias. The
convs, C3k2, C3k, the head's branches, the DFL decode and the operations
under them are `reference/yolo.py`'s (imported, not copied), so the fp8
control, `param_specs` and the FLOP count come from the same walk. It
imports nothing of the program under test; parameter names follow the
program's (`b6.m.0.1.attn.qkv.weight`, `b6.gamma`, ...).

Layer equations, per the yaml at scale [depth, width, max_channels]:

- backbone: Conv(64,3,2) -> Conv(128,3,2,g=2) -> C3k2(256,e=0.25) x2 ->
  Conv(256,3,2,g=4) -> C3k2(512,e=0.25) x2 -> Conv(512,3,2) ->
  A2C2f(512,a2,area=4) x4 (layer 6) -> Conv(1024,3,2) ->
  A2C2f(1024,a2,area=1) x4 (layer 8);
- neck: up(8) ++ 6 -> A2C2f(512) x2 (11); up(11) ++ 4 -> A2C2f(256) x2
  (14); Conv(256,3,2)(14) ++ 11 -> A2C2f(512) x2 (17); Conv(512,3,2)(17)
  ++ 8 -> C3k2(1024, c3k) x2 (20); Segment on (14, 17, 20), as YOLO11's;
- parse_model: C3k in every C3k2 at m, l and x; every A2C2f with
  residual=True and mlp_ratio=1.2 at l and x (else 2.0, no residual);
- A2C2f(c1, c2, n): c_ = c2/2; y = [cv1(x)]; each module maps y[-1] to
  the next y: two ABlock(c_, heads = c_/32) where a2, else C3k(c_, c_, 2);
  out = cv2(cat y), and x + gamma * out where a2 and residual;
- ABlock: x + AAttn(x), then x + Conv1x1(act=False)(Conv1x1 to
  int(c * mlp_ratio), SiLU)(x);
- AAttn (head_dim 32): qkv = Conv1x1(C -> 3C, act=False), tokens in
  row-major order, [B, N, 3C]; with area a > 1, [B*a, N/a, 3C]; per token
  the 3C channels read [heads, 3 * head_dim] and split into q, k, v per
  head; o = softmax(q^T k / sqrt(head_dim)) applied to v, an explicit
  matmul and softmax here; out = proj(o + pe(v)), pe a depthwise 7x7
  conv (act=False) on v laid back out as [B, C, H, W].

`area_attention` counts itself as the program runs it, one fused call
with no score matrix in device memory: 4 * B * a * heads * (N/a)^2 *
head_dim FLOPs (the two products), and q, k, v and o once each at the
activations' width.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import yolo
from benchmark.reference.yolo import (Ops, cls_hidden,  # noqa: F401
                                      float32_scope)

HEAD_DIM = 32


class Plan(yolo.Plan):
    """yolo.Plan's widths and head, with the A2C2f rules of the scale."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.n4 = max(round(4 * cfg["depth_multiple"]), 1)
        self.a2_residual = cfg["scale"] in ("l", "x")
        self.mlp_ratio = 1.2 if self.a2_residual else 2.0


def area_attention(o: Ops, q, k, v, scale: float):
    """q, k, v [B', heads, N', d] -> softmax(q k^T * scale) v, each product
    with its operands in `o.quant`, counted as one fused call."""
    s = torch.matmul(yolo.fake_quant(q, o.quant),
                     yolo.fake_quant(k, o.quant).transpose(-2, -1)) * scale
    p = s.softmax(-1)
    out = torch.matmul(yolo.fake_quant(p, o.quant),
                       yolo.fake_quant(v, o.quant))
    if o.count is not None:
        Bp, nh, n, d = q.shape
        ab = o.act_bytes
        o.count("attention", 4 * Bp * nh * n * n * d,
                3 * q.numel() * ab, 0, out.numel() * ab)
    return out


def aattn(o: Ops, name: str, x, area: int):
    B, C, H, W = x.shape
    nh, hd, N = C // HEAD_DIM, HEAD_DIM, H * W
    qkv = o.conv(f"{name}.qkv", x, 3 * C, 1, act=False)
    t = qkv.flatten(2).transpose(1, 2)                         # [B, N, 3C]
    if area > 1:
        t = t.reshape(B * area, N // area, 3 * C)
    Bp, n, _ = t.shape
    q, k, v = t.reshape(Bp, n, nh, 3 * hd).permute(0, 2, 1, 3).split(hd, -1)
    out = area_attention(o, q, k, v, hd ** -0.5)       # [B', heads, N', d]

    def image(z):
        return z.permute(0, 2, 1, 3).reshape(B, H, W, C).permute(0, 3, 1, 2)

    pe = o.conv(f"{name}.pe", image(v), C, 7, groups=C, act=False)
    return o.conv(f"{name}.proj", image(out) + pe, C, 1, act=False)


def ablock(o: Ops, name: str, x, area: int, mlp_ratio: float):
    c = x.shape[1]
    x = x + aattn(o, f"{name}.attn", x, area)
    h = o.conv(f"{name}.mlp.0", x, int(c * mlp_ratio), 1)
    return x + o.conv(f"{name}.mlp.1", h, c, 1, act=False)


def a2c2f(o: Ops, name: str, x, c2: int, n: int, a2: bool, area: int = 1,
          residual: bool = False, mlp_ratio: float = 2.0):
    c_ = c2 // 2
    y = [o.conv(f"{name}.cv1", x, c_, 1)]
    for i in range(n):
        if a2:
            z = y[-1]
            for j in range(2):
                z = ablock(o, f"{name}.m.{i}.{j}", z, area, mlp_ratio)
        else:
            z = yolo.c3k(o, f"{name}.m.{i}", y[-1], c_)
        y.append(z)
    out = o.conv(f"{name}.cv2", torch.cat(y, 1), c2, 1)
    if not (a2 and residual):
        return out
    gamma = o.param(f"{name}.gamma", (c2,), "gamma")
    return x + gamma[:, None, None] * out


def backbone_neck(o: Ops, p: Plan, x):
    res, ratio = p.a2_residual, p.mlp_ratio
    x = o.conv("b0", x, p.c64, 3, 2)
    x = o.conv("b1", x, p.c128, 3, 2, groups=2)
    x = yolo.c3k2(o, "b2", x, p.c256, p.n2, p.force_c3k, 0.25)
    x4 = yolo.c3k2(o, "b4", o.conv("b3", x, p.c256, 3, 2, groups=4), p.c512,
                   p.n2, p.force_c3k, 0.25)
    x6 = a2c2f(o, "b6", o.conv("b5", x4, p.c512, 3, 2), p.c512, p.n4, True, 4,
               res, ratio)
    x8 = a2c2f(o, "b8", o.conv("b7", x6, p.c1024, 3, 2), p.c1024, p.n4, True,
               1, res, ratio)
    x11 = a2c2f(o, "h11", torch.cat([yolo.up2(x8), x6], 1), p.c512, p.n2,
                False)
    x14 = a2c2f(o, "h14", torch.cat([yolo.up2(x11), x4], 1), p.c256, p.n2,
                False)
    x17 = a2c2f(o, "h17", torch.cat([o.conv("h15", x14, p.c256, 3, 2), x11],
                                    1), p.c512, p.n2, False)
    x20 = yolo.c3k2(o, "h20", torch.cat([o.conv("h18", x17, p.c512, 3, 2),
                                         x8], 1), p.c1024, p.n2, True, 0.5)
    return x14, x17, x20


def forward(o: Ops, cfg: dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """NHWC float input in [0, 1] -> raw heads, as yolo.forward gives
    them: the Segment head and its decode are YOLO11's."""
    p = Plan(cfg)
    feats = backbone_neck(o, p, x.permute(0, 3, 1, 2))
    return head(o, p, cfg, feats)


def head(o: Ops, p: Plan, cfg: dict, feats) -> Dict[str, torch.Tensor]:
    """yolo.forward's Segment head and decode (written inline there), on
    given (P3, P4, P5)."""
    box = yolo._flat([yolo.branch3(o, f"det.cv2.{i}", f, p.c2, 4 * p.reg_max)
                      for i, f in enumerate(feats)])
    cls = yolo._flat([yolo.cls_branch(o, f"det.cv3.{i}", f, p.c3, p.nc)
                      for i, f in enumerate(feats)])
    mc = yolo._flat([yolo.branch3(o, f"seg_cv4.{i}", f, p.c4, p.nm)
                     for i, f in enumerate(feats)])
    y = o.conv("proto.cv1", feats[0], p.proto_c, 3)
    y = o.conv_transpose2x("proto", y)
    y = o.conv("proto.cv2", y, p.proto_c, 3)
    protos = o.conv("proto.cv3", y, p.nm, 1)
    B, A, _ = box.shape
    if box.device.type == "meta":
        xywh = torch.empty((B, A, 4), device="meta")
    else:
        prob = box.reshape(B, A, 4, p.reg_max).softmax(-1)
        bins = torch.arange(p.reg_max, dtype=torch.float32, device=box.device)
        ltrb = (prob * bins).sum(-1)
        pts, strides = yolo.anchors(cfg["input_size"], p.strides, box.device)
        x1y1, x2y2 = pts - ltrb[..., :2], pts + ltrb[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) * 0.5 * strides,
                          (x2y2 - x1y1) * strides], -1)
    return {"boxes_xywh": xywh, "cls_logits": cls, "mask_coefs": mc,
            "protos": protos.permute(0, 2, 3, 1)}


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in the forward's order;
    kinds as yolo.param_specs's, and "gamma" (A2C2f's residual scale)."""
    specs: List[Tuple[str, tuple, str]] = []
    x = torch.empty((1,) + tuple(cfg["input_size"]) + (3,), device="meta")
    forward(Ops(None, specs=specs), cfg, x)
    return specs


def count_forward(cfg: dict, batch: int = 1, act_bytes: int = 2
                  ) -> yolo.Counter:
    """The per-layer count of a forward at `batch`, on the meta device."""
    c = yolo.Counter()
    x = torch.empty((batch,) + tuple(cfg["input_size"]) + (3,),
                    device="meta")
    forward(Ops(None, count=c, specs=[], act_bytes=act_bytes), cfg, x)
    return c
