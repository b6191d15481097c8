"""The plain float32 YOLO11 segment network: the benchmark's reference.

Written from Ultralytics' published `yolo11-seg.yaml` and its modules
(Conv, C3k2, C3k, Bottleneck, SPPF, C2PSA/PSABlock/Attention, Segment,
Proto), with batch norm folded into each conv's bias. It imports nothing
of the program under test: the weights are a plain state dict whose
names follow the program's (`b0.weight`, `det.cv3.0.out.bias`, ...), so
the benchmark can hand the one state dict it made to both sides.

Everything runs in float32 with TF32 off (`float32_scope`). `quant`
selects a fake-quantized variant, the control of the correctness check:
"bf16" rounds every conv and matmul operand to bfloat16, "fp8" scales
each operand per tensor into float8 e4m3's range and rounds it there.

The same walk gives the parameter shapes (`param_specs`, on the meta
device) and the FLOP and byte count of one forward (`Counter`), both
from the configuration's shapes alone.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # float8 e4m3fn's largest finite value


@contextlib.contextmanager
def float32_scope():
    """Full float32 products: both TF32 switches off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_quant(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """`t` rounded as `quant` would store it, returned in float32."""
    if quant is None or t.device.type == "meta":
        return t
    if quant == "bf16":
        return t.to(torch.bfloat16).float()
    if quant == "fp8":
        scale = FP8_MAX / t.abs().amax().clamp_min(1e-30)
        q = (t * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
        return q.float() / scale
    raise ValueError(f"unknown quant {quant!r}")


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


class Plan:
    """Channel widths and repeats of one scale (the yaml's parse rules)."""

    def __init__(self, cfg: dict):
        depth, width = cfg["depth_multiple"], cfg["width_multiple"]
        max_ch = cfg["max_channels"]

        def ch(c: int) -> int:
            return make_divisible(min(c, max_ch) * width, 8)

        self.c64, self.c128, self.c256 = ch(64), ch(128), ch(256)
        self.c512, self.c1024 = ch(512), ch(1024)
        self.n2 = max(round(2 * depth), 1)
        # the wide scales run C3k inside every C3k2
        self.force_c3k = cfg["scale"] in ("m", "l", "x")
        nc, nm, reg_max = cfg["num_classes"], cfg["num_masks"], cfg["reg_max"]
        self.head_ch = (self.c256, self.c512, self.c1024)
        self.c2 = max(16, self.head_ch[0] // 4, reg_max * 4)
        self.c3 = max(self.head_ch[0], min(nc, 100))
        self.c4 = max(self.head_ch[0] // 4, nm)
        self.proto_c = ch(256)
        self.nc, self.nm, self.reg_max = nc, nm, reg_max
        self.strides = (8, 16, 32)


class Ops:
    """The network's primitive operations over a state dict.

    sd: name -> float32 tensor (None while `param_specs` records shapes on
    the meta device). count: called once per conv or matmul with
    (kind, flops, bytes_in, bytes_weight, bytes_out)."""

    def __init__(self, sd: Optional[Dict[str, torch.Tensor]],
                 quant: Optional[str] = None,
                 count: Optional[Callable] = None,
                 specs: Optional[List[Tuple[str, tuple, str]]] = None,
                 act_bytes: int = 2):
        self.sd, self.quant, self.count = sd, quant, count
        self.specs, self.act_bytes = specs, act_bytes

    def param(self, name: str, shape: tuple, kind: str) -> torch.Tensor:
        if self.specs is not None:
            self.specs.append((name, tuple(shape), kind))
            return torch.empty(shape, device="meta")
        t = self.sd[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the plan "
                             f"needs {tuple(shape)}")
        return t

    def conv(self, name: str, x: torch.Tensor, cout: int, k: int = 1,
             s: int = 1, groups: int = 1, act: bool = True,
             kind: str = "conv") -> torch.Tensor:
        cin = x.shape[1]
        w = self.param(f"{name}.weight", (cout, cin // groups, k, k), kind)
        b = self.param(f"{name}.bias", (cout,), kind)
        y = F.conv2d(fake_quant(x, self.quant), fake_quant(w, self.quant),
                     None, s, k // 2, 1, groups)
        if self.count is not None:
            B, _, H, W = x.shape
            Ho, Wo = y.shape[2:]
            ab = self.act_bytes
            self.count("conv", 2 * B * cout * Ho * Wo * (cin // groups) * k * k,
                       B * cin * H * W * ab, w.numel() * ab,
                       B * cout * Ho * Wo * ab)
        y = y + b[:, None, None]
        return F.silu(y) if act else y

    def conv_transpose2x(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Proto's k=2 s=2 transposed conv, weight [in, out, 2, 2]."""
        c = x.shape[1]
        w = self.param(f"{name}.up_w", (c, c, 2, 2), "up")
        b = self.param(f"{name}.up_b", (c,), "up")
        y = F.conv_transpose2d(fake_quant(x, self.quant),
                               fake_quant(w, self.quant), None, stride=2)
        if self.count is not None:
            B, _, H, W = x.shape
            ab = self.act_bytes
            self.count("conv_transpose", 2 * B * H * W * c * c * 4,
                       x.numel() * ab, w.numel() * ab, y.numel() * ab)
        return y + b[:, None, None]

    def bmm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        y = torch.einsum(eq, fake_quant(a, self.quant),
                         fake_quant(b, self.quant))
        if self.count is not None:
            contracted = _contracted_size(eq, a, b)
            ab = self.act_bytes
            self.count("matmul", 2 * y.numel() * contracted,
                       a.numel() * ab, b.numel() * ab, y.numel() * ab)
        return y


def _contracted_size(eq: str, a: torch.Tensor, b: torch.Tensor) -> int:
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    dims = dict(zip(sa, a.shape))
    dims.update(zip(sb, b.shape))
    n = 1
    for letter in set(sa + sb) - set(out):
        n *= dims[letter]
    return n


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def bottleneck(o: Ops, name: str, x, c2: int, e: float, shortcut: bool):
    c_ = int(c2 * e)
    y = o.conv(f"{name}.cv2", o.conv(f"{name}.cv1", x, c_, 3), c2, 3)
    return x + y if shortcut and x.shape[1] == c2 else y


def c3k(o: Ops, name: str, x, c2: int, n: int = 2, e: float = 0.5):
    c_ = int(c2 * e)
    y1 = o.conv(f"{name}.cv1", x, c_, 1)
    for i in range(n):
        y1 = bottleneck(o, f"{name}.m.{i}", y1, c_, 1.0, True)
    y2 = o.conv(f"{name}.cv2", x, c_, 1)
    return o.conv(f"{name}.cv3", torch.cat([y1, y2], 1), c2, 1)


def c3k2(o: Ops, name: str, x, c2: int, n: int, use_c3k: bool, e: float):
    c = int(c2 * e)
    y = o.conv(f"{name}.cv1", x, 2 * c, 1)
    a, b = y[:, :c], y[:, c:]
    outs = [a, b]
    for i in range(n):
        b = (c3k(o, f"{name}.m.{i}", b, c) if use_c3k
             else bottleneck(o, f"{name}.m.{i}", b, c, 0.5, True))
        outs.append(b)
    return o.conv(f"{name}.cv2", torch.cat(outs, 1), c2, 1)


def sppf(o: Ops, name: str, x, c2: int, k: int = 5):
    y = [o.conv(f"{name}.cv1", x, x.shape[1] // 2, 1)]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], k, 1, k // 2))
    return o.conv(f"{name}.cv2", torch.cat(y, 1), c2, 1)


def attention(o: Ops, name: str, x):
    """Ultralytics Attention: qkv viewed per head as [2*kd + hd] channels."""
    B, C, H, W = x.shape
    nh = max(1, C // 64)
    hd = C // nh
    kd = int(hd * 0.5)
    N = H * W
    qkv = o.conv(f"{name}.qkv", x, C + 2 * kd * nh, 1, act=False)
    qkv = qkv.reshape(B, nh, 2 * kd + hd, N)
    q, k, v = qkv.split([kd, kd, hd], dim=2)
    attn = o.bmm("bhdq,bhdk->bhqk", q, k) * (kd ** -0.5)
    attn = attn.softmax(-1)
    out = o.bmm("bhdk,bhqk->bhdq", v, attn).reshape(B, C, H, W)
    pe = o.conv(f"{name}.pe", v.reshape(B, C, H, W), C, 3, groups=C,
                act=False)
    return o.conv(f"{name}.proj", out + pe, C, 1, act=False)


def c2psa(o: Ops, name: str, x, n: int):
    c1 = x.shape[1]
    c = int(c1 * 0.5)
    y = o.conv(f"{name}.cv1", x, 2 * c, 1)
    a, b = y[:, :c], y[:, c:]
    for i in range(n):
        blk = f"{name}.m.{i}"
        b = b + attention(o, f"{blk}.attn", b)
        b = b + o.conv(f"{blk}.ffn2", o.conv(f"{blk}.ffn1", b, 2 * c, 1),
                       c, 1, act=False)
    return o.conv(f"{name}.cv2", torch.cat([a, b], 1), c1, 1)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def branch3(o: Ops, name: str, x, hidden: int, cout: int):
    y = o.conv(f"{name}.conv1", o.conv(f"{name}.conv0", x, hidden, 3),
               hidden, 3)
    return o.conv(f"{name}.out", y, cout, 1, act=False, kind="head")


def cls_branch(o: Ops, name: str, x, c3: int, nc: int):
    c1 = x.shape[1]
    y = o.conv(f"{name}.dw0", x, c1, 3, groups=c1)
    y = o.conv(f"{name}.pw0", y, c3, 1)
    y = o.conv(f"{name}.dw1", y, c3, 3, groups=c3)
    y = o.conv(f"{name}.pw1", y, c3, 1)
    return o.conv(f"{name}.out", y, nc, 1, act=False, kind="head")


def cls_hidden(o: Ops, name: str, x, c3: int):
    """The class branch up to (not including) its out conv."""
    c1 = x.shape[1]
    y = o.conv(f"{name}.dw0", x, c1, 3, groups=c1)
    y = o.conv(f"{name}.pw0", y, c3, 1)
    y = o.conv(f"{name}.dw1", y, c3, 3, groups=c3)
    return o.conv(f"{name}.pw1", y, c3, 1)


def backbone_neck(o: Ops, p: Plan, x):
    x = o.conv("b0", x, p.c64, 3, 2)
    x = o.conv("b1", x, p.c128, 3, 2)
    x = c3k2(o, "b2", x, p.c256, p.n2, p.force_c3k, 0.25)
    x4 = c3k2(o, "b4", o.conv("b3", x, p.c256, 3, 2), p.c512, p.n2,
              p.force_c3k, 0.25)
    x6 = c3k2(o, "b6", o.conv("b5", x4, p.c512, 3, 2), p.c512, p.n2, True,
              0.5)
    x = c3k2(o, "b8", o.conv("b7", x6, p.c1024, 3, 2), p.c1024, p.n2, True,
             0.5)
    x10 = c2psa(o, "b10", sppf(o, "b9", x, p.c1024), p.n2)
    x13 = c3k2(o, "h13", torch.cat([up2(x10), x6], 1), p.c512, p.n2,
               p.force_c3k, 0.5)
    x16 = c3k2(o, "h16", torch.cat([up2(x13), x4], 1), p.c256, p.n2,
               p.force_c3k, 0.5)
    x19 = c3k2(o, "h19", torch.cat([o.conv("h17", x16, p.c256, 3, 2), x13],
                                   1), p.c512, p.n2, p.force_c3k, 0.5)
    x22 = c3k2(o, "h22", torch.cat([o.conv("h20", x19, p.c512, 3, 2), x10],
                                   1), p.c1024, p.n2, True, 0.5)
    return x16, x19, x22


def _flat(maps: List[torch.Tensor]) -> torch.Tensor:
    """Per-level NCHW maps -> [B, A, C]: P3, P4, P5, row-major."""
    return torch.cat([m.flatten(2).transpose(1, 2) for m in maps], 1)


def anchors(input_hw, strides=(8, 16, 32), device="cpu"):
    """Anchor centres in grid units [A, 2] (x, y) and strides [A, 1]."""
    pts, strs = [], []
    for s in strides:
        h, w = input_hw[0] // s, input_hw[1] // s
        ys, xs = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                                torch.arange(w, device=device) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        strs.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts).float(), torch.cat(strs)


def forward(o: Ops, cfg: dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """NHWC float input in [0, 1] -> raw heads, all float32: boxes_xywh
    [B,A,4] (input pixels), cls_logits [B,A,nc], mask_coefs [B,A,nm],
    protos [B,h,w,nm]."""
    p = Plan(cfg)
    feats = backbone_neck(o, p, x.permute(0, 3, 1, 2))
    box = _flat([branch3(o, f"det.cv2.{i}", f, p.c2, 4 * p.reg_max)
                 for i, f in enumerate(feats)])
    cls = _flat([cls_branch(o, f"det.cv3.{i}", f, p.c3, p.nc)
                 for i, f in enumerate(feats)])
    mc = _flat([branch3(o, f"seg_cv4.{i}", f, p.c4, p.nm)
                for i, f in enumerate(feats)])
    y = o.conv("proto.cv1", feats[0], p.proto_c, 3)
    y = o.conv_transpose2x("proto", y)
    y = o.conv("proto.cv2", y, p.proto_c, 3)
    protos = o.conv("proto.cv3", y, p.nm, 1)
    B, A, _ = box.shape
    if box.device.type == "meta":
        xywh = torch.empty((B, A, 4), device="meta")
    else:
        # DFL: the expected bin of a softmax over reg_max bins per side
        prob = box.reshape(B, A, 4, p.reg_max).softmax(-1)
        bins = torch.arange(p.reg_max, dtype=torch.float32, device=box.device)
        ltrb = (prob * bins).sum(-1)
        pts, strides = anchors(cfg["input_size"], p.strides, box.device)
        x1y1, x2y2 = pts - ltrb[..., :2], pts + ltrb[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) * 0.5 * strides,
                          (x2y2 - x1y1) * strides], -1)
    return {"boxes_xywh": xywh, "cls_logits": cls, "mask_coefs": mc,
            "protos": protos.permute(0, 2, 3, 1)}


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in the forward's order;
    kind is "conv" (folded conv), "head" (a branch's last 1x1 conv) or
    "up" (the Proto's transposed conv)."""
    specs: List[Tuple[str, tuple, str]] = []
    x = torch.empty((1,) + tuple(cfg["input_size"]) + (3,), device="meta")
    forward(Ops(None, specs=specs), cfg, x)
    return specs


class Counter:
    """FLOPs and bytes of one forward, per conv or matmul, from shapes."""

    def __init__(self):
        self.layers: List[Tuple[str, int, int, int, int]] = []

    def __call__(self, kind, flops, b_in, b_w, b_out):
        self.layers.append((kind, int(flops), int(b_in), int(b_w), int(b_out)))

    @property
    def flops(self) -> int:
        return sum(layer[1] for layer in self.layers)


def count_forward(cfg: dict, batch: int = 1, act_bytes: int = 2) -> Counter:
    """The per-layer count of a forward at `batch`, on the meta device."""
    c = Counter()
    x = torch.empty((batch,) + tuple(cfg["input_size"]) + (3,),
                    device="meta")
    specs: List = []
    forward(Ops(None, count=c, specs=specs, act_bytes=act_bytes), cfg, x)
    return c
