"""YOLO11 building blocks as torch modules (counterpart of xrseg_tpu/models/layers.py).

Activations are NCHW inside the network; the model's public functions keep
the JAX package's NHWC layout. Module and parameter names mirror the JAX
params pytree key for key ("w" -> "weight", "b" -> "bias"), so
io/bridge.py maps one onto the other without a lookup table.

Numerics follow the JAX `conv_apply`: the convolution runs in the compute
dtype, then bias and SiLU are applied in float32 and the result is rounded
once to the compute dtype. A torch bf16 convolution returns bf16, so the
port rounds one extra time (before the bias) in bf16 mode; in float32 mode
the two compute the same function.

Every parameter is stored in float32 and cast to the compute dtype at use,
as the JAX code does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """Conv2d (explicit k//2 padding) + folded-BN bias + optional SiLU.

    weight: [c2, c1/groups, k, k] (OIHW), bias: [c2]."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c2, c1 // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(c2))
        self.stride, self.groups, self.act, self.dtype = s, groups, act, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_apply(self, x, self.weight, self.bias, self.groups)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Kaiming-uniform weight, zero bias (a fresh BN folds to identity)."""
        c2, ci, k, _ = self.weight.shape
        bound = math.sqrt(1.0 / (ci * k * k)) * math.sqrt(3.0)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            self.bias.zero_()


def conv_apply(conv: Conv, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, groups: int) -> torch.Tensor:
    """`conv`'s function (stride, activation, dtype) with the given weight,
    bias and group count: Conv.forward, and parallel/batch.py's tensor
    parallelism, which runs a conv on a slice of its channels."""
    k = weight.shape[-1]
    y = F.conv2d(x.to(conv.dtype), weight.to(conv.dtype), None,
                 conv.stride, k // 2, 1, groups)
    y = y.float() + bias.float()[:, None, None]
    if conv.act:
        y = F.silu(y)
    return y.to(conv.dtype)


def conv_transpose_apply(proto: "Proto", y: torch.Tensor,
                         up_w: torch.Tensor, up_b: torch.Tensor
                         ) -> torch.Tensor:
    """The Proto's k=2 s=2 transposed conv with the given weight [in,
    out, 2, 2] and bias (a slice of its output channels, for parallel/)."""
    y = F.conv_transpose2d(y, up_w.to(proto.dtype), None, stride=2)
    return (y.float() + up_b.float()[:, None, None]).to(proto.dtype)


class HeadConv(Conv):
    """Final 1x1 projection of a detect/segment branch: no BN, no act."""

    def __init__(self, c1: int, c2: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(c1, c2, 1, act=False, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = math.sqrt(1.0 / self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound * math.sqrt(3.0),
                                 bound * math.sqrt(3.0), generator=gen)
            self.bias.uniform_(-bound, bound, generator=gen)


def dwconv(c: int, k: int = 3, act: bool = True,
           dtype: torch.dtype = torch.bfloat16) -> Conv:
    """Depthwise conv (groups == channels)."""
    return Conv(c, c, k, groups=c, act=act, dtype=dtype)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, k=(3, 3), e: float = 0.5,
                 shortcut: bool = True, dtype=torch.bfloat16):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], dtype=dtype)
        self.cv2 = Conv(c_, c2, k[1], dtype=dtype)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if self.shortcut and x.shape[1] == y.shape[1]:
            y = x + y
        return y


class C3k(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 k: int = 3, shortcut: bool = True, dtype=torch.bfloat16):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, dtype=dtype)
        self.cv2 = Conv(c1, c_, 1, dtype=dtype)
        self.cv3 = Conv(2 * c_, c2, 1, dtype=dtype)
        self.m = nn.ModuleList(Bottleneck(c_, c_, (k, k), 1.0, shortcut, dtype)
                               for _ in range(n))

    def forward(self, x):
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], 1))


class C3k2(nn.Module):
    """C2f whose inner blocks are C3k (c3k=True) or Bottleneck(e=0.5).

    YOLO11 runs every C3k2 with shortcut=True, the neck's included.
    `inner_e` is the plain Bottleneck's hidden ratio: 0.5 in YOLO11's
    C3k2, 1.0 in YOLOv8's C2f (class C2f)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True, dtype=torch.bfloat16,
                 inner_e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, dtype=dtype)
        self.cv2 = Conv((2 + n) * c, c2, 1, dtype=dtype)
        if c3k:
            blocks = (C3k(c, c, 2, shortcut=shortcut, dtype=dtype)
                      for _ in range(n))
        else:
            blocks = (Bottleneck(c, c, (3, 3), inner_e, shortcut, dtype)
                      for _ in range(n))
        self.m = nn.ModuleList(blocks)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        outs = [a, b]
        for blk in self.m:
            b = blk(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, 1))


class C2f(C3k2):
    """YOLOv8's C2f block: C3k2's split/append/concat topology (the JAX
    package runs it through c3k2_apply) with plain Bottlenecks of e=1.0,
    hidden width c rather than c/2. v8 runs its backbone C2f blocks with
    the shortcut and its neck blocks without."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 shortcut: bool = True, dtype=torch.bfloat16):
        super().__init__(c1, c2, n, False, e, shortcut, dtype, inner_e=1.0)


class SPPF(nn.Module):
    """Three chained 5x5 stride-1 max pools; max_pool2d pads with -inf,
    the JAX reduce_window's init value."""

    def __init__(self, c1: int, c2: int, k: int = 5, dtype=torch.bfloat16):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, dtype=dtype)
        self.cv2 = Conv(c_ * 4, c2, 1, dtype=dtype)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Multi-head spatial attention over the HxW grid (matmul + softmax).

    The qkv channels are split per head after reshaping the channels-last
    map to [B, N, nh, 2*kd + hd], exactly as the JAX code does: an NCHW
    split along the channel axis would take q, k, v from the wrong
    channels. Both products take compute-dtype operands and accumulate
    in float32, as the JAX einsums with preferred_element_type=f32 do."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5,
                 dtype=torch.bfloat16):
        super().__init__()
        head_dim = dim // num_heads
        self.num_heads = num_heads
        self.key_dim = int(head_dim * attn_ratio)
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False, dtype=dtype)
        self.proj = Conv(dim, dim, 1, act=False, dtype=dtype)
        self.pe = dwconv(dim, 3, act=False, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        B, C, H, W = x.shape
        nh, kd = self.num_heads, self.key_dim
        hd = C // nh
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(B, H * W, nh,
                                                      2 * kd + hd)
        q, k, v = qkv.split([kd, kd, hd], dim=-1)           # [B,N,nh,*]
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = (attn * kd ** -0.5).softmax(-1).to(self.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        o = o.to(self.dtype).reshape(B, H, W, C).permute(0, 3, 1, 2)
        v = v.reshape(B, H, W, nh * hd).permute(0, 3, 1, 2)
        return self.proj(o + self.pe(v))


class PSABlock(nn.Module):
    def __init__(self, c: int, dtype=torch.bfloat16):
        super().__init__()
        self.attn = Attention(c, max(1, c // 64), dtype=dtype)
        self.ffn1 = Conv(c, c * 2, 1, dtype=dtype)
        self.ffn2 = Conv(c * 2, c, 1, act=False, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int = 1, e: float = 0.5,
                 dtype=torch.bfloat16):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, dtype=dtype)
        self.cv2 = Conv(2 * self.c, c1, 1, dtype=dtype)
        self.m = nn.ModuleList(PSABlock(self.c, dtype) for _ in range(n))

    def forward(self, x):
        a, b = self.cv1(x).split([self.c, self.c], 1)
        for blk in self.m:
            b = blk(b)
        return self.cv2(torch.cat([a, b], 1))


class Proto(nn.Module):
    """Mask prototype head: conv, k=2 s=2 transposed conv (exact x2
    upsample), conv, conv -> [B, nm, H/4, W/4].

    up_w is torch's ConvTranspose2d layout [in, out, kH, kW]. The JAX
    package stores it as [kH, kW, in, out] and feeds it, IO-swapped, to
    lax.conv_transpose(transpose_kernel=True), which is torch's
    ConvTranspose2d; io/bridge.py permutes (2, 3, 0, 1) and
    tests/test_torch_layers.py proves the two agree."""

    def __init__(self, c1: int, c_: int = 256, nm: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3, dtype=dtype)
        self.cv2 = Conv(c_, c_, 3, dtype=dtype)
        self.cv3 = Conv(c_, nm, 1, dtype=dtype)
        self.up_w = nn.Parameter(torch.zeros(c_, c_, 2, 2))
        self.up_b = nn.Parameter(torch.zeros(c_))
        self.dtype = dtype

    def forward(self, x):
        y = conv_transpose_apply(self, self.cv1(x), self.up_w, self.up_b)
        return self.cv3(self.cv2(y))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = math.sqrt(1.0 / (self.up_w.shape[0] * 4)) * math.sqrt(3.0)
        with torch.no_grad():
            self.up_w.uniform_(-bound, bound, generator=gen)
            self.up_b.zero_()


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of an NCHW map."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def reset_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """Initialise every parameterised block of `model` from `gen`, in
    module registration order (deterministic for a given seed)."""
    for m in model.modules():
        if isinstance(m, (Conv, Proto)):
            m.reset_parameters(gen)
