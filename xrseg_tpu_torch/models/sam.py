"""Segment Anything (SAM) with a ViT image encoder, prompted by boxes, as
torch modules (`ModelConfig(arch="sam")`, scales b, l and h). The JAX
package has no twin of it.

Written from Kirillov et al., "Segment Anything" (arXiv:2304.02643) and
facebookresearch/segment-anything: `build_sam.py` (the scales, SAM_SCALES)
and `modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`
and `transformer.py`. Module and parameter names are the published
state dict's (`image_encoder.blocks.7.attn.rel_pos_h`,
`mask_decoder.transformer.layers.0.cross_attn_token_to_image.q_proj.weight`,
...).

- Image encoder: Conv2d(3, C, 16, stride 16) taken to NHWC, plus the
  absolute pos_embed [1, g, g, C]; `depth` blocks x + attn(LN(x)), then
  x + MLP(LN(x)), LN eps 1e-6, MLP Linear(C, 4C), exact-erf GELU,
  Linear(4C, C); the blocks at `global_attn_indexes` attend over the whole
  g x g map, the others over 14x14 windows of the normed map padded with
  zeros to a multiple of 14 (64 -> 70: 25 windows of 196 tokens, the pad
  tokens keys like any other). Attention: qkv Linear(C, 3C) to heads of
  C / heads, scores (q * hd^-0.5) k^T + rel_h[q, kh] + rel_w[q, kw] with
  rel_h = q . rel_pos_h[(q_i - k_j) + (k - 1)] (ops/attention), softmax,
  @ v, proj Linear(C, C). Neck: Conv1x1(C, 256, no bias), LayerNorm2d,
  Conv3x3(256, 256, no bias), LayerNorm2d (eps 1e-6).
- Prompt encoder: a box (xyxy in the 1024-pixel input) + 0.5, over
  1024, each corner [sin, cos](2 pi (2c - 1) @ G), G [2, 128]; corner 0
  plus point_embeddings[2], corner 1 plus point_embeddings[3]. The dense
  embedding is no_mask_embed over the g x g map; the image's positional
  encoding is the same encoding of the grid's centres ((i + 0.5) / g).
- Mask decoder: tokens [iou_token, 4 mask_tokens, the 2 corners]; src =
  the frame's embedding for each of its prompts + dense; a two-way
  transformer (depth 2, dim 256, 8 heads, MLP 2048 with ReLU, the
  cross-attentions at dim 128, LN eps 1e-5, the positional encodings
  added to q and k, never to v, block 0's self-attention without them
  and without its residual), a final token-to-image attention and norm;
  upscaling ConvT(256, 64, 2, 2), LayerNorm2d, GELU, ConvT(64, 32, 2, 2),
  GELU; four hypernetwork MLPs (256, 256, 32; ReLU) multiplied into the
  upscaled map: [N, 4, 4g, 4g] low-resolution logits; the IoU head MLP(256,
  256, 4). All four masks and IoUs are computed, as published.

Departures from the published model:
- Only box prompts: points (their labels, `not_a_point_embed`) and mask
  prompts (`mask_downscaling`) are not built. point_embeddings keeps all
  four rows so that 2 and 3, the box corners', keep their indexes.
- Compute in the config's dtype (bfloat16 on the card: activations,
  residual stream, the decoder's tokens), every parameter stored in
  float32 and cast at use, as the port's other networks do. The positional
  encodings (sin and cos of 2 pi times a Gaussian projection) are
  computed in float32 and rounded once to the compute dtype.
- The attention is ops/attention's fused call on the card (the bias
  materialised in the compute dtype, the softmax in SDPA's kernel), the
  plain float32 composition on the CPU.

A forward takes the preprocessed input [B, S, S, 3] (S = img_size, the
compute dtype; ops/preprocess.sam_preprocess) and the boxes [B, P, 4]
(xyxy in the same pixels; ops/preprocess.sam_boxes), P prompts a frame,
and returns masks [B, P, 4, 4g, 4g] (compute dtype) and iou [B, P, 4]
(float32). compile.build_pipeline(arch "sam") keeps mask 0 and IoU 0, as
a single-mask box prompt does (multimask_output=False).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models.layers import LayerNorm2d, channels_last
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.ops.attention import (attend, relpos_attention,
                                           window_partition,
                                           window_unpartition)

# scale: (embed_dim, depth, num_heads, global_attn_indexes), build_sam.py
SAM_SCALES: Dict[str, Tuple[int, int, int, Tuple[int, ...]]] = {
    "b": (768, 12, 12, (2, 5, 8, 11)),
    "l": (1024, 24, 16, (5, 11, 17, 23)),
    "h": (1280, 32, 16, (7, 15, 23, 31)),
}
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SAMSpec:
    """Every width of one SAM: the encoder's from SAM_SCALES, the rest
    build_sam.py's constants. Tests build smaller ones directly."""
    embed_dim: int
    depth: int
    num_heads: int
    global_attn_indexes: Tuple[int, ...]
    img_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_dim: int = 256            # the neck's out_chans, the decoder's dim
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample: int = 2
    num_mask_tokens: int = 4         # num_multimask_outputs + 1
    iou_head_depth: int = 3

    @property
    def grid(self) -> int:
        """Tokens a side of the encoder's map (64 at 1024 / 16)."""
        return self.img_size // self.patch_size

    @property
    def low_res(self) -> int:
        """Side of the decoder's logits (256: the map upscaled 4x)."""
        return 4 * self.grid


def check_supported(cfg: ModelConfig) -> None:
    """arch "sam", a published scale, the segment task."""
    if cfg.arch != "sam":
        raise ValueError(f"models.sam builds arch 'sam', not {cfg.arch!r}")
    if cfg.scale not in SAM_SCALES:
        raise ValueError(f"Unknown sam scale {cfg.scale!r}; expected one of "
                         f"{sorted(SAM_SCALES)}")
    if cfg.task != "segment":
        raise ValueError(f"arch 'sam' runs the segment task (box prompts), "
                         f"not {cfg.task!r}")


def sam_spec(cfg: ModelConfig) -> SAMSpec:
    """The published widths of cfg's scale at cfg's (square) input."""
    check_supported(cfg)
    embed, depth, heads, glob = SAM_SCALES[cfg.scale]
    return SAMSpec(embed, depth, heads, glob, img_size=cfg.input_size[0])


def profiler_range(name: str):
    """A profiler range while a profiler records; nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """nn.GELU's default: the exact erf form."""
    return F.gelu(x)


class Linear(nn.Module):
    """nn.Linear's parameters (float32), applied in x's dtype."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c2, c1))
        self.bias = nn.Parameter(torch.zeros(c2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """nn.LayerNorm over the last dim, applied in x's dtype."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Conv2d(nn.Module):
    """nn.Conv2d (padding k // 2, or none for a patch embedding), the
    weight channels-last, applied in x's dtype."""

    def __init__(self, c1: int, c2: int, k: int, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c2, c1, k, k).contiguous(
            memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(c2)) if bias else None
        self.stride = stride
        self.padding = 0 if stride == k else k // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, channels_last(self.weight, x.dtype), b,
                        self.stride, self.padding)


class ConvTranspose2x(nn.Module):
    """nn.ConvTranspose2d(c1, c2, 2, stride 2): weight [c1, c2, 2, 2]."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c1, c2, 2, 2).contiguous(
            memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(c2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, channels_last(self.weight, x.dtype),
                                  self.bias.to(x.dtype), stride=2)


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gelu(x)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, spec: SAMSpec):
        super().__init__()
        self.proj = Conv2d(3, spec.embed_dim, spec.patch_size,
                           spec.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> [B, g, g, C]."""
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RelPosAttention(nn.Module):
    """SAM's Attention with use_rel_pos over a (size x size) map."""

    def __init__(self, dim: int, num_heads: int, size: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1,
                                                  self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1,
                                                  self.head_dim))

    def forward(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        B, H, W, C = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                        # [B, nh, H*W, hd]
        o = relpos_attention(q, k, v, self.rel_pos_h, self.rel_pos_w, (H, W),
                             hd ** -0.5, kind)
        return self.proj(o.transpose(1, 2).reshape(B, H, W, C))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(_gelu(self.lin1(x)))


class Block(nn.Module):
    """A ViT block: windowed (window_size > 0) or global attention."""

    def __init__(self, spec: SAMSpec, window_size: int):
        super().__init__()
        dim = spec.embed_dim
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = RelPosAttention(dim, spec.num_heads,
                                    window_size or spec.grid)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = MLPBlock(dim, int(dim * spec.mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            hw = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, ws)
            x = window_unpartition(self.attn(x, "window"), ws, pad_hw, hw)
        else:
            x = self.attn(x, "global")
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, spec: SAMSpec):
        super().__init__()
        g, dim = spec.grid, spec.embed_dim
        self.patch_embed = PatchEmbed(spec)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        self.blocks = nn.ModuleList(
            Block(spec, 0 if i in spec.global_attn_indexes
                  else spec.window_size) for i in range(spec.depth))
        c = spec.prompt_dim
        self.neck = nn.Sequential(Conv2d(dim, c, 1, bias=False),
                                  LayerNorm2d(c),
                                  Conv2d(c, c, 3, bias=False),
                                  LayerNorm2d(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> the image embedding [B, 256, g, g]
        (channels-last)."""
        x = self.patch_embed(x) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    """SAM's random-Fourier positional encoding, width 2 * num_pos_feats,
    in float32."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """(x, y) in [0, 1], [..., 2] -> [..., 2 * num_pos_feats]."""
        c = (2 * coords.float() - 1) @ \
            self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def grid(self, size: int) -> torch.Tensor:
        """The encoding of each cell's centre of a size x size map,
        [1, 2 * num_pos_feats, size, size]."""
        dev = self.positional_encoding_gaussian_matrix.device
        t = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5) / size
        xy = torch.stack([t[None, :].expand(size, size),
                          t[:, None].expand(size, size)], -1)
        return self.encode(xy).permute(2, 0, 1)[None]


class PromptEncoder(nn.Module):
    def __init__(self, spec: SAMSpec):
        super().__init__()
        d = spec.prompt_dim
        self.img_size, self.grid = spec.img_size, spec.grid
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.no_mask_embed = nn.Embedding(1, d)

    def forward(self, boxes: torch.Tensor):
        """boxes [N, 4] xyxy in input pixels -> (sparse [N, 2, d], dense
        [1, d, 1, 1]), float32."""
        coords = (boxes.float() + 0.5).reshape(-1, 2, 2) / self.img_size
        corners = self.pe_layer.encode(coords)
        corners = torch.stack(
            [corners[:, 0] + self.point_embeddings[2].weight[0],
             corners[:, 1] + self.point_embeddings[3].weight[0]], 1)
        return corners, self.no_mask_embed.weight.reshape(1, -1, 1, 1)

    def dense_pe(self) -> torch.Tensor:
        return self.pe_layer.grid(self.grid)


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    """SAM's decoder Attention: projections to dim / downsample, heads,
    softmax(q k^T / sqrt(head width)) v, out_proj back."""

    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = Linear(dim, inner)
        self.k_proj = Linear(dim, inner)
        self.v_proj = Linear(dim, inner)
        self.out_proj = Linear(inner, dim)

    def forward(self, q, k, v):
        nh = self.num_heads

        def heads(x):
            b, n, c = x.shape
            return x.reshape(b, n, nh, c // nh).transpose(1, 2)

        q, k, v = heads(self.q_proj(q)), heads(self.k_proj(k)), \
            heads(self.v_proj(v))
        o = attend(q, k, v)
        b, _, n, c = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, n, nh * c))


class MLP(nn.Module):
    """SAM's MLP: num_layers Linears, ReLU between them."""

    def __init__(self, c_in: int, hidden: int, c_out: int, num_layers: int):
        super().__init__()
        dims = [c_in] + [hidden] * (num_layers - 1) + [c_out]
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DecoderMLP(nn.Module):
    """The transformer's MLPBlock: lin1, ReLU, lin2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, spec: SAMSpec, skip_first_layer_pe: bool):
        super().__init__()
        d, nh, ds = spec.prompt_dim, spec.decoder_heads, \
            spec.attention_downsample
        self.self_attn = DecoderAttention(d, nh)
        self.norm1 = LayerNorm(d, 1e-5)
        self.cross_attn_token_to_image = DecoderAttention(d, nh, ds)
        self.norm2 = LayerNorm(d, 1e-5)
        self.mlp = DecoderMLP(d, spec.decoder_mlp_dim)
        self.norm3 = LayerNorm(d, 1e-5)
        self.norm4 = LayerNorm(d, 1e-5)
        self.cross_attn_image_to_token = DecoderAttention(d, nh, ds)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries
                             + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, spec: SAMSpec):
        super().__init__()
        d = spec.prompt_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(spec, i == 0)
                                    for i in range(spec.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(
            d, spec.decoder_heads, spec.attention_downsample)
        self.norm_final_attn = LayerNorm(d, 1e-5)

    def forward(self, keys, key_pe, point_embedding):
        """image tokens [N, h*w, d], their encoding [1, h*w, d], tokens [N,
        T, d] -> (tokens [N, T, d], image tokens [N, h*w, d])."""
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, spec: SAMSpec):
        super().__init__()
        d, n = spec.prompt_dim, spec.num_mask_tokens
        self.num_mask_tokens = n
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.transformer = TwoWayTransformer(spec)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2x(d, d // 4), LayerNorm2d(d // 4), GELU(),
            ConvTranspose2x(d // 4, d // 8), GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_prediction_head = MLP(d, d, n, spec.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense,
                per_frame: int):
        """image_embeddings [B, d, h, w]; image_pe [1, d, h, w]; sparse
        [N, T, d] (N = B * per_frame, frame-major); dense [1, d, 1, 1] ->
        (masks [N, n, 4h, 4w], iou [N, n] float32)."""
        dt = image_embeddings.dtype
        n = sparse.shape[0]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out.to(dt)[None].expand(n, -1, -1),
                            sparse.to(dt)], 1)
        # the frame's image tokens for each of its prompts, + dense: SAM's
        # repeat_interleave of the map, laid out as tokens [N, h*w, c]
        _, c, h, w = image_embeddings.shape
        keys = torch.repeat_interleave(image_embeddings.permute(0, 2, 3, 1),
                                       per_frame, 0).reshape(n, h * w, c) \
            + dense.to(dt).reshape(1, 1, c)
        key_pe = image_pe.to(dt).permute(0, 2, 3, 1).reshape(1, h * w, c)
        hs, keys = self.transformer(keys, key_pe, tokens)
        mask_out = hs[:, 1:1 + self.num_mask_tokens]
        up = self.output_upscaling(                  # [N, c/8, 4h, 4w]
            keys.reshape(n, h, w, c).permute(0, 3, 1, 2))
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        uh, uw = up.shape[2:]
        flat = up.permute(0, 2, 3, 1).reshape(n, uh * uw, up.shape[1])
        masks = torch.bmm(hyper, flat.transpose(1, 2)).view(n, -1, uh, uw)
        return masks, self.iou_prediction_head(hs[:, 0]).float()


class SAM(nn.Module):
    """Image encoder, prompt encoder and mask decoder of one scale (or of
    `spec`, for a smaller test model at cfg.input_size)."""

    def __init__(self, cfg: ModelConfig, spec: Optional[SAMSpec] = None):
        super().__init__()
        check_supported(cfg)
        spec = spec or sam_spec(cfg)
        if tuple(cfg.input_size) != (spec.img_size, spec.img_size) or \
                spec.img_size % spec.patch_size:
            raise ValueError(f"sam: input_size {cfg.input_size} must be "
                             f"({spec.img_size}, {spec.img_size}), a "
                             f"multiple of the patch {spec.patch_size}")
        self.cfg, self.spec = cfg, spec
        self.dtype = getattr(torch, cfg.dtype)
        self.image_encoder = ImageEncoderViT(spec)
        self.prompt_encoder = PromptEncoder(spec)
        self.mask_decoder = MaskDecoder(spec)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed input [B, S, S, 3] -> image embeddings [B, d, g,
        g] in the compute dtype."""
        return self.image_encoder(x.to(self.dtype))

    def decode(self, embeddings: torch.Tensor, boxes: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """Image embeddings [B, d, g, g] and boxes [B, P, 4] (xyxy in input
        pixels) -> masks [B, P, n, 4g, 4g] (compute dtype), iou [B, P, n]
        (float32). On the card the prompts are counted (`sam_prompts`)."""
        B, P = boxes.shape[:2]
        sparse, dense = self.prompt_encoder(boxes.reshape(B * P, 4))
        masks, iou = self.mask_decoder(
            embeddings, self.prompt_encoder.dense_pe(), sparse, dense, P)
        if embeddings.is_cuda:
            launches.count("sam_prompts", n=B * P)
        return {"masks": masks.reshape(B, P, *masks.shape[1:]),
                "iou": iou.reshape(B, P, -1)}

    def forward(self, x: torch.Tensor, boxes: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        return self.decode(self.encode(x), boxes)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                spec: Optional[SAMSpec] = None) -> SAM:
    """A SAM with weights drawn from `gen` in registration order: each
    Linear and conv weight uniform with the variance 1 / fan-in, biases
    zero, norms identity, the embeddings and the Fourier matrix standard
    normal, pos_embed and the rel-pos tables zero (as SAM starts them)."""
    model = SAM(cfg, spec)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, Conv2d, ConvTranspose2x)):
                w = m.weight
                fan_in = w.shape[0] if isinstance(m, ConvTranspose2x) \
                    else math.prod(w.shape[1:])
                bound = math.sqrt(3.0 / fan_in)
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                      generator=gen))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
            elif isinstance(m, PositionEmbeddingRandom):
                g = m.positional_encoding_gaussian_matrix
                g.copy_(torch.randn(g.shape, generator=gen))
    return model
