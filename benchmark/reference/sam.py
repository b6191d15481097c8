"""The plain float32 Segment Anything (ViT image encoder, box prompts):
the reference of the benchmark's SAM cells.

Written from facebookresearch/segment-anything (`build_sam.py`,
`modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`,
`transformer.py`, `utils/transforms.py`, the predictor's
`postprocess_masks`; Kirillov et al., arXiv:2304.02643), the same
functions as the repository's test reference `tests/sam_reference.py`,
here over `reference/yolo.py`'s Ops so that its fake-quantized variants
(the bf16 witness, the fp8 control) and its count (`param_specs`,
`count_forward`) come from the same walk. It imports nothing of the
program under test; the state dict's names are the published model's
(`image_encoder.blocks.7.attn.rel_pos_h`, ...).

Everything runs in float32 with TF32 off (`yolo.float32_scope`). With a
`quant`, every operand of a linear, conv and matmul (the attention's q,
k, probabilities and v, and the rel-pos products' q and tables too) is
rounded first (yolo.fake_quant).

The count: each linear and conv, each attention as one fused call (its
two products; for the encoder's rel-pos attention also the two rel-pos
products, 2 * B' * heads * N * (qh + qw) * d FLOPs, and its bytes q, k,
v and o plus the two tables, no bias), and the hypernetwork product; at
the activations' width (bf16, 2 bytes).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import yolo
from benchmark.reference.yolo import (Ops, fake_quant,  # noqa: F401
                                      float32_scope)


def _count(o: Ops, kind, flops, b_in, b_w, b_out) -> None:
    if o.count is not None:
        o.count(kind, flops, b_in, b_w, b_out)


def linear(o: Ops, name: str, x, cout: int):
    cin = x.shape[-1]
    w = o.param(f"{name}.weight", (cout, cin), "linear")
    b = o.param(f"{name}.bias", (cout,), "bias")
    y = fake_quant(x, o.quant) @ fake_quant(w, o.quant).t() + b
    m, ab = x.numel() // cin, o.act_bytes
    _count(o, "linear", 2 * m * cin * cout, m * cin * ab, w.numel() * ab,
           m * cout * ab)
    return y


def conv(o: Ops, name: str, x, cout: int, k: int, stride: int = 1,
         bias: bool = True):
    """nn.Conv2d, padding k // 2 (none for a stride-k patch embedding)."""
    cin = x.shape[1]
    w = o.param(f"{name}.weight", (cout, cin, k, k), "conv")
    b = o.param(f"{name}.bias", (cout,), "bias") if bias else None
    pad = 0 if stride == k else k // 2
    y = F.conv2d(fake_quant(x, o.quant), fake_quant(w, o.quant), b, stride,
                 pad)
    B, _, Ho, Wo = y.shape
    ab = o.act_bytes
    _count(o, "conv", 2 * B * cout * Ho * Wo * cin * k * k, x.numel() * ab,
           w.numel() * ab, y.numel() * ab)
    return y


def conv_transpose2x(o: Ops, name: str, x, cout: int):
    cin = x.shape[1]
    w = o.param(f"{name}.weight", (cin, cout, 2, 2), "up")
    b = o.param(f"{name}.bias", (cout,), "bias")
    y = F.conv_transpose2d(fake_quant(x, o.quant), fake_quant(w, o.quant), b,
                           stride=2)
    ab = o.act_bytes
    _count(o, "conv_transpose", 2 * x.numel() * cout * 4, x.numel() * ab,
           w.numel() * ab, y.numel() * ab)
    return y


def layer_norm(o: Ops, name: str, x, eps: float):
    c = x.shape[-1]
    return F.layer_norm(x, (c,), o.param(f"{name}.weight", (c,), "norm"),
                        o.param(f"{name}.bias", (c,), "norm_bias"), eps)


def layer_norm2d(o: Ops, name: str, x, eps: float = 1e-6):
    c = x.shape[1]
    w = o.param(f"{name}.weight", (c,), "norm")
    b = o.param(f"{name}.bias", (c,), "norm_bias")
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[:, None, None] * x + b[:, None, None]


def _mm(o: Ops, a, b):
    return fake_quant(a, o.quant) @ fake_quant(b, o.quant)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def get_rel_pos(q_size: int, k_size: int, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear").reshape(
            -1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size,
                                                          1.0)
    return rel_pos[relative.long().to(rel_pos.device)]


def relpos_attention(o: Ops, q, k, v, rel_pos_h, rel_pos_w, hw):
    """q, k, v [B*heads, N, d] -> softmax((q d^-0.5) k^T + rel_h + rel_w)
    v (SAM's add_decomposed_rel_pos), counted as one fused call."""
    H, W = hw
    Bh, N, d = q.shape
    attn = _mm(o, q * d ** -0.5, k.transpose(-2, -1))
    r_q = q.reshape(Bh, H, W, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", fake_quant(r_q, o.quant),
                         fake_quant(get_rel_pos(H, H, rel_pos_h), o.quant))
    rel_w = torch.einsum("bhwc,wkc->bhwk", fake_quant(r_q, o.quant),
                         fake_quant(get_rel_pos(W, W, rel_pos_w), o.quant))
    attn = (attn.view(Bh, H, W, H, W) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(Bh, N, N)
    out = _mm(o, attn.softmax(dim=-1), v)
    ab = o.act_bytes
    _count(o, "relpos_attention",
           4 * Bh * N * N * d + 2 * Bh * N * (H + W) * d, 3 * q.numel() * ab,
           (rel_pos_h.numel() + rel_pos_w.numel()) * ab, out.numel() * ab)
    return out


def window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph > 0 or pw > 0:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), \
        (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous() if Hp > H or Wp > W else x


def vit_attention(o: Ops, name: str, x, heads: int, size: int):
    B, H, W, C = x.shape
    hd = C // heads
    qkv = linear(o, f"{name}.qkv", x, 3 * C).reshape(
        B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    rel_h = o.param(f"{name}.rel_pos_h", (2 * size - 1, hd), "relpos")
    rel_w = o.param(f"{name}.rel_pos_w", (2 * size - 1, hd), "relpos")
    x = relpos_attention(o, q, k, v, rel_h, rel_w, (H, W))
    x = x.view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
    return linear(o, f"{name}.proj", x, C)


def block(o: Ops, cfg: dict, name: str, x, window: int):
    C = x.shape[-1]
    shortcut = x
    x = layer_norm(o, f"{name}.norm1", x, 1e-6)
    size = window or cfg["image_size"] // cfg["vit_patch_size"]
    if window > 0:
        hw = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
    x = vit_attention(o, f"{name}.attn", x, cfg["encoder_num_heads"], size)
    if window > 0:
        x = window_unpartition(x, window, pad_hw, hw)
    x = shortcut + x
    h = layer_norm(o, f"{name}.norm2", x, 1e-6)
    h = linear(o, f"{name}.mlp.lin1", h, int(C * cfg["mlp_ratio"]))
    return x + linear(o, f"{name}.mlp.lin2", F.gelu(h), C)


def image_encoder(o: Ops, cfg: dict, x):
    """x [B, 3, S, S] normalised -> [B, prompt_embed_dim, g, g]."""
    p, C = "image_encoder", cfg["encoder_embed_dim"]
    g = cfg["image_size"] // cfg["vit_patch_size"]
    x = conv(o, f"{p}.patch_embed.proj", x, C, cfg["vit_patch_size"],
             cfg["vit_patch_size"])
    x = x.permute(0, 2, 3, 1) + o.param(f"{p}.pos_embed", (1, g, g, C), "pos")
    for i in range(cfg["encoder_depth"]):
        window = 0 if i in cfg["encoder_global_attn_indexes"] \
            else cfg["window_size"]
        x = block(o, cfg, f"{p}.blocks.{i}", x, window)
    c = cfg["prompt_embed_dim"]
    x = conv(o, f"{p}.neck.0", x.permute(0, 3, 1, 2), c, 1, bias=False)
    x = layer_norm2d(o, f"{p}.neck.1", x)
    x = conv(o, f"{p}.neck.2", x, c, 3, bias=False)
    return layer_norm2d(o, f"{p}.neck.3", x)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def pe_encoding(o: Ops, cfg: dict, coords):
    g = o.param("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
                (2, cfg["prompt_embed_dim"] // 2), "gauss")
    coords = (2 * coords - 1) @ g
    coords = 2 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(o: Ops, cfg: dict, device):
    size = cfg["image_size"] // cfg["vit_patch_size"]
    grid = torch.ones((size, size), dtype=torch.float32, device=device)
    y_embed = (grid.cumsum(dim=0) - 0.5) / size
    x_embed = (grid.cumsum(dim=1) - 0.5) / size
    pe = pe_encoding(o, cfg, torch.stack([x_embed, y_embed], dim=-1))
    return pe.permute(2, 0, 1)[None]


def prompt_params(o: Ops, cfg: dict):
    """The prompt encoder's embeddings: point_embeddings 0-3 and
    no_mask_embed, each [1, d]."""
    d = cfg["prompt_embed_dim"]
    pts = [o.param(f"prompt_encoder.point_embeddings.{i}.weight", (1, d),
                   "embed") for i in range(4)]
    return pts, o.param("prompt_encoder.no_mask_embed.weight", (1, d),
                        "embed")


def embed_boxes(o: Ops, cfg: dict, boxes, pts):
    S = cfg["image_size"]
    coords = (boxes + 0.5).reshape(-1, 2, 2) / S
    corner = pe_encoding(o, cfg, coords)
    return torch.stack([corner[:, 0] + pts[2][0], corner[:, 1] + pts[3][0]],
                       1)


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

def dec_attention(o: Ops, cfg: dict, name: str, q, k, v, downsample: int):
    d, heads = q.shape[-1], cfg["decoder_num_heads"]
    inner = d // downsample
    q = linear(o, f"{name}.q_proj", q, inner)
    k = linear(o, f"{name}.k_proj", k, inner)
    v = linear(o, f"{name}.v_proj", v, inner)

    def separate(x):
        b, n, c = x.shape
        return x.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = _mm(o, q, k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
    out = _mm(o, torch.softmax(attn, dim=-1), v)
    b, nh, n, c = out.shape
    ab = o.act_bytes
    _count(o, "attention", 4 * b * nh * n * k.shape[2] * c,
           (q.numel() + k.numel() + v.numel()) * ab, 0, out.numel() * ab)
    return linear(o, f"{name}.out_proj",
                  out.transpose(1, 2).reshape(b, n, nh * c), d)


def mlp(o: Ops, name: str, x, hidden: int, cout: int, num_layers: int):
    for i in range(num_layers):
        x = linear(o, f"{name}.layers.{i}", x,
                   cout if i == num_layers - 1 else hidden)
        if i < num_layers - 1:
            x = F.relu(x)
    return x


def two_way_block(o: Ops, cfg: dict, name: str, queries, keys, query_pe,
                  key_pe, skip: bool):
    d, ds = queries.shape[-1], cfg["attention_downsample_rate"]
    if skip:
        queries = dec_attention(o, cfg, f"{name}.self_attn", queries,
                                queries, queries, 1)
    else:
        q = queries + query_pe
        queries = queries + dec_attention(o, cfg, f"{name}.self_attn", q, q,
                                          queries, 1)
    queries = layer_norm(o, f"{name}.norm1", queries, 1e-5)
    q, k = queries + query_pe, keys + key_pe
    queries = queries + dec_attention(
        o, cfg, f"{name}.cross_attn_token_to_image", q, k, keys, ds)
    queries = layer_norm(o, f"{name}.norm2", queries, 1e-5)
    h = F.relu(linear(o, f"{name}.mlp.lin1", queries, cfg["decoder_mlp_dim"]))
    queries = layer_norm(o, f"{name}.norm3",
                         queries + linear(o, f"{name}.mlp.lin2", h, d), 1e-5)
    q, k = queries + query_pe, keys + key_pe
    keys = keys + dec_attention(o, cfg, f"{name}.cross_attn_image_to_token",
                                k, q, queries, ds)
    keys = layer_norm(o, f"{name}.norm4", keys, 1e-5)
    return queries, keys


def mask_decoder(o: Ops, cfg: dict, image_embeddings, image_pe, sparse,
                 dense):
    """One frame's embedding [1, d, g, g] against its N prompts -> masks
    [N, n, 4g, 4g], iou [N, n] (n = num_multimask_outputs + 1)."""
    p, d = "mask_decoder", cfg["prompt_embed_dim"]
    n_masks = cfg["num_multimask_outputs"] + 1
    output_tokens = torch.cat([
        o.param(f"{p}.iou_token.weight", (1, d), "embed"),
        o.param(f"{p}.mask_tokens.weight", (n_masks, d), "embed")], dim=0)
    output_tokens = output_tokens.unsqueeze(0).expand(sparse.size(0), -1, -1)
    tokens = torch.cat((output_tokens, sparse), dim=1)
    src = torch.repeat_interleave(image_embeddings, tokens.shape[0], dim=0)
    src = src + dense
    pos_src = torch.repeat_interleave(image_pe, tokens.shape[0], dim=0)
    b, c, h, w = src.shape
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = pos_src.flatten(2).permute(0, 2, 1)
    queries = tokens
    t = f"{p}.transformer"
    for i in range(cfg["decoder_depth"]):
        queries, keys = two_way_block(o, cfg, f"{t}.layers.{i}", queries,
                                      keys, tokens, key_pe, i == 0)
    q, k = queries + tokens, keys + key_pe
    queries = queries + dec_attention(
        o, cfg, f"{t}.final_attn_token_to_image", q, k, keys,
        cfg["attention_downsample_rate"])
    hs = layer_norm(o, f"{t}.norm_final_attn", queries, 1e-5)
    src = keys.transpose(1, 2).reshape(b, c, h, w)
    u = f"{p}.output_upscaling"
    up = F.gelu(layer_norm2d(o, f"{u}.1",
                             conv_transpose2x(o, f"{u}.0", src, d // 4)))
    up = F.gelu(conv_transpose2x(o, f"{u}.3", up, d // 8))
    hyper_in = torch.stack(
        [mlp(o, f"{p}.output_hypernetworks_mlps.{i}", hs[:, 1 + i], d, d // 8,
             3) for i in range(n_masks)], dim=1)
    b, c, h, w = up.shape
    masks = _mm(o, hyper_in, up.reshape(b, c, h * w)).view(b, -1, h, w)
    ab = o.act_bytes
    _count(o, "matmul", 2 * b * n_masks * c * h * w, hyper_in.numel() * ab,
           up.numel() * ab, masks.numel() * ab)
    iou = mlp(o, f"{p}.iou_prediction_head", hs[:, 0],
              cfg["iou_head_hidden_dim"], n_masks, cfg["iou_head_depth"])
    return masks, iou


# ---------------------------------------------------------------------------
# the predictor's transforms, the pipeline, the count
# ---------------------------------------------------------------------------

def preprocess_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    scale = size * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _resize_axis(x, axis: int, out: int):
    """Bilinear along one axis, half-pixel centres, no antialiasing, the
    sample positions in float64."""
    n = x.shape[axis]
    pos = ((torch.arange(out, dtype=torch.float64) + 0.5) * (n / out)
           - 0.5).clamp(min=0.0)
    i0 = pos.floor().long().clamp(max=n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    shape = [1] * x.dim()
    shape[axis] = out
    wt = (pos - i0).float().to(x.device).reshape(shape)
    return x.index_select(axis, i0.to(x.device)) * (1 - wt) \
        + x.index_select(axis, i1.to(x.device)) * wt


def preprocess(cfg: dict, frames):
    """uint8 [B, H, W, 3] -> [B, 3, S, S]: the longest side resized to S
    (bilinear, as cv2 resizes in Ultralytics' predictor), (x - mean) /
    std, zero-padded at the bottom and right."""
    S = cfg["image_size"]
    x = frames.permute(0, 3, 1, 2).float()
    nh, nw = preprocess_shape(x.shape[2], x.shape[3], S)
    x = _resize_axis(_resize_axis(x, 2, nh), 3, nw)
    mean = torch.tensor(cfg["pixel_mean"], device=x.device)[:, None, None]
    std = torch.tensor(cfg["pixel_std"], device=x.device)[:, None, None]
    return F.pad((x - mean) / std, (0, S - nw, 0, S - nh))


def apply_boxes(boxes, frame_hw, size: int):
    nh, nw = preprocess_shape(frame_hw[0], frame_hw[1], size)
    coords = boxes.reshape(-1, 2, 2).clone().float()
    coords[..., 0] = coords[..., 0] * (nw / frame_hw[1])
    coords[..., 1] = coords[..., 1] * (nh / frame_hw[0])
    return coords.reshape(boxes.shape)


def postprocess_masks(masks, input_hw, frame_hw, size: int):
    masks = F.interpolate(masks, (size, size), mode="bilinear",
                          align_corners=False)
    masks = masks[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(masks, tuple(frame_hw), mode="bilinear",
                         align_corners=False)


def forward(o: Ops, cfg: dict, x, boxes):
    """Normalised input [B, 3, S, S] and boxes [B, P, 4] in its pixels ->
    masks [B, P, n, 4g, 4g] and iou [B, P, n]."""
    emb = image_encoder(o, cfg, x)
    pe = dense_pe(o, cfg, x.device)
    pts, no_mask = prompt_params(o, cfg)
    dense = no_mask.reshape(1, -1, 1, 1)
    masks, iou = [], []
    for i in range(x.shape[0]):
        m, q = mask_decoder(o, cfg, emb[i:i + 1], pe,
                            embed_boxes(o, cfg, boxes[i], pts), dense)
        masks.append(m)
        iou.append(q)
    return torch.stack(masks), torch.stack(iou)


def run(sd: Dict[str, torch.Tensor], cfg: dict, frames, boxes, quant=None,
        chunk: int = 1) -> Dict[str, torch.Tensor]:
    """frames uint8 [B, H, W, 3] and boxes [B, P, 4] (xyxy in frame
    pixels), tensors on the reference's device -> masks [B, P, n, 4g, 4g],
    iou [B, P, n] and frame_logits [B, P, H, W] (mask 0 at the frame's
    size), float32 on that device; `chunk` frames a forward."""
    S = cfg["image_size"]
    H, W = frames.shape[1:3]
    input_hw = preprocess_shape(H, W, S)
    out: Dict[str, List[torch.Tensor]] = {"masks": [], "iou": [],
                                          "frame_logits": []}
    with torch.no_grad(), float32_scope():
        for s in range(0, frames.shape[0], chunk):
            x = preprocess(cfg, frames[s:s + chunk])
            b = apply_boxes(boxes[s:s + chunk], (H, W), S)
            masks, iou = forward(Ops(sd, quant=quant), cfg, x, b)
            out["masks"].append(masks)
            out["iou"].append(iou)
            out["frame_logits"].append(torch.stack([postprocess_masks(
                m[:, :1], input_hw, (H, W), S)[:, 0] for m in masks]))
    return {k: torch.cat(v) for k, v in out.items()}


def _meta_forward(o: Ops, cfg: dict, batch: int, prompts: int):
    S = cfg["image_size"]
    x = torch.empty((batch, 3, S, S), device="meta")
    boxes = torch.empty((batch, prompts, 4), device="meta")
    forward(o, cfg, x, boxes)


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in the forward's order; kind
    "linear", "conv", "up" (a transposed conv), "bias", "norm",
    "norm_bias", "pos" (pos_embed), "relpos" (a rel-pos table), "embed"
    (an embedding or token) or "gauss" (the Fourier matrix)."""
    specs: List[Tuple[str, tuple, str]] = []
    _meta_forward(Ops(None, specs=specs), cfg, 1, 1)
    seen, out = set(), []
    for s in specs:
        if s[0] not in seen:
            seen.add(s[0])
            out.append(s)
    return out


def count_forward(cfg: dict, batch: int, prompts: int,
                  act_bytes: int = 2) -> yolo.Counter:
    """The per-layer count of a forward of `batch` frames with `prompts`
    boxes each, on the meta device."""
    c = yolo.Counter()
    _meta_forward(Ops(None, count=c, specs=[], act_bytes=act_bytes), cfg,
                  batch, prompts)
    return c
