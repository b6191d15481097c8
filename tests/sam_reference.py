"""A plain float32 Segment Anything (box prompts), written from the
published modules of facebookresearch/segment-anything
(`modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`,
`transformer.py`, `utils/transforms.py` and the predictor's
`postprocess_masks`) as functions over a state dict whose names are the
published ones. It imports nothing of the port and no JAX; every product
runs in float32 with TF32 off (`float32_scope`).

`cfg` is a configuration dict with build_sam.py's names
(`encoder_embed_dim`, `encoder_depth`, `encoder_num_heads`,
`encoder_global_attn_indexes`, `image_size`, `vit_patch_size`,
`window_size`, `mlp_ratio`, `prompt_embed_dim`, `decoder_depth`,
`decoder_mlp_dim`, `decoder_num_heads`, `attention_downsample_rate`,
`num_multimask_outputs`, `iou_head_depth`, `iou_head_hidden_dim`,
`pixel_mean`, `pixel_std`), as benchmark/configs/sam-vit-h.json holds them.

The frame's resize is bilinear with half-pixel centres and no
antialiasing, as Ultralytics' SAM predictor resizes with cv2, its sample
positions in float64 (F.interpolate's float32 positions stray by up to
1e-3 of a grey level at a 1280-pixel axis).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_scope():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def linear(sd, name, x):
    return x @ sd[f"{name}.weight"].t() + sd[f"{name}.bias"]


def layer_norm(sd, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"],
                        sd[f"{name}.bias"], eps)


def layer_norm2d(sd, name, x, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return sd[f"{name}.weight"][:, None, None] * x \
        + sd[f"{name}.bias"][:, None, None]


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist) \
            .permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) \
        + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w)
            + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :])
    return attn.view(B, q_h * q_w, k_h * k_w)


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def vit_attention(sd, name, x, num_heads):
    B, H, W, _ = x.shape
    qkv = linear(sd, f"{name}.qkv", x).reshape(
        B, H * W, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * num_heads, H * W, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, sd[f"{name}.rel_pos_h"],
                                  sd[f"{name}.rel_pos_w"], (H, W), (H, W))
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(B, num_heads, H, W, -1).permute(0, 2, 3, 1, 4) \
        .reshape(B, H, W, -1)
    return linear(sd, f"{name}.proj", x)


def block(sd, name, x, num_heads, window_size):
    shortcut = x
    x = layer_norm(sd, f"{name}.norm1", x, 1e-6)
    if window_size > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
    x = vit_attention(sd, f"{name}.attn", x, num_heads)
    if window_size > 0:
        x = window_unpartition(x, window_size, pad_hw, (H, W))
    x = shortcut + x
    h = layer_norm(sd, f"{name}.norm2", x, 1e-6)
    h = linear(sd, f"{name}.mlp.lin2",
               F.gelu(linear(sd, f"{name}.mlp.lin1", h)))
    return x + h


def image_encoder(sd, cfg, x):
    """x [B, 3, S, S] normalised -> [B, prompt_embed_dim, g, g]."""
    p = "image_encoder"
    patch = cfg["vit_patch_size"]
    x = F.conv2d(x, sd[f"{p}.patch_embed.proj.weight"],
                 sd[f"{p}.patch_embed.proj.bias"], stride=patch)
    x = x.permute(0, 2, 3, 1) + sd[f"{p}.pos_embed"]
    for i in range(cfg["encoder_depth"]):
        ws = 0 if i in cfg["encoder_global_attn_indexes"] \
            else cfg["window_size"]
        x = block(sd, f"{p}.blocks.{i}", x, cfg["encoder_num_heads"], ws)
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(x, sd[f"{p}.neck.0.weight"])
    x = layer_norm2d(sd, f"{p}.neck.1", x)
    x = F.conv2d(x, sd[f"{p}.neck.2.weight"], padding=1)
    return layer_norm2d(sd, f"{p}.neck.3", x)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def pe_encoding(sd, coords):
    g = sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    coords = 2 * coords - 1
    coords = coords @ g
    coords = 2 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(sd, size):
    grid = torch.ones((size, size), dtype=torch.float32,
                      device=sd["prompt_encoder.no_mask_embed.weight"].device)
    y_embed = (grid.cumsum(dim=0) - 0.5) / size
    x_embed = (grid.cumsum(dim=1) - 0.5) / size
    pe = pe_encoding(sd, torch.stack([x_embed, y_embed], dim=-1))
    return pe.permute(2, 0, 1)[None]


def embed_boxes(sd, boxes, image_size):
    boxes = boxes + 0.5
    coords = boxes.reshape(-1, 2, 2).clone()
    coords[:, :, 0] = coords[:, :, 0] / image_size
    coords[:, :, 1] = coords[:, :, 1] / image_size
    corner = pe_encoding(sd, coords)
    corner[:, 0, :] += sd["prompt_encoder.point_embeddings.2.weight"][0]
    corner[:, 1, :] += sd["prompt_encoder.point_embeddings.3.weight"][0]
    return corner


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

def dec_attention(sd, name, q, k, v, num_heads):
    q = linear(sd, f"{name}.q_proj", q)
    k = linear(sd, f"{name}.k_proj", k)
    v = linear(sd, f"{name}.v_proj", v)

    def separate(x):
        b, n, c = x.shape
        return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = q @ k.permute(0, 1, 3, 2)
    attn = attn / math.sqrt(q.shape[-1])
    attn = torch.softmax(attn, dim=-1)
    out = attn @ v
    b, n_heads, n_tokens, c_per_head = out.shape
    out = out.transpose(1, 2).reshape(b, n_tokens, n_heads * c_per_head)
    return linear(sd, f"{name}.out_proj", out)


def mlp(sd, name, x, num_layers):
    for i in range(num_layers):
        x = linear(sd, f"{name}.layers.{i}", x)
        if i < num_layers - 1:
            x = F.relu(x)
    return x


def two_way_block(sd, name, queries, keys, query_pe, key_pe, heads, skip):
    if skip:
        queries = dec_attention(sd, f"{name}.self_attn", queries, queries,
                                queries, heads)
    else:
        q = queries + query_pe
        queries = queries + dec_attention(sd, f"{name}.self_attn", q, q,
                                          queries, heads)
    queries = layer_norm(sd, f"{name}.norm1", queries, 1e-5)
    q, k = queries + query_pe, keys + key_pe
    queries = queries + dec_attention(
        sd, f"{name}.cross_attn_token_to_image", q, k, keys, heads)
    queries = layer_norm(sd, f"{name}.norm2", queries, 1e-5)
    h = linear(sd, f"{name}.mlp.lin2",
               F.relu(linear(sd, f"{name}.mlp.lin1", queries)))
    queries = layer_norm(sd, f"{name}.norm3", queries + h, 1e-5)
    q, k = queries + query_pe, keys + key_pe
    keys = keys + dec_attention(sd, f"{name}.cross_attn_image_to_token", k,
                                q, queries, heads)
    keys = layer_norm(sd, f"{name}.norm4", keys, 1e-5)
    return queries, keys


def mask_decoder(sd, cfg, image_embeddings, image_pe, sparse, dense):
    """One frame's embedding [1, d, g, g] against its N prompts -> masks
    [N, 4, 4g, 4g], iou [N, 4]."""
    p = "mask_decoder"
    heads = cfg["decoder_num_heads"]
    n_masks = cfg["num_multimask_outputs"] + 1
    output_tokens = torch.cat([sd[f"{p}.iou_token.weight"],
                               sd[f"{p}.mask_tokens.weight"]], dim=0)
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
        queries, keys = two_way_block(sd, f"{t}.layers.{i}", queries, keys,
                                      tokens, key_pe, heads, i == 0)
    q, k = queries + tokens, keys + key_pe
    queries = queries + dec_attention(sd, f"{t}.final_attn_token_to_image",
                                      q, k, keys, heads)
    hs = layer_norm(sd, f"{t}.norm_final_attn", queries, 1e-5)
    iou_token_out = hs[:, 0, :]
    mask_tokens_out = hs[:, 1:(1 + n_masks), :]
    src = keys.transpose(1, 2).reshape(b, c, h, w)
    u = f"{p}.output_upscaling"
    up = F.conv_transpose2d(src, sd[f"{u}.0.weight"], sd[f"{u}.0.bias"],
                            stride=2)
    up = F.gelu(layer_norm2d(sd, f"{u}.1", up))
    up = F.gelu(F.conv_transpose2d(up, sd[f"{u}.3.weight"],
                                   sd[f"{u}.3.bias"], stride=2))
    hyper_in = torch.stack(
        [mlp(sd, f"{p}.output_hypernetworks_mlps.{i}", mask_tokens_out[:, i],
             3) for i in range(n_masks)], dim=1)
    b, c, h, w = up.shape
    masks = (hyper_in @ up.reshape(b, c, h * w)).view(b, -1, h, w)
    iou = mlp(sd, f"{p}.iou_prediction_head", iou_token_out,
              cfg["iou_head_depth"])
    return masks, iou


# ---------------------------------------------------------------------------
# the predictor's transforms and the whole pipeline
# ---------------------------------------------------------------------------

def preprocess_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    scale = size * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def resize_axis(x, axis: int, out: int):
    """Bilinear along one axis, half-pixel centres, no antialiasing: each
    output sample at (i + 0.5) * in / out - 0.5 (in float64; clamped to
    the edge) between its two neighbours."""
    n = x.shape[axis]
    pos = (torch.arange(out, dtype=torch.float64) + 0.5) * (n / out) - 0.5
    pos = pos.clamp(min=0.0)
    i0 = pos.floor().long().clamp(max=n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    w = (pos - i0).float().to(x.device)
    shape = [1] * x.dim()
    shape[axis] = out
    w = w.reshape(shape)
    return x.index_select(axis, i0.to(x.device)) * (1 - w) \
        + x.index_select(axis, i1.to(x.device)) * w


def preprocess(cfg, frames):
    """uint8 [B, H, W, 3] -> [B, 3, S, S]: the longest side resized to S,
    normalised, zero-padded at the bottom and right."""
    S = cfg["image_size"]
    x = frames.permute(0, 3, 1, 2).float()
    nh, nw = preprocess_shape(x.shape[2], x.shape[3], S)
    x = resize_axis(resize_axis(x, 2, nh), 3, nw)
    mean = torch.tensor(cfg["pixel_mean"], device=x.device)[:, None, None]
    std = torch.tensor(cfg["pixel_std"], device=x.device)[:, None, None]
    x = (x - mean) / std
    return F.pad(x, (0, S - nw, 0, S - nh))


def apply_boxes(boxes, frame_hw, size):
    """ResizeLongestSide.apply_boxes: xyxy in frame pixels -> input
    pixels."""
    nh, nw = preprocess_shape(frame_hw[0], frame_hw[1], size)
    coords = boxes.reshape(-1, 2, 2).clone().float()
    coords[..., 0] = coords[..., 0] * (nw / frame_hw[1])
    coords[..., 1] = coords[..., 1] * (nh / frame_hw[0])
    return coords.reshape(boxes.shape)


def postprocess_masks(masks, input_hw, frame_hw, size):
    masks = F.interpolate(masks, (size, size), mode="bilinear",
                          align_corners=False)
    masks = masks[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(masks, frame_hw, mode="bilinear",
                         align_corners=False)


def run(sd: Dict[str, torch.Tensor], cfg, frames, boxes):
    """frames uint8 [B, H, W, 3], boxes [B, P, 4] xyxy in frame pixels ->
    masks [B, P, 4, 4g, 4g], iou [B, P, 4], frame_logits [B, P, H, W]
    (mask 0 at the frame's size), float32."""
    S = cfg["image_size"]
    H, W = frames.shape[1:3]
    g = S // cfg["vit_patch_size"]
    input_hw = preprocess_shape(H, W, S)
    out = {"masks": [], "iou": [], "frame_logits": []}
    with torch.no_grad(), float32_scope():
        emb = image_encoder(sd, cfg, preprocess(cfg, frames))
        pe = dense_pe(sd, g)
        dense = sd["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1)
        for i in range(frames.shape[0]):
            sparse = embed_boxes(sd, apply_boxes(boxes[i], (H, W), S), S)
            masks, iou = mask_decoder(sd, cfg, emb[i:i + 1], pe, sparse,
                                      dense)
            out["masks"].append(masks)
            out["iou"].append(iou)
            out["frame_logits"].append(postprocess_masks(
                masks[:, :1], input_hw, (H, W), S)[:, 0])
    return {k: torch.stack(v) for k, v in out.items()}
