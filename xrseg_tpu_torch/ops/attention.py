"""Attention on the card as fused calls: YOLO12's area attention and
Segment Anything's attention with a decomposed relative-position bias.

  area_attention(q, k, v, scale)   q, k, v [B', heads, N', d] (the last
                                   dim dense) -> o [B', heads, N', d] in
                                   q's dtype
  relpos_attention(q, k, v, rel_pos_h, rel_pos_w, q_hw, scale, kind=)
                                   the same over the N = qh * qw tokens of
                                   a (qh, qw) map, the scores biased by
                                   rel_h[q, kh] + rel_w[q, kw] (SAM's
                                   add_decomposed_rel_pos)
  attend(q, k, v)                  softmax(q k^T / sqrt(d)) v, SAM's
                                   mask decoder's attention

CPU tensors take the plain compositions (`*_torch`): the scores, the
bias and the softmax in float32 and one rounding of the product to q's
dtype. They build the [N, N] score matrix, and the tests hold the card's
path and the benchmark's references to them.

CUDA tensors take the `*_cuda` forms: torch's scaled_dot_product_attention
restricted to FUSED_BACKENDS (flash, memory-efficient, cuDNN), which keep
each score tile on chip. If none of them takes the call (a head size,
dtype, layout or bias they refuse) it raises: the math backend would
build the score matrix in device memory, 8.8 GB a P4 block of YOLO12x at
960x1280 and b=32. relpos_attention_cuda materialises its bias, [B',
heads, N, N] in q's dtype (4.3 GB a global block of SAM ViT-H at b=8),
and hands it to SDPA as an additive mask; flash takes no mask, so the
memory-efficient or the cuDNN kernel runs it. Neither replaces a Pallas
kernel: the JAX package has neither model.

The window helpers are SAM's: `window_partition` pads a [B, H, W, C] map
with zeros at the bottom and right to a multiple of the window and cuts
it into windows; the pad tokens are keys like any other (nothing masks
them); `window_unpartition` undoes both.

Calls are counted in ops/launches: `area_attention_cuda` (16 a YOLO12x
forward) and `relpos_attention_cuda` with the details "window" and
"global" (28 and 4 a SAM ViT-H forward); `attend` (7 calls a SAM
decoder) counts nothing.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from xrseg_tpu_torch.ops import launches

# the backends the *_cuda forms let SDPA choose from: never MATH
FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION]
# elements between the rows of relpos_attention_cuda's bias
BIAS_ALIGN = 16


def area_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The plain version: float32 scores, softmax and product."""
    attn = (q.float() @ k.float().transpose(-2, -1)) * scale
    return (attn.softmax(-1) @ v.float()).to(q.dtype)


def _fused_sdpa(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, bias=None) -> torch.Tensor:
    """SDPA on the card through one of FUSED_BACKENDS, or a RuntimeError
    that names the call and SDPA's reason."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} runs on one card: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    with sdpa_kernel(FUSED_BACKENDS):
        try:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                  scale=scale)
        except RuntimeError as e:
            raise RuntimeError(
                f"no fused SDPA backend takes q {tuple(q.shape)} "
                f"{q.dtype} strides {q.stride()}"
                + ("" if bias is None else
                   f" with a bias {tuple(bias.shape)} strides "
                   f"{bias.stride()}") + f": {e}") from e


def area_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """SDPA on the card through one of FUSED_BACKENDS, or a RuntimeError
    that names the call and SDPA's reason."""
    o = _fused_sdpa("area_attention_cuda", q, k, v, scale)
    launches.count("area_attention_cuda")
    return o


def area_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """q, k, v [B', heads, N', d] -> softmax(q k^T * scale) v, inside a
    profiler range `xrseg.area_attn` while a profiler records."""
    fn = area_attention_cuda if q.is_cuda else area_attention_torch
    if not torch.autograd._profiler_enabled():
        return fn(q, k, v, scale)
    with torch.profiler.record_function("xrseg.area_attn"):
        return fn(q, k, v, scale)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """SAM's decoder attention, softmax(q k^T / sqrt(d)) v over [B',
    heads, N, d]: SDPA through FUSED_BACKENDS on the card, else float32
    with the division as SAM writes it (a product by d^-0.5 rounds
    otherwise, and the decoder's softmax carries that to its logits)."""
    d = q.shape[-1]
    if q.is_cuda:
        return _fused_sdpa("attend", q, k, v, d ** -0.5)
    attn = (q.float() @ k.float().transpose(-2, -1)) / math.sqrt(d)
    return (attn.softmax(-1) @ v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Segment Anything: decomposed relative-position bias, windows
# ---------------------------------------------------------------------------

def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """SAM's get_rel_pos: the table rows for every (query, key) offset,
    [q_size, k_size, d], row (i - j) + (k_size - 1) for q_size == k_size.
    A table of another length than 2 * max(q_size, k_size) - 1 is first
    resized to it linearly, as SAM does."""
    dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != dist:
        rel_pos = F.interpolate(rel_pos.float().t()[None], size=dist,
                                mode="linear")[0].t().to(rel_pos.dtype)
    return rel_pos[_rel_index_on(q_size, k_size, rel_pos.device)]


@functools.lru_cache(maxsize=32)
def _rel_index_on(q_size: int, k_size: int, device: torch.device
                  ) -> torch.Tensor:
    """get_rel_pos's [q_size, k_size] row indices on `device`, made once."""
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return idx.long().to(device)


def _rel_terms(q, rel_pos_h, rel_pos_w, q_hw, dt):
    """The decomposed bias's two terms of the unscaled queries q [B',
    heads, qh * qw, d], in `dt`: rel_h [B', heads, qh, qw, qh] = q .
    Rh[y, ky] and rel_w [B', heads, qh, qw, qw] = q . Rw[x, kx]; the bias
    at key (ky, kx) is rel_h[.., ky] + rel_w[.., kx]."""
    qh, qw = q_hw
    B, nh, _, d = q.shape
    rh = get_rel_pos(qh, qh, rel_pos_h).to(dt)
    rw = get_rel_pos(qw, qw, rel_pos_w).to(dt)
    r_q = q.to(dt).reshape(B, nh, qh, qw, d)
    return torch.einsum("bnhwc,hkc->bnhwk", r_q, rh), \
        torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)


@functools.lru_cache(maxsize=16)
def _bias_expander(qh: int, qw: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """[qh + qw, qh * qw] 0/1: column (ky, kx) holds 1 in rows ky and
    qh + kx, so [rel_h | rel_w] @ it = rel_h[.., ky] + rel_w[.., kx]."""
    e = torch.zeros(qh + qw, qh, qw)
    e[torch.arange(qh), torch.arange(qh)] = 1.0
    e[qh + torch.arange(qw), :, torch.arange(qw)] = 1.0
    return e.reshape(qh + qw, qh * qw).to(device, dtype)


def relpos_attention_torch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                           scale: float) -> torch.Tensor:
    """The plain version: float32 scores, bias (added in SAM's order),
    softmax and product."""
    B, nh, N, _ = q.shape
    qh, qw = q_hw
    attn = (q.float() * scale) @ k.float().transpose(-2, -1)
    rel_h, rel_w = _rel_terms(q, rel_pos_h, rel_pos_w, q_hw, torch.float32)
    attn = attn.view(B, nh, qh, qw, qh, qw) + rel_h[..., :, None] \
        + rel_w[..., None, :]
    return (attn.view(B, nh, N, N).softmax(-1) @ v.float()).to(q.dtype)


def relpos_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, rel_pos_h: torch.Tensor,
                          rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                          scale: float, kind: str = "global"
                          ) -> torch.Tensor:
    """SDPA on the card through one of FUSED_BACKENDS with the bias
    materialised in q's dtype as its additive mask, or a RuntimeError
    that names the call and SDPA's reason. Counted under `kind`.

    The bias is one GEMM, [rel_h | rel_w] [B' * heads * N, qh + qw] times
    the 0/1 matrix that sends key (ky, kx) its rows ky and qh + kx
    (`_bias_expander`): each element is rel_h + rel_w summed in float32
    and rounded once, as the broadcast sum would be, written at the
    GEMM's rate (a broadcast add over six dims ran at a tenth of the
    card's bandwidth: 9.7 of 11.3 ms a global block at b=8). Its rows lie
    BIAS_ALIGN elements apart (196 keys: 208), as the memory-efficient
    and cuDNN kernels read a mask; SDPA would otherwise copy an unaligned
    mask into a padded one on every call."""
    B, nh, N, _ = q.shape
    rel_h, rel_w = _rel_terms(q, rel_pos_h, rel_pos_w, q_hw, q.dtype)
    row = -(-N // BIAS_ALIGN) * BIAS_ALIGN
    bias = torch.empty(B * nh * N, row, dtype=q.dtype, device=q.device)
    torch.mm(torch.cat([rel_h, rel_w], -1).reshape(B * nh * N, -1),
             _bias_expander(*q_hw, q.dtype, q.device), out=bias[:, :N])
    bias = bias.view(B, nh, N, row)[..., :N]
    o = _fused_sdpa("relpos_attention_cuda", q, k, v, scale, bias)
    launches.count("relpos_attention_cuda", kind)
    return o


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                     q_hw: Tuple[int, int], scale: float,
                     kind: str = "global") -> torch.Tensor:
    """q, k, v [B', heads, qh * qw, d] -> softmax(q k^T * scale + bias) v,
    the bias _rel_terms's; inside a profiler range `xrseg.relpos_attn`
    (the bias built inside it) while a profiler records. `kind` ("window"
    or "global") names the call in the launch count."""
    def run():
        if q.is_cuda:
            return relpos_attention_cuda(q, k, v, rel_pos_h, rel_pos_w, q_hw,
                                         scale, kind)
        return relpos_attention_torch(q, k, v, rel_pos_h, rel_pos_w, q_hw,
                                      scale)

    if not torch.autograd._profiler_enabled():
        return run()
    with torch.profiler.record_function("xrseg.relpos_attn"):
        return run()


def window_partition(x: torch.Tensor, window: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> windows [B * nh * nw, window, window, C] in
    row-major window order, the map first padded with zeros at the bottom
    and right to (Hp, Wp), multiples of `window`; returns (Hp, Wp) too."""
    B, H, W, C = x.shape
    ph, pw = (window - H % window) % window, (window - W % window) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), \
        (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """window_partition's inverse: windows -> [B, H, W, C], the pad
    cropped."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.view(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W].contiguous() if (Hp, Wp) != (H, W) else x
