"""Area attention (YOLO12's AAttn): per head, softmax(q k^T * scale) v
over the tokens of one area, as one fused call on the card.

  area_attention(q, k, v, scale)   q, k, v [B', heads, N', d] (the last
                                   dim dense) -> o [B', heads, N', d] in
                                   q's dtype

CPU tensors take the plain composition, area_attention_torch: the scores
and the softmax in float32 and one rounding of the product to q's dtype.
It builds the [N', N'] score matrix, and the tests hold the card's path
and the benchmark's reference to it.

CUDA tensors take area_attention_cuda: torch's
scaled_dot_product_attention restricted to its fused backends (flash,
memory-efficient, cuDNN), which keep each score tile on chip. If none of
them takes the call (a head size, dtype or layout they refuse) it
raises: the math backend would build the score matrix in device memory,
8.8 GB a P4 block of YOLO12x at 960x1280 and b=32. It replaces no Pallas
kernel: the JAX package has no YOLO12.

Counters on area_attention_cuda: `calls` (fused calls) and `by_backend`
(the backend SDPA chose for each, by name: "FLASH_ATTENTION",
"EFFICIENT_ATTENTION", "CUDNN_ATTENTION"; "MATH" never appears, since
such a call raises). A YOLO12x forward makes 16 calls.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F


def area_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The plain version: float32 scores, softmax and product."""
    attn = (q.float() @ k.float().transpose(-2, -1)) * scale
    return (attn.softmax(-1) @ v.float()).to(q.dtype)


def area_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """SDPA on the card through a fused backend, or a RuntimeError.

    SDPA under sdpa_kernel(fused) would raise by itself where no fused
    backend takes the call; the choice is asked for first only to count
    it in `by_backend` and to name it in the error."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"area_attention_cuda runs on one card: q on "
                         f"{q.device}, k on {k.device}, v on {v.device}")
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        try:
            choice = SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                                        False, scale=scale))
        except RuntimeError as e:
            choice, why = SDPBackend.ERROR, e
        else:
            why = f"SDPA chose {choice.name}"
        if choice not in fused:
            raise RuntimeError(
                f"no fused SDPA backend takes q {tuple(q.shape)} "
                f"{q.dtype} strides {q.stride()}: {why}")
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    area_attention_cuda.calls += 1
    area_attention_cuda.by_backend[choice.name] += 1
    return o


area_attention_cuda.calls = 0
area_attention_cuda.by_backend = collections.Counter()


def area_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """q, k, v [B', heads, N', d] -> softmax(q k^T * scale) v, inside a
    profiler range `xrseg.area_attn` while a profiler records."""
    fn = area_attention_cuda if q.is_cuda else area_attention_torch
    if not torch.autograd._profiler_enabled():
        return fn(q, k, v, scale)
    with torch.profiler.record_function("xrseg.area_attn"):
        return fn(q, k, v, scale)
