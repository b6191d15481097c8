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
scaled_dot_product_attention restricted to FUSED_BACKENDS (flash,
memory-efficient, cuDNN), which keep each score tile on chip. If none of
them takes the call (a head size, dtype or layout they refuse) it
raises: the math backend would build the score matrix in device memory,
8.8 GB a P4 block of YOLO12x at 960x1280 and b=32. It replaces no Pallas
kernel: the JAX package has no YOLO12.

area_attention_cuda counts its calls in ops/launches; a YOLO12x forward
makes 16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from xrseg_tpu_torch.ops import launches

# the backends area_attention_cuda lets SDPA choose from: never MATH
FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION]


def area_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The plain version: float32 scores, softmax and product."""
    attn = (q.float() @ k.float().transpose(-2, -1)) * scale
    return (attn.softmax(-1) @ v.float()).to(q.dtype)


def area_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """SDPA on the card through one of FUSED_BACKENDS, or a RuntimeError
    that names the call and SDPA's reason."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"area_attention_cuda runs on one card: q on "
                         f"{q.device}, k on {k.device}, v on {v.device}")
    with sdpa_kernel(FUSED_BACKENDS):
        try:
            o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        except RuntimeError as e:
            raise RuntimeError(
                f"no fused SDPA backend takes q {tuple(q.shape)} "
                f"{q.dtype} strides {q.stride()}: {e}") from e
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
