"""The conv epilogue: bias, SiLU and the rounding to bf16 after a bf16
convolution, in one pass (its wrapper and its plain version).

The CUDA source is xrseg_tpu_torch/csrc/conv_epilogue.cu (16-byte vectors
of 8 bf16, or 8-byte vectors of 4 where the channels or the plane come in
fours only, one bias load a vector where the vector's lanes share a
channel, a scalar path for odd shapes and unaligned starts). It replaces
no Pallas kernel: the JAX package's conv_apply leaves the epilogue to
XLA's fusion.

  conv_epilogue_cuda   y [B,C,H,W] bf16 (NCHW or channels-last), bias [C]
                       f32, act -> bf16_rn([silu](float(y) + bias)), in y's
                       layout; on the card in place, into y itself

The plain version, conv_epilogue_torch, is the composition the kernel
replaces and is bit-equal to: .float(), + bias, F.silu, .to(y.dtype), four
elementwise passes. models/layers.conv_apply and conv_transpose_apply call
the wrapper for a bf16 conv on the card when no gradient is needed
(through its output or to its bias), and the plain version otherwise (the
CPU, float32 compute, autograd).

The wrapper takes CUDA tensors only: it launches the kernel or raises
(models/layers makes the choice between it and the plain version). It
counts its launches in `conv_epilogue_cuda.launches`, and those on a
channels-last output (the network's layout on the card) in
`conv_epilogue_cuda.launches_channels_last`. A traced tensor
(torch.export's fake and functional tensors) goes through the custom op
`xrseg::conv_epilogue`, so an exported program holds the kernel. An eager
tensor skips the dispatcher, which a forward would pay once a conv: on an
H100 host the op takes 33 us a call against 14 us for the direct launch,
and a b=1 YOLO11n-seg frame (100 epilogues) 21.1 ms against 16.9 ms.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from xrseg_tpu_torch import _build


def conv_epilogue_torch(y: torch.Tensor, bias: torch.Tensor,
                        act: bool) -> torch.Tensor:
    """The plain version: bias and SiLU in float32, one rounding to y's
    dtype."""
    out = y.float() + bias.float()[:, None, None]
    if act:
        out = F.silu(out)
    return out.to(y.dtype)


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "xrseg_conv_epilogue": [_VP, _VP, _VP, _CLL, _CLL, _CI, _CI, _CI, _VP],
}


def _check(y: torch.Tensor, bias: torch.Tensor) -> int:
    """Raise for what the kernel does not take; return `inner`, the
    elements from one channel to the next (H*W for NCHW, 1 for
    channels-last)."""
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"conv_epilogue takes bf16 y and a float32 bias, "
                        f"got {y.dtype} and {bias.dtype}")
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"conv_epilogue takes y [B,C,H,W] and bias [C], "
                         f"got {tuple(y.shape)} and {tuple(bias.shape)}")
    if not bias.is_contiguous():
        raise ValueError("conv_epilogue needs a contiguous bias")
    if y.is_contiguous():
        return y.shape[2] * y.shape[3]
    if y.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"conv_epilogue needs y dense in NCHW or channels-last, "
                     f"got strides {y.stride()}")


def _launch(y: torch.Tensor, bias: torch.Tensor, act: bool,
            out: torch.Tensor, inner: int) -> None:
    """The kernel from y into out (which may be y) on the current stream
    of y's card."""
    if not y.is_cuda or bias.device != y.device:
        raise ValueError(f"conv_epilogue runs on one card: y on "
                         f"{y.device}, bias on {bias.device}")
    lib = _build.library("conv_epilogue", _SIGNATURES)
    dev = y.device.index
    err = lib.xrseg_conv_epilogue(
        y.data_ptr(), bias.data_ptr(), out.data_ptr(), y.numel(), inner,
        y.shape[1], act, dev, torch._C._cuda_getCurrentRawStream(dev))
    _build.check_launch(lib, err, "conv_epilogue")
    conv_epilogue_cuda.launches += 1
    if inner == 1:
        conv_epilogue_cuda.launches_channels_last += 1


@torch.library.custom_op("xrseg::conv_epilogue", mutates_args=())
def _conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor,
                      act: bool) -> torch.Tensor:
    return conv_epilogue_torch(y, bias, act)


@_conv_epilogue_op.register_kernel("cuda")
def _(y, bias, act):
    out = torch.empty_like(y)
    _launch(y, bias, act, out, _check(y, bias))
    return out


@_conv_epilogue_op.register_fake
def _(y, bias, act):
    return torch.empty_like(y)


def conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                       act: bool) -> torch.Tensor:
    """y [B,C,H,W] bf16, bias [C] f32 -> bf16_rn([silu](float(y) + bias)).
    On the card the result is y itself, overwritten."""
    inner = _check(y, bias)
    if type(y) is not torch.Tensor:      # traced by torch.export
        return torch.ops.xrseg.conv_epilogue(y, bias, act)
    _launch(y, bias, act, y, inner)
    return y


conv_epilogue_cuda.launches = 0
conv_epilogue_cuda.launches_channels_last = 0
