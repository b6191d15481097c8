"""Greedy select-and-suppress NMS kernels (K1, K2), their wrappers and their
plain versions.

The CUDA source is xrseg_tpu_torch/csrc/nms_select.cu (one block per
image, candidates resident in shared memory); it replaces the TPU kernels
xrseg_tpu/ops/pallas_kernels.py `nms_select_batched_pallas` (K1) and
`nms_select_pallas` (K2).

  nms_select_batched_cuda  K1: corners [B,K,4], masked scores [B,K]
  nms_select_cuda          K2: corners [K,4], masked scores [K]
                           (the same __global__ launched with B = 1)

Both return (idx int32, ok bool) of max_det greedy steps in selection
order. Scores below the score gate must already be float32 min (NEG).

A wrapper given CPU tensors runs the plain version (nms_select_*_torch),
which repeats the kernel's arithmetic step by step in torch; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its own
launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build

NEG = float(np.finfo(np.float32).min)


def as_f32(x: float) -> float:
    """The float32 rounding of a Python float, as a Python float: what the
    kernel receives, and what the plain versions compare against."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _area(x1, y1, x2, y2):
    return (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)


def nms_select_batched_torch(corners: torch.Tensor, masked: torch.Tensor,
                             iou_threshold: float, max_det: int = 50
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's loop in torch: corners [B,K,4] f32, masked [B,K] f32 ->
    (idx [B,max_det] int32, ok [B,max_det] bool)."""
    B, K = masked.shape
    x1, y1, x2, y2 = corners.float().unbind(-1)
    area = _area(x1, y1, x2, y2)
    col = torch.arange(K, device=masked.device)
    thr = as_f32(iou_threshold)
    masked = masked.float()
    idx, oks = [], []
    for _ in range(max_det):
        m = masked.max(-1, keepdim=True).values
        ok = m > NEG * 0.5
        i = torch.where(masked == m, col, K).min(-1, keepdim=True).values

        def g(v):
            return v.gather(-1, i)

        iw = (torch.minimum(x2, g(x2)) - torch.maximum(x1, g(x1))).clamp_min(0)
        ih = (torch.minimum(y2, g(y2)) - torch.maximum(y1, g(y1))).clamp_min(0)
        inter = iw * ih
        union = area + g(area) - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        suppress = (iou > thr) | (col == i)
        masked = torch.where(ok & suppress, NEG, masked)
        idx.append(i[:, 0])
        oks.append(ok[:, 0])
    return torch.stack(idx, 1).int(), torch.stack(oks, 1)


def nms_select_torch(corners: torch.Tensor, masked: torch.Tensor,
                     iou_threshold: float, max_det: int = 50
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single image: corners [K,4], masked [K] -> (idx, ok) [max_det]."""
    idx, ok = nms_select_batched_torch(corners[None], masked[None],
                                       iou_threshold, max_det)
    return idx[0], ok[0]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.library("nms_select")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xrseg_nms_select.argtypes = [vp, vp, ci, ci, ctypes.c_float, ci,
                                         vp, vp, vp]
        lib.xrseg_nms_select.restype = ci
        lib.xrseg_nms_select_max_k.argtypes = [ci]
        lib.xrseg_nms_select_max_k.restype = ci
        lib.xrseg_cuda_error_string.argtypes = [ci]
        lib.xrseg_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _launch(corners: torch.Tensor, masked: torch.Tensor,
            iou_threshold: float, max_det: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """corners [B,K,4], masked [B,K], both float32, contiguous, on one card."""
    if corners.dtype != torch.float32 or masked.dtype != torch.float32:
        raise TypeError(f"nms_select needs float32 inputs, got "
                        f"{corners.dtype} and {masked.dtype}")
    if masked.device != corners.device:
        raise ValueError(f"inputs on {corners.device} and {masked.device}")
    if not (corners.is_contiguous() and masked.is_contiguous()):
        raise ValueError("nms_select needs contiguous inputs")
    B, K = masked.shape
    if tuple(corners.shape) != (B, K, 4):
        raise ValueError(f"corners {tuple(corners.shape)} do not match "
                         f"scores {tuple(masked.shape)}")
    if K < 1 or max_det < 1:
        raise ValueError(f"nms_select needs K >= 1 and max_det >= 1, got "
                         f"K={K}, max_det={max_det}")
    lib = _lib()
    dev = corners.device.index
    max_k = lib.xrseg_nms_select_max_k(dev)
    if K > max_k:
        raise ValueError(f"K={K} candidates exceed the kernel's shared-memory "
                         f"limit of {max_k} per image on this card")
    idx = torch.empty((B, max_det), dtype=torch.int32, device=corners.device)
    ok = torch.empty((B, max_det), dtype=torch.bool, device=corners.device)
    with torch.cuda.device(corners.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xrseg_nms_select(corners.data_ptr(), masked.data_ptr(), B,
                                   K, as_f32(iou_threshold), max_det,
                                   idx.data_ptr(), ok.data_ptr(), stream)
    if err:
        raise RuntimeError("nms_select launch failed: "
                           + lib.xrseg_cuda_error_string(err).decode())
    return idx, ok


def _check_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for others."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"nms_select runs on cuda or cpu tensors, not "
                     f"{t.device}")


def nms_select_batched_cuda(corners: torch.Tensor, masked: torch.Tensor,
                            iou_threshold: float, max_det: int = 50
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: corners [B,K,4] f32, masked [B,K] f32 -> (idx, ok) [B,max_det]."""
    if not _check_device(corners):
        return nms_select_batched_torch(corners, masked, iou_threshold,
                                        max_det)
    out = _launch(corners, masked, iou_threshold, max_det)
    nms_select_batched_cuda.launches += 1
    return out


def nms_select_cuda(corners: torch.Tensor, masked: torch.Tensor,
                    iou_threshold: float, max_det: int = 50
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: corners [K,4] f32, masked [K] f32 -> (idx, ok) [max_det]."""
    if not _check_device(corners):
        return nms_select_torch(corners, masked, iou_threshold, max_det)
    if corners.dim() != 2 or masked.dim() != 1:
        raise ValueError(f"nms_select_cuda takes [K,4] and [K], got "
                         f"{tuple(corners.shape)} and {tuple(masked.shape)}")
    idx, ok = _launch(corners[None], masked[None], iou_threshold, max_det)
    nms_select_cuda.launches += 1
    return idx[0], ok[0]


nms_select_batched_cuda.launches = 0
nms_select_cuda.launches = 0
