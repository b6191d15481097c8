"""Greedy select-and-suppress NMS kernels (K1, K2, K3), their wrappers, their
launch plan and their plain versions.

The CUDA sources are xrseg_tpu_torch/csrc/nms_select.cu (K1, K2: IoU of
axis-aligned boxes) and csrc/nms_rotated.cu (K3: probIoU of rotated boxes);
both run the loop of csrc/nms_common.cuh. They replace the TPU kernels of
xrseg_tpu/ops/pallas_kernels.py:

  nms_select_batched_cuda   K1 `nms_select_batched_pallas`: corners
                            [B,K,4], masked scores [B,K]
  nms_select_cuda           K2 `nms_select_pallas`: corners [K,4], masked
                            scores [K] (K1's __global__ launched with B = 1)
  nms_rotated_batched_cuda  K3 `nms_rotated_batched_pallas`: Gaussian rows
                            [B,6,K] from rotated_gaussian_rows, masked
                            scores [B,K] (probIoU overlap)

Each returns (idx int32, ok bool) of max_det greedy steps in selection
order. Scores below the score gate must already be float32 min (NEG).

What bounds the kernels is the latency of one greedy step (the 50 steps
are a serial chain) and how many SMs one image can use. So one image runs
on a thread-block cluster of up to 8 blocks; every block keeps its slice of
the candidates, geometry included, in shared memory, and a step is one
fused suppress-and-argmax pass, one block barrier and one wait on the
block's own mbarrier for the other blocks' winners, sent with st.async
through distributed shared memory (csrc/nms_common.cuh). `launch_plan`
chooses the cluster size, the threads and the shared-memory bytes from B,
K and the card's limits; it is a pure function, and the C launchers only
validate what it hands them.

A wrapper given CPU tensors runs the plain version (nms_*_torch),
which repeats the kernel's arithmetic step by step in torch; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its
launches under its own name in ops/launches; K1 also counts them per batch
size.
"""
import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.ops import launches

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


PROBIOU_EPS = 1e-7


def rbox_covariance(xywhr: torch.Tensor):
    """Rotated boxes [...,5] (cx, cy, w, h, angle) -> the covariance terms
    (a, b, c) of their Gaussian embedding: w^2/12 and h^2/12 rotated by the
    angle. Each side is floored at 1e-3 px: a zero-area box would otherwise
    have zero covariance and a probIoU near 1 against anything."""
    w = xywhr[..., 2].clamp_min(1e-3)
    h = xywhr[..., 3].clamp_min(1e-3)
    a0 = w * w / 12.0
    b0 = h * h / 12.0
    cs, sn = torch.cos(xywhr[..., 4]), torch.sin(xywhr[..., 4])
    a = a0 * cs * cs + b0 * sn * sn
    b = a0 * sn * sn + b0 * cs * cs
    c = (a0 - b0) * cs * sn
    return a, b, c


def probiou_gauss(x1, y1, a1, b1, c1, det1, x2, y2, a2, b2, c2, det2,
                  eps: float = PROBIOU_EPS) -> torch.Tensor:
    """probIoU of box 1 against box 2 from their Gaussian terms (det =
    clamp_min(a*b - c*c, 0)), broadcasting. The operation order is K3's
    (csrc/nms_rotated.cu) and the TPU kernel's; the quadratic form is
    clamped at 0 before eps is added (it rounds negative for degenerate
    pairs, and log of a negative is NaN)."""
    sa, sb, sc = a1 + a2, b1 + b2, c1 + c2
    dy, dx = y1 - y2, x1 - x2
    denom = (sa * sb - sc * sc).clamp_min(0) + eps
    t1 = (sa * (dy * dy) + sb * (dx * dx)) / denom * 0.25
    t2 = (sc * (x2 - x1) * dy) / denom * 0.5
    t3 = 0.5 * torch.log(
        denom / (4.0 * torch.sqrt((det1 * det2).clamp_min(0)) + eps) + eps)
    bd = torch.clamp(t1 + t2 + t3, eps, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)


def rotated_gaussian_rows(shifted: torch.Tensor) -> torch.Tensor:
    """K3's inputs: rotated boxes [B,K,5] (class offset already added to cx
    and cy) -> rows [B,6,K] f32: x, y, a, b, c, det. The TPU kernel's
    host-side terms (pallas_kernels.py:388-401); the kernel and its plain
    version both take this output."""
    bx = shifted.float()
    a, b, c = rbox_covariance(bx)
    det = (a * b - c * c).clamp_min(0)
    return torch.stack([bx[..., 0], bx[..., 1], a, b, c, det], -2).contiguous()


def rotated_steps(rows: torch.Tensor, masked: torch.Tensor,
                  iou_threshold: float, max_det: int = 50):
    """K3's loop in torch, one greedy step at a time: rows [B,6,K], masked
    [B,K] -> yields (i [B,1], ok [B,1], masked [B,K] as the step found it)."""
    K = masked.shape[-1]
    x, y, a, b, c, det = rows.float().unbind(-2)
    col = torch.arange(K, device=masked.device)
    thr = as_f32(iou_threshold)
    masked = masked.float()
    for _ in range(max_det):
        m = masked.max(-1, keepdim=True).values
        ok = m > NEG * 0.5
        i = torch.where(masked == m, col, K).min(-1, keepdim=True).values

        def g(v):
            return v.gather(-1, i)

        iou = probiou_gauss(g(x), g(y), g(a), g(b), g(c), g(det),
                            x, y, a, b, c, det)
        suppress = (iou > thr) | (col == i)
        yield i, ok, masked
        masked = torch.where(ok & suppress, NEG, masked)


def nms_rotated_batched_torch(rows: torch.Tensor, masked: torch.Tensor,
                              iou_threshold: float, max_det: int = 50
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: rows [B,6,K] f32 (rotated_gaussian_rows), masked
    [B,K] f32 -> (idx [B,max_det] int32, ok [B,max_det] bool)."""
    idx, oks = [], []
    for i, ok, _ in rotated_steps(rows, masked, iou_threshold, max_det):
        idx.append(i[:, 0])
        oks.append(ok[:, 0])
    return torch.stack(idx, 1).int(), torch.stack(oks, 1)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

CLUSTER_SIZES = (1, 2, 4, 8)          # 8 is the portable maximum
MAX_THREADS = 1024
STATIC_SMEM_RESERVE = 2048            # kStaticSmemReserve of nms_common.cuh
# resident bytes per candidate: the masked score and the geometry
BYTES_PER_CANDIDATE = {"nms_select": 4 * (1 + 4), "nms_rotated": 4 * (1 + 6)}


def _slice(K: int, cluster: int) -> int:
    """Candidates owned by one block: block r holds [r*S, min(K, r*S + S))."""
    return -(-K // cluster)


def max_k(what: str, smem_optin: int) -> int:
    """The largest K the kernel of csrc/<what>.cu takes: the one whose
    slices fill the shared memory of the largest cluster's blocks."""
    per_block = (smem_optin - STATIC_SMEM_RESERVE) // BYTES_PER_CANDIDATE[what]
    return max(per_block, 0) * CLUSTER_SIZES[-1]


def launch_plan(what: str, B: int, K: int, sm_count: int, smem_optin: int,
                room: Optional[Dict[int, int]] = None,
                cluster: Optional[int] = None) -> Tuple[int, int, int]:
    """(cluster size, threads per block, dynamic shared-memory bytes per
    block) for B images of K candidates on a card with `sm_count` SMs and
    `smem_optin` bytes of opt-in shared memory a block. `room[c]` is the
    number of clusters of c blocks the card runs at once with an SM to each
    block (the card's own answer where the wrapper asks; sm_count // c
    otherwise).

    Up to 1024 candidates an image takes one block: a candidate a thread,
    and a step with one barrier and no traffic between blocks. Beyond that
    the cluster is the largest of 8, 4, 2, 1 that still gives the images'
    clusters SMs of their own, B <= room[c] + 1: blocks that share an SM
    take turns, and the slowest image sets the launch's time. (One cluster
    past the card's answer ran at full speed at every size measured on an
    H100, where the card answers 15 and 30 for clusters of 8 and 4; two
    past it ran 1.2 to 2 times slower.) The cluster is never smaller than
    the smallest whose slices fit the blocks' shared memory; past the card's
    room such images run in waves. `cluster` forces a size instead; it must
    hold K. Threads: the slice spread evenly over the fewest passes of at
    most 1024 threads, rounded up to a warp.
    """
    if B < 1 or K < 1:
        raise ValueError(f"{what} needs B >= 1 and K >= 1, got B={B}, K={K}")
    per = BYTES_PER_CANDIDATE[what]
    budget = smem_optin - STATIC_SMEM_RESERVE
    fits = [c for c in CLUSTER_SIZES if _slice(K, c) * per <= budget]
    if not fits:
        raise ValueError(
            f"K={K} candidates exceed the kernel's shared-memory limit of "
            f"{max_k(what, smem_optin)} per image on this card (an image's "
            f"candidates, {per} bytes each, must fit the shared memory of a "
            f"cluster of {CLUSTER_SIZES[-1]} blocks)")
    if cluster is None:
        if room is None:
            room = {c: sm_count // c for c in CLUSTER_SIZES}
        own = [c for c in CLUSTER_SIZES
               if K > MAX_THREADS and B <= room[c] + 1]
        cluster = max(own[-1] if own else 1, fits[0])
    elif cluster not in fits:
        raise ValueError(
            f"a cluster of {cluster} blocks cannot hold K={K} candidates of "
            f"{what}: the sizes that can are {fits}")
    S = _slice(K, cluster)
    passes = -(-S // MAX_THREADS)
    threads = max(32, -(-(-(-S // passes)) // 32) * 32)
    return cluster, threads, S * per


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(_CI)
_SIGNATURES = {
    "nms_select": {"xrseg_nms_select": [_VP, _VP, _CI, _CI, _CF, _CI, _VP,
                                        _VP, _CI, _CI, _CI, _VP],
                   "xrseg_nms_select_limits": [_IP, _IP, _IP]},
    "nms_rotated": {"xrseg_nms_rotated": [_VP, _VP, _CI, _CI, _CF, _CF, _CI,
                                          _VP, _VP, _CI, _CI, _CI, _VP],
                    "xrseg_nms_rotated_limits": [_IP, _IP, _IP]},
}


def _lib(name: str) -> ctypes.CDLL:
    return _build.library(name, _SIGNATURES[name])


@functools.lru_cache(maxsize=None)
def _device_limits(name: str, index: int
                   ) -> Tuple[int, int, Tuple[Tuple[int, int], ...]]:
    """(SM count, opt-in shared-memory bytes a block, ((c, clusters of c
    blocks that run at once with an SM to each block), ...)) of card `index`,
    asked of the card through csrc/<name>.cu."""
    lib = _lib(name)
    sm_count, smem_optin = _CI(), _CI()
    room = (_CI * len(CLUSTER_SIZES))()
    with torch.cuda.device(index):
        _build.check_launch(lib, getattr(lib, f"xrseg_{name}_limits")(
            ctypes.byref(sm_count), ctypes.byref(smem_optin), room),
            f"{name} limits")
    return sm_count.value, smem_optin.value, tuple(zip(CLUSTER_SIZES, room))


def device_limits(name: str, device: torch.device
                  ) -> Tuple[int, int, Dict[int, int]]:
    """launch_plan's (sm_count, smem_optin, room) for `device`."""
    sm_count, smem_optin, room = _device_limits(
        name, _build.device_index(device))
    return sm_count, smem_optin, dict(room)


@functools.lru_cache(maxsize=256)
def _plan_on(what: str, B: int, K: int, index: int, cluster: Optional[int]):
    """launch_plan on card `index`, remembered per shape."""
    sm_count, smem_optin, room = _device_limits(what, index)
    return launch_plan(what, B, K, sm_count, smem_optin, dict(room), cluster)


def max_candidates(name: str, device: torch.device) -> int:
    """The largest K the kernel of csrc/<name>.cu takes on `device`."""
    return max_k(name, device_limits(name, device)[1])


def _check_inputs(geo: torch.Tensor, masked: torch.Tensor, geo_shape,
                  max_det: int, what: str) -> Tuple[int, int]:
    """geo [B,...] and masked [B,K]: float32, contiguous, on one card, geo
    of shape geo_shape(B, K). Returns (B, K)."""
    if geo.dtype != torch.float32 or masked.dtype != torch.float32:
        raise TypeError(f"{what} needs float32 inputs, got "
                        f"{geo.dtype} and {masked.dtype}")
    if masked.device != geo.device:
        raise ValueError(f"inputs on {geo.device} and {masked.device}")
    if not (geo.is_contiguous() and masked.is_contiguous()):
        raise ValueError(f"{what} needs contiguous inputs")
    if masked.dim() != 2:
        raise ValueError(f"{what} needs masked scores [B,K], got "
                         f"{tuple(masked.shape)}")
    B, K = masked.shape
    if tuple(geo.shape) != geo_shape(B, K):
        raise ValueError(f"geometry {tuple(geo.shape)} does not match "
                         f"scores {tuple(masked.shape)}: expected "
                         f"{geo_shape(B, K)}")
    if K < 1 or max_det < 1:
        raise ValueError(f"{what} needs K >= 1 and max_det >= 1, got "
                         f"K={K}, max_det={max_det}")
    return B, K


def _launch(what: str, geo: torch.Tensor, masked: torch.Tensor,
            geo_shape, max_det: int, cluster: Optional[int], *scalars
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs, plan the launch, allocate (idx, ok) [B,max_det] and
    launch xrseg_<what>(geo, masked, B, K, *scalars, max_det, idx, ok,
    *plan, stream) on the current stream."""
    B, K = _check_inputs(geo, masked, geo_shape, max_det, what)
    plan = _plan_on(what, B, K, _build.device_index(geo.device), cluster)
    idx = torch.empty((B, max_det), dtype=torch.int32, device=geo.device)
    ok = torch.empty((B, max_det), dtype=torch.bool, device=geo.device)
    lib = _lib(what)
    with torch.cuda.device(geo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"xrseg_{what}")(
            geo.data_ptr(), masked.data_ptr(), B, K, *scalars, max_det,
            idx.data_ptr(), ok.data_ptr(), *plan, stream)
    _build.check_launch(lib, err, f"{what} (cluster {plan[0]}, {plan[1]} "
                                  f"threads, {plan[2]} bytes)")
    return idx, ok


def _select(corners, masked, iou_threshold, max_det, cluster):
    if corners.data_ptr() % 16:         # the kernel reads a box as one float4
        raise ValueError("nms_select needs corners aligned to 16 bytes")
    return _launch("nms_select", corners, masked, lambda B, K: (B, K, 4),
                   max_det, cluster, as_f32(iou_threshold))


def check_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for others."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the NMS and WBF kernels run on cuda or cpu "
                     f"tensors, not {t.device}")


# The kernels as torch.library custom ops, so that an exported program
# (compile.export_compiled) holds them: the CUDA implementation launches the
# kernel and counts the launch, the CPU one is the plain version. K2 is
# K1's __global__ at B = 1, registered apart for its own count.

@torch.library.custom_op("xrseg::nms_select_batched", mutates_args=())
def _nms_select_batched_op(corners: torch.Tensor, masked: torch.Tensor,
                           iou_threshold: float, max_det: int,
                           cluster: Optional[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return nms_select_batched_torch(corners, masked, iou_threshold, max_det)


@_nms_select_batched_op.register_kernel("cuda")
def _(corners, masked, iou_threshold, max_det, cluster):
    out = _select(corners, masked, iou_threshold, max_det, cluster)
    launches.count("nms_select_batched_cuda", corners.shape[0])
    return out


@torch.library.custom_op("xrseg::nms_select", mutates_args=())
def _nms_select_op(corners: torch.Tensor, masked: torch.Tensor,
                   iou_threshold: float, max_det: int, cluster: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return nms_select_batched_torch(corners, masked, iou_threshold, max_det)


@_nms_select_op.register_kernel("cuda")
def _(corners, masked, iou_threshold, max_det, cluster):
    out = _select(corners, masked, iou_threshold, max_det, cluster)
    launches.count("nms_select_cuda")
    return out


@torch.library.custom_op("xrseg::nms_rotated_batched", mutates_args=())
def _nms_rotated_batched_op(rows: torch.Tensor, masked: torch.Tensor,
                            iou_threshold: float, max_det: int,
                            cluster: Optional[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return nms_rotated_batched_torch(rows, masked, iou_threshold, max_det)


@_nms_rotated_batched_op.register_kernel("cuda")
def _(rows, masked, iou_threshold, max_det, cluster):
    out = _launch("nms_rotated", rows, masked, lambda B, K: (B, 6, K),
                  max_det, cluster, as_f32(iou_threshold),
                  as_f32(PROBIOU_EPS))
    launches.count("nms_rotated_batched_cuda")
    return out


def _fake_select(geo, masked, iou_threshold, max_det, cluster):
    B = masked.shape[0]
    return (masked.new_empty((B, max_det), dtype=torch.int32),
            masked.new_empty((B, max_det), dtype=torch.bool))


for _op in (_nms_select_batched_op, _nms_select_op, _nms_rotated_batched_op):
    _op.register_fake(_fake_select)


def nms_select_batched_cuda(corners: torch.Tensor, masked: torch.Tensor,
                            iou_threshold: float, max_det: int = 50, *,
                            cluster: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: corners [B,K,4] f32, masked [B,K] f32 -> (idx, ok) [B,max_det].
    `cluster` forces the blocks per image instead of launch_plan's choice."""
    check_device(corners)
    return torch.ops.xrseg.nms_select_batched(
        corners, masked, float(iou_threshold), int(max_det), cluster)


def nms_select_cuda(corners: torch.Tensor, masked: torch.Tensor,
                    iou_threshold: float, max_det: int = 50, *,
                    cluster: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: corners [K,4] f32, masked [K] f32 -> (idx, ok) [max_det]."""
    if check_device(corners) and (corners.dim() != 2 or masked.dim() != 1):
        raise ValueError(f"nms_select_cuda takes [K,4] and [K], got "
                         f"{tuple(corners.shape)} and {tuple(masked.shape)}")
    idx, ok = torch.ops.xrseg.nms_select(
        corners[None], masked[None], float(iou_threshold), int(max_det),
        cluster)
    return idx[0], ok[0]


def nms_rotated_batched_cuda(rows: torch.Tensor, masked: torch.Tensor,
                             iou_threshold: float, max_det: int = 50, *,
                             cluster: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: rows [B,6,K] f32 (rotated_gaussian_rows), masked [B,K] f32 ->
    (idx, ok) [B,max_det]."""
    check_device(rows)
    return torch.ops.xrseg.nms_rotated_batched(
        rows, masked, float(iou_threshold), int(max_det), cluster)

