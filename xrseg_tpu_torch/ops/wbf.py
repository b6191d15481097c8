"""Weighted box fusion (counterpart of xrseg_tpu/ops/wbf.py) and its
kernels K5 and K6.

NMS keeps the best of overlapping candidates; WBF fuses them (the
score-weighted mean of their boxes, the mean of their scores), the better
merge when the candidates come from several sources that each saw the
object: test-time augmentation and model ensembles. PostprocessConfig
(merge="wbf") swaps it in for NMS.

The candidates are sorted by score once; then a greedy scan assigns each,
in turn, to the open cluster of its label with the largest overlap at or
above iou_threshold, or opens a new one while fewer than max_det are
open. The output has the nms_fixed contract: boxes (fused), scores (the
mean member score), labels, indices (each cluster's top-scoring member's
anchor), valid and count, score-sorted.

The scan is one sequential step per candidate (8400 at a 640x640 input).
JAX runs it as a lax.scan; here it is hand-written kernels (csrc/wbf.cu),
four launches a call and no host read:

  wbf_scan_cuda          K5: boxes [B,K,4] (IoU)
  wbf_rotated_scan_cuda  K6: boxes [B,K,5] (probIoU; the angle fuses as
                         the weighted circular mean of the doubled angles)

The kernels split the scan, exactly, into independent chains, one per
label class (label mod G): under class_aware a candidate only merges into
a cluster of its own label, and the cap of max_det open clusters is met
by two passes (see csrc/wbf.cu). `launch_plan` chooses G and the team that
runs a chain (a warp up to max_det 64 for K5 and 32 for K6, a block
beyond); it is a pure function, and the launcher only validates it.

Both take the score-sorted stream and return the clusters' sums; the sort
before the scan and the final fuse and score sort of the clusters are
torch, as in JAX. Both are registered as torch.library custom ops
(xrseg::wbf_scan, xrseg::wbf_rotated_scan), so an exported program
(compile.export_compiled) holds them: their CUDA implementation is the
kernel, their CPU implementation the plain version (wbf_scan_plain,
wbf_rotated_scan_plain: the JAX step in torch, over the live prefix of the
stream, with one host read of its length). A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.
Each counts its launches under its own name in ops/launches.
"""
import ctypes
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.ops.nms import xywh_to_corners
from xrseg_tpu_torch.ops.nms_kernels import (PROBIOU_EPS, as_f32,
                                              check_device, probiou_gauss)

MAX_CLUSTERS = 1024              # one cluster a thread of a chain's block

State = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# The candidate stream
# ---------------------------------------------------------------------------

def _topk_candidates(boxes, scores, labels, pre_topk: int):
    """Score-descending stream [B,K,...] for the scan: (boxes f32, scores
    f32, labels int32, order int32, each candidate's anchor). Ties keep the
    lower anchor first (a stable sort, as jnp.argsort and lax.top_k order
    them). pre_topk > 0 keeps the top pre_topk only; candidates below the
    score gate are no-ops of the scan, so that is exact unless more than
    pre_topk anchors clear the gate."""
    A = scores.shape[-1]
    s_sorted, order = torch.sort(scores.float(), dim=-1, descending=True,
                                 stable=True)
    if pre_topk and pre_topk < A:
        s_sorted, order = s_sorted[:, :pre_topk], order[:, :pre_topk]
    b = boxes.gather(1, order[..., None].expand(*order.shape,
                                                boxes.shape[-1]))
    return (b.float().contiguous(), s_sorted.contiguous(),
            labels.gather(1, order).int().contiguous(),
            order.int().contiguous())


# ---------------------------------------------------------------------------
# Plain versions: the JAX scan step by step in torch
# ---------------------------------------------------------------------------

def _corners_area(xywh: torch.Tensor):
    """cxcywh [...,4] -> (corners [...,4], area [...])."""
    c = xywh_to_corners(xywh)
    wh = (c[..., 2:] - c[..., :2]).clamp_min(0)
    return c, wh[..., 0] * wh[..., 1]


def _iou_rows(cc, ca, fc, fa) -> torch.Tensor:
    """IoU of each image's candidate (corners cc [B,4], area ca [B])
    against its clusters' fused boxes (fc [B,D,4], fa [B,D]) -> [B,D];
    JAX's _iou_row."""
    lt = torch.maximum(cc[:, None, :2], fc[..., :2])
    rb = torch.minimum(cc[:, None, 2:], fc[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (ca[:, None] + fa - inter).clamp_min(1e-12)


def _gauss(xywhr: torch.Tensor, twelve: torch.Tensor):
    """Rotated boxes [...,5] -> their Gaussian terms (x, y, a, b, c, det),
    each side floored at 1e-3 px. `twelve` is a tensor on the boxes' device:
    torch divides by a Python scalar on the card as a product with its
    reciprocal, which rounds otherwise than the division of the JAX package
    and of the kernel (csrc/probiou.cuh gauss_of)."""
    w = xywhr[..., 2].clamp_min(1e-3)
    h = xywhr[..., 3].clamp_min(1e-3)
    a0 = w * w / twelve
    b0 = h * h / twelve
    cs, sn = torch.cos(xywhr[..., 4]), torch.sin(xywhr[..., 4])
    a = a0 * cs * cs + b0 * sn * sn
    b = a0 * sn * sn + b0 * cs * cs
    c = (a0 - b0) * cs * sn
    return (xywhr[..., 0], xywhr[..., 1], a, b, c,
            (a * b - c * c).clamp_min(0))


def _fuse_rotated(acc: torch.Tensor) -> torch.Tensor:
    """Cluster sums [...,>=7] (wsum x4, cs, sn, ssum, ...) -> the fused
    rotated box [...,5]: JAX's fuse."""
    ssum = acc[..., 6]
    xywh = acc[..., :4] / ssum.clamp_min(1e-12)[..., None]
    ang = 0.5 * torch.atan2(acc[..., 5], torch.where(ssum > 0, acc[..., 4],
                                                      1.0))
    return torch.cat([xywh, ang[..., None]], -1)


def _scan(contrib, overlap, scores, labels, order, iou_threshold,
          score_threshold, max_det, class_aware):
    """The scan over the live prefix. contrib [B,K,C]: what candidate t adds
    to a cluster's sums (its last column 1, the member count); overlap(acc,
    t) -> [B,D]: candidate t against every slot's fused box. Returns acc
    [B,D,C], meta [B,D,2] (top_i, lab) and n_open [B]."""
    B, K, C = contrib.shape
    D = max_det
    dev = scores.device
    thr = as_f32(iou_threshold)
    alive = scores > as_f32(score_threshold)
    live = int(alive.sum(-1).max()) if B else 0    # the one host read
    acc = contrib.new_zeros((B, D, C))
    meta = torch.tensor([0, -1], dtype=torch.int32,
                        device=dev).expand(B, D, 2).clone()
    cand_meta = torch.stack([order, labels], -1)
    slots = torch.arange(D, device=dev)
    n_open = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(live):
        iou = overlap(acc, t)
        cand = (slots < n_open[:, None]) & (iou >= thr)
        if class_aware:
            cand = cand & (meta[..., 1] == labels[:, t, None])
        anyc = cand.any(-1)
        best = torch.where(cand, iou, -1.0).argmax(-1)   # first maximum
        # a live candidate merges into `best` or opens slot n_open; with all
        # max_det slots open, slot n_open == D matches none: it is dropped
        slot = torch.where(anyc, best, n_open)
        hit = alive[:, t, None] & (slots == slot[:, None])
        ct = contrib[:, t, None]
        acc = torch.where(hit[..., None],
                          torch.where(anyc[:, None, None], acc + ct, ct), acc)
        opened = hit & ~anyc[:, None]
        meta = torch.where(opened[..., None], cand_meta[:, t, None], meta)
        n_open = n_open + opened.sum(-1)
    return acc, meta, n_open


def _state(acc, meta, n_open, n_sums: int) -> State:
    """_scan's result in the kernel's output layout: the sums' columns,
    then n, top_i, lab int32, active bool, n_open int32."""
    D = acc.shape[1]
    sums = [acc[..., :4].contiguous()] + [acc[..., i].contiguous()
                                          for i in range(4, 4 + n_sums)]
    active = torch.arange(D, device=acc.device) < n_open[:, None]
    return (*sums, acc[..., -1].int(), meta[..., 0].contiguous(),
            meta[..., 1].contiguous(), active, n_open.int())


def wbf_scan_plain(boxes, scores, labels, order, iou_threshold: float,
                   score_threshold: float, max_det: int,
                   class_aware: bool = True) -> State:
    """K5's plain version: the score-sorted stream (boxes [B,K,4] f32,
    scores [B,K] f32, labels, order [B,K] int32) -> (wsum [B,D,4], ssum,
    n, top_i, lab, active [B,D], n_open [B])."""
    s = scores[..., None]
    contrib = torch.cat([s * boxes, s, torch.ones_like(s)], -1)
    cc, ca = _corners_area(boxes)

    def overlap(acc, t):
        fused = acc[..., :4] / acc[..., 4].clamp_min(1e-12)[..., None]
        fc, fa = _corners_area(fused)
        return _iou_rows(cc[:, t], ca[:, t], fc, fa)

    acc, meta, n_open = _scan(contrib, overlap, scores, labels, order,
                              iou_threshold, score_threshold, max_det,
                              class_aware)
    return _state(acc, meta, n_open, 1)


def wbf_rotated_scan_plain(boxes, scores, labels, order,
                           iou_threshold: float, score_threshold: float,
                           max_det: int, class_aware: bool = True,
                           eps: float = PROBIOU_EPS) -> State:
    """K6's plain version: boxes [B,K,5] -> (wsum [B,D,4], cs, sn, ssum, n,
    top_i, lab, active [B,D], n_open [B])."""
    s = scores[..., None]
    twice = 2 * boxes[..., 4:5]
    contrib = torch.cat([s * boxes[..., :4], s * torch.cos(twice),
                         s * torch.sin(twice), s, torch.ones_like(s)], -1)
    twelve = boxes.new_tensor(12.0)
    cg = _gauss(boxes, twelve)
    e = as_f32(eps)

    def overlap(acc, t):
        fg = _gauss(_fuse_rotated(acc), twelve)
        return probiou_gauss(*(v[:, t, None] for v in cg), *fg,
                             e).clamp_min(0)

    acc, meta, n_open = _scan(contrib, overlap, scores, labels, order,
                              iou_threshold, score_threshold, max_det,
                              class_aware)
    return _state(acc, meta, n_open, 3)


# ---------------------------------------------------------------------------
# The kernels, as custom ops
# ---------------------------------------------------------------------------

MAX_CHAINS = 128                 # at least the paths' 80 and 15 classes
CHAIN_SLOTS = 32768              # chains x max_det: bounds the scratch
# a warp holds a chain's clusters up to here: two a lane for K5, one for
# K6, whose two probIoUs in a lane would run one after the other
WARP_CHAIN_D = {"xrseg_wbf": 64, "xrseg_wbf_rotated": 32}
WARP_CHAINS = 4                  # warp chains a block
STAGES = 4                       # record chunks in flight a chain
CHUNK = 32                       # records a chunk
REC_BYTES = {"xrseg_wbf": 48, "xrseg_wbf_rotated": 64}


class ChainPlan(NamedTuple):
    """How the kernels run an image's chains: `chains` (G), the warps of
    the team that runs one chain (`team_warps`; 1: a warp, WARP_CHAINS of
    them a block), clusters a thread (`per_thread`) and the dynamic
    shared-memory bytes a block (`smem`)."""
    chains: int
    team_warps: int
    per_thread: int
    smem: int


def launch_plan(what: str, max_det: int, class_aware: bool) -> ChainPlan:
    """The chains and teams of a K5 ("xrseg_wbf") or K6
    ("xrseg_wbf_rotated") call at `max_det` clusters an image.

    Chains: one without class_aware (every cluster is a candidate);
    otherwise G = MAX_CHAINS, fewer where G x max_det would pass
    CHAIN_SLOTS (each chain keeps up to max_det clusters in scratch).
    Labels share a chain when there are more than G of them; that stays
    exact. Teams: up to WARP_CHAIN_D[what] clusters a chain is one warp,
    its clusters in the lanes' registers (1 or 2 a lane), WARP_CHAINS
    chains a block, and a step needs no barrier; beyond that a chain is a
    block of ceil(max_det / 32) warps, a cluster a thread. Shared memory:
    STAGES chunks of CHUNK records for every chain of the block."""
    if not 1 <= max_det <= MAX_CLUSTERS:
        raise ValueError(f"{what} holds 1 to {MAX_CLUSTERS} clusters an "
                         f"image, not max_det={max_det}")
    ring = STAGES * CHUNK * REC_BYTES[what]
    G = min(MAX_CHAINS, CHAIN_SLOTS // max_det) if class_aware else 1
    if max_det <= WARP_CHAIN_D[what]:
        return ChainPlan(G, 1, -(-max_det // 32), WARP_CHAINS * ring)
    return ChainPlan(G, -(-max_det // 32), 1, ring)


_VP, _CI, _CF, _CL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
_LP = ctypes.POINTER(_CL)
_PLAN = [_CI] * 4 + [_VP, _CL]   # G, per_thread, team_warps, smem, scratch
_SIGNATURES = {
    "xrseg_wbf": [_VP] * 4 + [_CI, _CI, _CF, _CF, _CI, _CI] + _PLAN
    + [_VP] * 8,
    "xrseg_wbf_rotated": [_VP] * 4 + [_CI, _CI, _CF, _CF, _CF, _CI, _CI]
    + _PLAN + [_VP] * 10,
    "xrseg_wbf_scratch_bytes": [_CI] * 5 + [_LP],
    "xrseg_wbf_scratch_offsets": [_CI] * 5 + [_LP],
}


def _check(boxes, scores, labels, order, dim: int, max_det: int,
           what: str) -> Tuple[int, int]:
    """The kernel's input contract; returns (B, K)."""
    if scores.dim() != 2 or tuple(boxes.shape) != (*scores.shape, dim):
        raise ValueError(f"{what} needs boxes [B,K,{dim}] and scores [B,K], "
                         f"got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or \
            labels.dtype != torch.int32 or order.dtype != torch.int32:
        raise TypeError(f"{what} needs float32 boxes and scores and int32 "
                        f"labels and order, got {boxes.dtype}, "
                        f"{scores.dtype}, {labels.dtype}, {order.dtype}")
    if tuple(labels.shape) != tuple(scores.shape) or \
            tuple(order.shape) != tuple(scores.shape):
        raise ValueError(f"{what}: labels and order must be [B,K]")
    ts = (boxes, scores, labels, order)
    if any(t.device != boxes.device for t in ts):
        raise ValueError(f"{what}: inputs on more than one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous inputs")
    if not 1 <= max_det <= MAX_CLUSTERS:
        raise ValueError(f"{what} holds 1 to {MAX_CLUSTERS} clusters an "
                         f"image (a chain holds them in one block), not "
                         f"max_det={max_det}")
    return scores.shape


def _outputs(boxes, B: int, D: int, n_sums: int) -> State:
    dev = boxes.device
    f = [torch.empty((B, D, 4), dtype=torch.float32, device=dev)] + [
        torch.empty((B, D), dtype=torch.float32, device=dev)
        for _ in range(n_sums)]
    i = [torch.empty((B, D), dtype=torch.int32, device=dev)
         for _ in range(3)]
    return (*f, *i, torch.empty((B, D), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _scratch_query(lib, fn: str, what: str, B: int, K: int, D: int,
                   G: int, n: int):
    vals = (_CL * n)()
    err = getattr(lib, what)(int(fn == "xrseg_wbf_rotated"), B, K, D, G, vals)
    _build.check_launch(lib, err, f"{what} (B={B}, K={K}, D={D}, G={G})")
    return list(vals)


def _launch(fn: str, boxes, scores, labels, order, iou_threshold: float,
            score_threshold: float, max_det: int, class_aware: bool,
            report=None) -> State:
    """K5 (fn "xrseg_wbf") or K6 ("xrseg_wbf_rotated"): four launches on
    the current stream (records, pass A, the cap, the finish). `report`, a
    dict, receives the plan, the scratch and the byte offsets of its T_cap
    [B], pass-A counts [B,G] and open positions [B,G,D] (int32)."""
    rotated = fn == "xrseg_wbf_rotated"
    n_sums, dim = (3, 5) if rotated else (1, 4)
    scalars = (as_f32(iou_threshold), as_f32(score_threshold),
               *((as_f32(PROBIOU_EPS),) if rotated else ()), int(class_aware))
    B, K = _check(boxes, scores, labels, order, dim, max_det, fn)
    if B == 0 or K == 0:
        raise ValueError(f"{fn} needs B >= 1 and K >= 1, got B={B}, K={K}")
    plan = launch_plan(fn, max_det, class_aware)
    out = _outputs(boxes, B, max_det, n_sums)
    lib = _build.library("wbf", _SIGNATURES)
    nbytes, = _scratch_query(lib, fn, "xrseg_wbf_scratch_bytes", B, K,
                             max_det, plan.chains, 1)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            order.data_ptr(), B, K, *scalars, max_det, plan.chains,
            plan.per_thread, plan.team_warps, plan.smem, scratch.data_ptr(),
            nbytes, *(t.data_ptr() for t in out), stream)
    _build.check_launch(lib, err, f"{fn} (B={B}, K={K}, D={max_det}, "
                                  f"plan {plan})")
    if report is not None:
        report.update(plan=plan, scratch=scratch, offsets=_scratch_query(
            lib, fn, "xrseg_wbf_scratch_offsets", B, K, max_det,
            plan.chains, 3))
    return out


def _fake(boxes, n_sums: int, max_det: int) -> State:
    return _outputs(boxes, boxes.shape[0], max_det, n_sums)


_SCAN_OUT = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor]
_ROT_OUT = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


@torch.library.custom_op("xrseg::wbf_scan", mutates_args=())
def _wbf_scan_op(boxes: torch.Tensor, scores: torch.Tensor,
                 labels: torch.Tensor, order: torch.Tensor,
                 iou_threshold: float, score_threshold: float, max_det: int,
                 class_aware: bool) -> _SCAN_OUT:
    return wbf_scan_plain(boxes, scores, labels, order, iou_threshold,
                          score_threshold, max_det, class_aware)


@_wbf_scan_op.register_kernel("cuda")
def _wbf_scan_kernel(boxes, scores, labels, order, iou_threshold,
                     score_threshold, max_det, class_aware):
    out = _launch("xrseg_wbf", boxes, scores, labels, order, iou_threshold,
                  score_threshold, max_det, class_aware)
    launches.count("wbf_scan_cuda")
    return out


@_wbf_scan_op.register_fake
def _(boxes, scores, labels, order, iou_threshold, score_threshold,
      max_det, class_aware):
    return _fake(boxes, 1, max_det)


@torch.library.custom_op("xrseg::wbf_rotated_scan", mutates_args=())
def _wbf_rotated_scan_op(boxes: torch.Tensor, scores: torch.Tensor,
                         labels: torch.Tensor, order: torch.Tensor,
                         iou_threshold: float, score_threshold: float,
                         max_det: int, class_aware: bool) -> _ROT_OUT:
    return wbf_rotated_scan_plain(boxes, scores, labels, order,
                                  iou_threshold, score_threshold, max_det,
                                  class_aware)


@_wbf_rotated_scan_op.register_kernel("cuda")
def _wbf_rotated_scan_kernel(boxes, scores, labels, order, iou_threshold,
                             score_threshold, max_det, class_aware):
    out = _launch("xrseg_wbf_rotated", boxes, scores, labels, order,
                  iou_threshold, score_threshold, max_det, class_aware)
    launches.count("wbf_rotated_scan_cuda")
    return out


@_wbf_rotated_scan_op.register_fake
def _(boxes, scores, labels, order, iou_threshold, score_threshold,
      max_det, class_aware):
    return _fake(boxes, 3, max_det)


def wbf_scan_cuda(boxes, scores, labels, order, iou_threshold: float,
                  score_threshold: float, max_det: int,
                  class_aware: bool = True) -> State:
    """K5 on the score-sorted stream (see wbf_scan_plain); CPU tensors run
    the plain version."""
    check_device(boxes)
    return torch.ops.xrseg.wbf_scan(boxes, scores, labels, order,
                                    float(iou_threshold),
                                    float(score_threshold), int(max_det),
                                    bool(class_aware))


def wbf_rotated_scan_cuda(boxes, scores, labels, order, iou_threshold: float,
                          score_threshold: float, max_det: int,
                          class_aware: bool = True) -> State:
    """K6 on the score-sorted stream of rotated boxes (see
    wbf_rotated_scan_plain); CPU tensors run the plain version."""
    check_device(boxes)
    return torch.ops.xrseg.wbf_rotated_scan(boxes, scores, labels, order,
                                            float(iou_threshold),
                                            float(score_threshold),
                                            int(max_det), bool(class_aware))


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

def _plain(backend: str) -> bool:
    """backend "scan" calls the plain scan itself; "auto" and "cuda" call
    the wrapper, which runs K5/K6 on CUDA tensors and the plain scan on CPU
    ones (so an exported program holds the custom op on either device)."""
    if backend not in ("auto", "scan", "cuda"):
        raise ValueError(f"wbf backend {backend!r}; expected 'auto', 'scan' "
                         "or 'cuda'")
    return backend == "scan"


def _slate(fused, ssum, n, top_i, lab, active, n_open, box_key: str
           ) -> Dict[str, torch.Tensor]:
    """The clusters -> the score-sorted nms_fixed slate."""
    mean = torch.where(active, ssum / n.clamp_min(1), 0.0)
    res = torch.sort(mean, dim=-1, descending=True, stable=True).indices
    a = active.gather(1, res)
    return {box_key: fused.gather(1, res[..., None].expand_as(fused))
            * a[..., None],
            "scores": mean.gather(1, res),
            "labels": torch.where(a, lab.gather(1, res), 0).int(),
            "indices": torch.where(a, top_i.gather(1, res), 0).int(),
            "valid": a,
            "count": n_open.int()}


def wbf_fixed_batched(boxes, scores, labels, *, iou_threshold: float,
                      score_threshold: float, max_det: int,
                      class_aware: bool = True, pre_topk: int = 0,
                      backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Batched WBF of boxes_xywh [B,A,4], scores [B,A] (positive
    probabilities: they weight the boxes), labels [B,A] -> the padded
    slate [B,max_det,...] (boxes_xywh fused, scores the clusters' mean).
    backend "auto" or "cuda" runs K5 for CUDA tensors and the plain scan
    for CPU ones (through the wrapper), "scan" the plain scan on either;
    the results are identical."""
    b, s, l, o = _topk_candidates(boxes, scores, labels, pre_topk)
    scan = wbf_scan_plain if _plain(backend) else wbf_scan_cuda
    wsum, ssum, n, top_i, lab, active, n_open = scan(
        b, s, l, o, iou_threshold, score_threshold, max_det, class_aware)
    fused = wsum / ssum.clamp_min(1e-12)[..., None]
    return _slate(fused, ssum, n, top_i, lab, active, n_open, "boxes_xywh")


def wbf_rotated_fixed_batched(boxes, scores, labels, *, iou_threshold: float,
                              score_threshold: float, max_det: int,
                              class_aware: bool = True, pre_topk: int = 0,
                              backend: str = "auto"
                              ) -> Dict[str, torch.Tensor]:
    """OBB WBF of boxes_xywhr [B,A,5]: probIoU matching; cx, cy, w, h fuse
    score-weighted, the angle as the weighted circular mean over doubled
    angles (a rotated rectangle has pi symmetry): theta = atan2(sum w sin
    2t, sum w cos 2t) / 2. The slate's box key is "boxes_xywhr". K6 under
    backend "auto" for CUDA tensors."""
    b, s, l, o = _topk_candidates(boxes, scores, labels, pre_topk)
    scan = wbf_rotated_scan_plain if _plain(backend) \
        else wbf_rotated_scan_cuda
    wsum, cs, sn, ssum, n, top_i, lab, active, n_open = scan(
        b, s, l, o, iou_threshold, score_threshold, max_det, class_aware)
    fused = _fuse_rotated(torch.cat([wsum, cs[..., None], sn[..., None],
                                     ssum[..., None]], -1))
    return _slate(fused, ssum, n, top_i, lab, active, n_open, "boxes_xywhr")


def wbf_fixed(boxes_xywh, scores, labels, *, iou_threshold: float = 0.55,
              score_threshold: float = 0.0, max_det: int = 50,
              class_aware: bool = True, pre_topk: int = 0,
              backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Single image: boxes_xywh [A,4], scores [A], labels [A] -> the slate
    [max_det,...] (count 0-dim)."""
    out = wbf_fixed_batched(
        boxes_xywh[None], scores[None], labels[None],
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, class_aware=class_aware, pre_topk=pre_topk,
        backend=backend)
    return {k: v[0] for k, v in out.items()}


def wbf_rotated_fixed(boxes_xywhr, scores, labels, *,
                      iou_threshold: float = 0.55,
                      score_threshold: float = 0.0, max_det: int = 50,
                      class_aware: bool = True, pre_topk: int = 0,
                      backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Single image: boxes_xywhr [A,5] -> the slate (key "boxes_xywhr")."""
    out = wbf_rotated_fixed_batched(
        boxes_xywhr[None], scores[None], labels[None],
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, class_aware=class_aware, pre_topk=pre_topk,
        backend=backend)
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def box_iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two cxcywh boxes (float64 host arithmetic); the JAX package's
    eval/metrics.box_iou_xywh."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def wbf_reference_numpy(boxes, scores, labels, *, iou_threshold=0.55,
                        score_threshold=0.0, class_aware=True):
    """Loop-based numpy oracle with the same greedy-cluster semantics
    (float64). Returns rows (fused box, mean score, label, top member's
    index), sorted by mean score, descending."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    clusters = []                     # [wsum, ssum, n, label, top_i, top_s]
    for i in order:
        if scores[i] <= score_threshold:
            continue
        best, best_iou = -1, iou_threshold
        for ci, c in enumerate(clusters):
            if class_aware and c[3] != labels[i]:
                continue
            iou = box_iou_xywh(c[0] / c[1], np.asarray(boxes[i],
                                                       np.float64))
            if iou >= best_iou:
                best, best_iou = ci, iou
        if best >= 0:
            c = clusters[best]
            c[0] = c[0] + scores[i] * np.asarray(boxes[i], np.float64)
            c[1] += scores[i]
            c[2] += 1
            if scores[i] > c[5]:
                c[4], c[5] = int(i), float(scores[i])
        else:
            clusters.append([scores[i] * np.asarray(boxes[i], np.float64),
                             float(scores[i]), 1, int(labels[i]), int(i),
                             float(scores[i])])
    rows = [(c[0] / c[1], c[1] / c[2], c[3], c[4]) for c in clusters]
    rows.sort(key=lambda r: -r[1])
    return rows
