"""Training losses for YOLO11 fine-tuning (counterpart of
xrseg_tpu/train/losses.py), batched over B in torch where the JAX package
vmaps a per-image function.

  - assign: TAL (assign_targets_tal): alignment = cls_prob^alpha * IoU^beta
    over center-inside-box candidates, top-k per GT, multi-assignment
    resolved by max overlap (the first GT on ties), soft cls targets
    normalized per GT. OBB runs it rotated (anchor inside the rotated
    rectangle, probIoU metric). The FCOS-style center-inside-box assigner
    (assign_targets) is kept for ablation, as in JAX.
  - box:  CIoU on positives (probIoU for obb), weighted by the aligned
    target score
  - cls:  BCE against the soft aligned target scores (all anchors), with
    JAX's formula max(x, 0) - x*t + log1p(exp(-|x|))
  - dfl:  distribution focal loss on the two integer bins, same weighting
  - kpt:  OKS-style keypoint loss + visibility BCE (pose)
  - seg:  per-positive BCE of (coef . protos) against the GT instance mask,
    over a fixed-size slate of topk*G anchors chosen by a stable sort of
    fg, the order lax.top_k gives (lower index first on ties)

The assigner's inputs are detached, as are CIoU's alpha and every target;
argmax/argmin take the first extremum; max/min are torch.maximum/minimum,
whose gradient splits at ties as JAX's does.

Targets are fixed-size padded: boxes_xywh [B,G,4] (model pixels), labels
[B,G] (-1 pad), masks [B,G,mh,mw] (segment), kpts [B,G,K,3] (pose),
boxes_xywhr [B,G,5] (obb), sample_weight [B] (padded batch rows weigh 0).

Both losses reduce the batch by a sum over its rows divided by a
denominator that depends on the batch alone: the sample weights' sum (the
row count without them), or the valid labels for classify. A data shard
of a larger batch passes the WHOLE batch's denominator as `batch_denom`
(batch_denominator); the loss then returns its rows' share, and the
shards' shares add up to the unsharded loss. Without it the shard's
own rows normalise, as in the single-device step.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models.yolo11 import make_anchors
from xrseg_tpu_torch.ops.nms import probiou


@functools.lru_cache(maxsize=32)
def _anchor_grid(h: int, w: int, device: torch.device):
    """(anchors [A,2], strides [A,1]) on `device`, made once per shape."""
    anchors, strides = make_anchors((h, w))
    return (torch.from_numpy(anchors).to(device),
            torch.from_numpy(strides).to(device))


def _grid(hw, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return _anchor_grid(int(hw[0]), int(hw[1]), torch.device(device))


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.maximum(logits, _zero(logits)) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))


def ciou(box_a: torch.Tensor, box_b: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU between xywh boxes [...,4] (broadcast) -> [...]."""
    ax, ay, aw, ah = box_a.unbind(-1)
    bx, by, bw, bh = box_b.unbind(-1)
    ax1, ax2 = ax - aw / 2, ax + aw / 2
    ay1, ay2 = ay - ah / 2, ay + ah / 2
    bx1, bx2 = bx - bw / 2, bx + bw / 2
    by1, by2 = by - bh / 2, by + bh / 2
    zero = _zero(ax)
    iw = torch.maximum(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       zero)
    ih = torch.maximum(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       zero)
    inter = iw * ih
    union = aw * ah + bw * bh - inter + eps
    iou = inter / union
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (ax - bx) ** 2 + (ay - by) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(bw / (bh + eps))
                              - torch.atan(aw / (ah + eps))) ** 2
    alpha = v / (v - iou + 1 + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def _batched(*xs):
    """Per-image inputs ([A,...]/[G,...]) get a leading batch axis."""
    return [None if x is None else x[None] for x in xs]


def assign_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   cfg: ModelConfig,
                   input_hw: Optional[Tuple[int, int]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Center-inside-box assignment: each anchor takes the SMALLEST gt box
    containing its center (ties to the earlier gt). gt_boxes [B,G,4] or
    [G,4], gt_labels [B,G] or [G] (-1 pad). Returns gt_idx, fg per anchor
    ([B,A] or [A])."""
    single = gt_labels.dim() == 1
    if single:
        gt_boxes, gt_labels = _batched(gt_boxes, gt_labels)
    anchors, strides = _grid(input_hw or cfg.input_size, gt_boxes.device)
    centers = anchors * strides                                 # [A,2]
    cx, cy = centers[None, :, 0:1], centers[None, :, 1:2]       # [1,A,1]
    gx, gy, gw, gh = gt_boxes.unbind(-1)                        # [B,G]
    valid_gt = gt_labels >= 0
    x1, x2 = (gx - gw / 2)[:, None], (gx + gw / 2)[:, None]
    y1, y2 = (gy - gh / 2)[:, None], (gy + gh / 2)[:, None]
    inside = ((cx >= x1) & (cx <= x2) & (cy >= y1) & (cy <= y2)
              & valid_gt[:, None])                              # [B,A,G]
    inf = torch.full((), math.inf, device=gt_boxes.device)
    area = torch.where(valid_gt, gw * gh, inf)
    cand = torch.where(inside, area[:, None], inf)
    out = {"gt_idx": cand.argmin(2), "fg": torch.isfinite(cand.amin(2))}
    return {k: v[0] for k, v in out.items()} if single else out


def assign_targets_tal(pred_boxes: torch.Tensor, cls_logits: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                       cfg: ModelConfig, topk: int = 10,
                       alpha: float = 0.5, beta: float = 6.0,
                       eps: float = 1e-9,
                       input_hw: Optional[Tuple[int, int]] = None,
                       gt_rboxes: Optional[torch.Tensor] = None,
                       pred_rboxes: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Task-aligned assignment (ultralytics' TaskAlignedAssigner):

      1. candidates: anchors whose center lies inside the GT box,
      2. alignment metric t = p_cls(gt label)^alpha * IoU(pred, gt)^beta,
      3. per GT keep the top-k candidates by t (and t > 0),
      4. anchors claimed by several GTs go to the max-IoU GT,
      5. soft cls target per positive = t normalized so each GT's best
         anchor gets that GT's best IoU.

    pred_boxes [B,A,4] decoded xywh; cls_logits [B,A,nc]; gt_boxes
    [B,G,4]; gt_labels [B,G] (-1 pad); or the same without B for one
    image. Returns gt_idx [B,A], fg [B,A] bool, target_scores [B,A,nc].
    Nothing is differentiated through the assignment.

    gt_rboxes [B,G,5] + pred_rboxes [B,A,5] (OBB): the ROTATED assigner
    (candidacy by projection onto the box axes, probIoU metric); gt_boxes
    is then only the [G,4] shape carrier."""
    single = cls_logits.dim() == 2
    if single:
        pred_boxes, cls_logits, gt_boxes, gt_labels, gt_rboxes, \
            pred_rboxes = _batched(pred_boxes, cls_logits, gt_boxes,
                                   gt_labels, gt_rboxes, pred_rboxes)
    cls_logits = cls_logits.detach()
    anchors, strides = _grid(input_hw or cfg.input_size, cls_logits.device)
    centers = anchors * strides                                 # [A,2]
    valid_gt = gt_labels >= 0                                   # [B,G]
    if gt_rboxes is not None:
        gt_rboxes = gt_rboxes.detach()
        pred_rboxes = pred_rboxes.detach()
        d = centers[None, :, None, :] - gt_rboxes[:, None, :, :2]  # [B,A,G,2]
        ca = torch.cos(gt_rboxes[..., 4])[:, None]
        sa = torch.sin(gt_rboxes[..., 4])[:, None]
        du = d[..., 0] * ca + d[..., 1] * sa                    # [B,A,G]
        dv = -d[..., 0] * sa + d[..., 1] * ca
        inside = ((du.abs() < gt_rboxes[:, None, :, 2] / 2)
                  & (dv.abs() < gt_rboxes[:, None, :, 3] / 2)
                  & valid_gt[:, None])
    else:
        pred_boxes = pred_boxes.detach()
        gx, gy, gw, gh = gt_boxes.unbind(-1)
        x1, x2 = (gx - gw / 2)[:, None], (gx + gw / 2)[:, None]
        y1, y2 = (gy - gh / 2)[:, None], (gy + gh / 2)[:, None]
        cx, cy = centers[None, :, 0:1], centers[None, :, 1:2]
        inside = ((cx > x1) & (cx < x2) & (cy > y1) & (cy < y2)
                  & valid_gt[:, None])                          # [B,A,G]

    B, A, nc = cls_logits.shape
    G = gt_labels.shape[1]
    probs = torch.sigmoid(cls_logits.float())
    lab0 = gt_labels.long().clamp_min(0)                        # [B,G]
    s = probs.gather(2, lab0[:, None, :].expand(B, A, G))       # [B,A,G]
    zero = torch.zeros((), device=probs.device)
    if gt_rboxes is not None:
        iou = torch.maximum(probiou(pred_rboxes[:, :, None, :],
                                    gt_rboxes[:, None, :, :]), zero)
    else:
        iou = torch.maximum(ciou(pred_boxes[:, :, None, :],
                                 gt_boxes[:, None, :, :]), zero)
    metric = torch.where(inside, (s ** alpha) * (iou ** beta), zero)

    # top-k candidates per GT over the anchors: only the k-th VALUE is
    # used, so how a sort orders ties does not matter here. Gate on
    # metric > 0: at init the aligned metrics are ~1e-10.
    k = min(topk, A)
    kth = metric.topk(k, dim=1).values[:, k - 1:k]              # [B,1,G]
    cand = (metric >= kth) & (metric > 0.0)                     # [B,A,G]

    fg = cand.any(2)                                            # [B,A]
    gt_idx = torch.where(cand, iou, -1.0).argmax(2)             # first max
    assigned = (F.one_hot(gt_idx, G).bool() & cand & fg[..., None])

    m_pos = torch.where(assigned, metric, zero)
    o_pos = torch.where(assigned, iou, zero)
    norm = m_pos * (o_pos.amax(1) / (m_pos.amax(1) + eps))[:, None]
    t_score = norm.amax(2)                                      # [B,A]
    lab = gt_labels.long().gather(1, gt_idx).clamp_min(0)
    target_scores = (F.one_hot(lab, cfg.num_classes).float()
                     * (t_score * fg)[..., None])
    out = {"gt_idx": gt_idx, "fg": fg, "target_scores": target_scores}
    return {k: v[0] for k, v in out.items()} if single else out


# COCO 17-keypoint OKS sigmas (the published per-joint tolerance
# constants); non-17 layouts fall back to uniform 1/K.
_OKS_SIGMAS_17 = [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                  0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
                  0.089]


def _kpt_sigmas(k: int) -> np.ndarray:
    if k == 17:
        return np.asarray(_OKS_SIGMAS_17, np.float32)
    return np.full((k,), 1.0 / k, np.float32)


def batch_denominator(batch: Dict[str, torch.Tensor], task: str
                      ) -> torch.Tensor:
    """The un-clamped denominator of `batch`'s loss (module docstring), a
    0-dim float32 tensor on the batch's device: shards add theirs up, and
    the sum is clamped at 1 as the unsharded loss clamps it."""
    if task == "classify":
        return (batch["labels"] >= 0).sum().float()
    sw = batch.get("sample_weight")
    if sw is not None:
        return sw.float().sum()
    images = batch["images"]
    return torch.tensor(float(len(images)), device=images.device)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        label_smoothing: float = 0.0,
                        batch_denom: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Classify task: softmax cross-entropy + top-1 accuracy. logits
    [B,nc], labels [B] int; labels < 0 mark padding rows (Loader
    drop_last=False), excluded from both. label_smoothing eps mixes the
    one-hot target with uniform 1/nc. batch_denom: the whole batch's valid
    labels, clamped (module docstring)."""
    logp = torch.log_softmax(logits, -1)
    nc = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0).to(logp.dtype)
    n = valid.sum().clamp_min(1.0) if batch_denom is None else batch_denom
    # a -1 label one-hots to a zero row, as jax.nn.one_hot does
    tgt = (labels[:, None] == torch.arange(nc, device=labels.device)
           ).to(logp.dtype)
    if label_smoothing > 0.0:
        tgt = tgt * (1.0 - label_smoothing) + label_smoothing / nc
    ce = (-(tgt * logp).sum(-1) * valid).sum() / n
    acc = ((logits.argmax(-1) == labels) * valid).sum() / n
    return ce, {"acc": acc}


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,G,...] rows at idx [B,S] -> [B,S,...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def detection_loss(out: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], cfg: ModelConfig,
                   box_w: float = 7.5, cls_w: float = 0.5,
                   dfl_w: float = 1.5, seg_w: float = 1.0,
                   kpt_w: float = 12.0, kobj_w: float = 1.0,
                   assigner: str = "tal",
                   input_hw: Optional[Tuple[int, int]] = None,
                   assigner_topk: int = 10,
                   batch_denom: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched loss of the training forward (YOLO11.forward_train):
    box_logits [B,A,4*reg_max], cls_logits [B,A,nc], boxes_xywh [B,A,4],
    and mask_coefs/protos (segment), kpts (pose), boxes_xywhr (obb).
    targets: module docstring. input_hw: the batch's (H, W) (multi-scale);
    defaults to cfg.input_size. Returns (loss, aux), each the mean over the
    batch, or the sample_weight-weighted mean when it is given. batch_denom:
    the whole batch's clamped denominator when these rows are a shard of it
    (module docstring); the rows' weighted sums are divided by it."""
    hw = input_hw or cfg.input_size
    cls_logits = out["cls_logits"]
    dev = cls_logits.device
    anchors, strides = _grid(hw, dev)
    B, A, nc = cls_logits.shape
    labels = targets["labels"].long()
    G = labels.shape[1]
    zero = torch.zeros((), device=dev)
    is_obb = "boxes_xywhr" in targets
    if is_obb:
        # rotated targets: the TAL assigner runs rotated; the circumscribed
        # axis-aligned boxes serve the center assigner and the shape
        rbx = targets["boxes_xywhr"]
        ca, sa = torch.cos(rbx[..., 4]).abs(), torch.sin(rbx[..., 4]).abs()
        gt_boxes = torch.stack([rbx[..., 0], rbx[..., 1],
                                rbx[..., 2] * ca + rbx[..., 3] * sa,
                                rbx[..., 2] * sa + rbx[..., 3] * ca], -1)
    else:
        gt_boxes = targets["boxes_xywh"]
    if assigner == "tal":
        a = assign_targets_tal(out["boxes_xywh"], cls_logits, gt_boxes,
                               labels, cfg, topk=assigner_topk, input_hw=hw,
                               gt_rboxes=rbx if is_obb else None,
                               pred_rboxes=(out["boxes_xywhr"] if is_obb
                                            else None))
        cls_tgt = a["target_scores"]                            # [B,A,nc]
        w = cls_tgt.sum(-1)                                     # [B,A]
        denom = cls_tgt.sum((1, 2)).clamp_min(1.0)              # [B]
    else:
        a = assign_targets(gt_boxes, labels, cfg, input_hw=hw)
        gt_lab0 = labels.gather(1, a["gt_idx"]).clamp_min(0)
        cls_tgt = F.one_hot(gt_lab0, nc).float() * a["fg"][..., None]
        w = a["fg"].float()
        denom = a["fg"].sum(1).clamp_min(1).float()
    fg, gt_idx = a["fg"], a["gt_idx"]
    n_fg = fg.sum(1).clamp_min(1).float()
    gt_box = _take(gt_boxes, gt_idx)                            # [B,A,4]

    # cls BCE over all anchors against the (soft) target scores
    l_cls = bce_logits(cls_logits, cls_tgt).sum((1, 2)) / denom

    # box loss on positives, aligned-score weighted: CIoU, or the
    # differentiable probIoU for rotated boxes (the angle learns here)
    if is_obb:
        gt_rb = _take(rbx, gt_idx)                              # [B,A,5]
        box_term = 1.0 - probiou(out["boxes_xywhr"], gt_rb)
    else:
        box_term = 1.0 - ciou(out["boxes_xywh"], gt_box)
    l_box = torch.where(fg, box_term * w, zero).sum(1) / denom

    # DFL: target ltrb distances in grid units, two-bin soft target (obb:
    # the rotated target's unrotated extents, as ultralytics v8OBBLoss)
    dfl_gt = gt_rb[..., :4] if is_obb else gt_box
    cxy = anchors * strides
    lt = (cxy - (dfl_gt[..., :2] - dfl_gt[..., 2:] / 2)) / strides
    rb = ((dfl_gt[..., :2] + dfl_gt[..., 2:] / 2) - cxy) / strides
    ltrb = torch.cat([lt, rb], -1).clamp(0, cfg.reg_max - 1 - 1e-3)
    tl = torch.floor(ltrb)
    wr = ltrb - tl
    logp = torch.log_softmax(
        out["box_logits"].reshape(B, A, 4, cfg.reg_max), -1)
    tl_i = tl.long()
    l_lo = -logp.gather(-1, tl_i[..., None])[..., 0]
    l_hi = -logp.gather(-1, (tl_i + 1).clamp_max(cfg.reg_max - 1)[..., None]
                        )[..., 0]
    dfl = (l_lo * (1 - wr) + l_hi * wr).mean(-1)
    l_dfl = torch.where(fg, dfl * w, zero).sum(1) / denom

    loss = box_w * l_box + cls_w * l_cls + dfl_w * l_dfl
    aux = {"box": l_box, "cls": l_cls, "dfl": l_dfl}

    if "kpts" in out and "kpts" in targets:
        # OKS-style keypoint loss per positive anchor and visible keypoint,
        # plus a visibility BCE (the decode already sigmoided pred vis)
        pred_k = out["kpts"]
        K = pred_k.shape[-2]
        sig = torch.from_numpy(_kpt_sigmas(K)).to(dev)
        gt_k = _take(targets["kpts"], gt_idx)                   # [B,A,K,3]
        d2 = ((pred_k[..., :2] - gt_k[..., :2]) ** 2).sum(-1)
        area = (gt_box[..., 2] * gt_box[..., 3]).clamp_min(1.0)
        e = d2 / ((2.0 * sig) ** 2) / (2.0 * area[..., None])
        kmask = (gt_k[..., 2] > 0.5) & fg[..., None]
        l_kpt = (torch.where(kmask, 1.0 - torch.exp(-e), zero).sum((1, 2))
                 / kmask.sum((1, 2)).clamp_min(1))
        pv = pred_k[..., 2].clamp(1e-6, 1.0 - 1e-6)
        tv = (gt_k[..., 2] > 0.5).float()
        bce = -(tv * torch.log(pv) + (1.0 - tv) * torch.log(1.0 - pv))
        l_kobj = (torch.where(fg[..., None], bce, zero).sum((1, 2))
                  / (fg.sum(1) * K).clamp_min(1))
        loss = loss + kpt_w * l_kpt + kobj_w * l_kobj
        aux["kpt"] = l_kpt
        aux["kobj"] = l_kobj

    if "protos" in out and "masks" in targets:
        # seg BCE over a FIXED-SIZE slate of positives: TAL assigns at most
        # topk anchors per GT, so a slate of topk*G anchors holds every fg
        # one without the all-anchor [A,mh,mw] product. A stable sort of fg
        # puts the fg anchors first in index order, then the rest in index
        # order: lax.top_k's choice, so the slate equals JAX's even when
        # ties give a GT more than topk candidates.
        max_fg = min(A, assigner_topk * G) if assigner == "tal" else A
        coefs, gidx, fg_s = out["mask_coefs"], gt_idx, fg
        if max_fg < A:
            sel = torch.sort(fg.float(), dim=1, descending=True,
                             stable=True).indices[:, :max_fg]   # [B,S]
            fg_s = fg.gather(1, sel)
            coefs = _take(coefs, sel)                           # [B,S,nm]
            gidx = gt_idx.gather(1, sel)
        gt_m = _take(targets["masks"], gidx)                    # [B,S,h,w]
        mlogit = torch.einsum("bsn,bhwn->bshw", coefs, out["protos"])
        l_seg = (torch.where(fg_s[..., None, None],
                             bce_logits(mlogit, gt_m), zero)
                 .mean((-1, -2)).sum(1) / n_fg)
        loss = loss + seg_w * l_seg
        aux["seg"] = l_seg

    sw = targets.get("sample_weight")
    if batch_denom is not None:
        # a shard's share of the whole batch's (weighted) mean
        n = batch_denom
        if sw is not None:
            sw = sw.to(loss.dtype)
            return (loss * sw).sum() / n, {k: (v * sw).sum() / n
                                           for k, v in aux.items()}
        return loss.sum() / n, {k: v.sum() / n for k, v in aux.items()}
    if sw is not None:
        # padded batch rows (Loader drop_last=False) weigh 0: removed from
        # the loss exactly
        sw = sw.to(loss.dtype)
        n = sw.sum().clamp_min(1.0)
        return (loss * sw).sum() / n, {k: (v * sw).sum() / n
                                       for k, v in aux.items()}
    return loss.mean(), {k: v.mean() for k, v in aux.items()}
