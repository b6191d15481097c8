"""The train step and its optimizer (counterpart of
xrseg_tpu/train/train_step.py), single device.

`make_train_step` builds one step for ANY task: the training forward
(YOLO11.forward_train, under torch.utils.checkpoint when use_remat), the
task's loss (train/losses.py), backward, and the optimizer's update, in
place on the state. grad_accum=A splits the batch into A sequential
microbatches whose grads are summed and divided by A before the one
update; each microbatch normalises its own loss (TAL's target-score
denominator), as in JAX.

The optimizer (`make_optimizer`) computes what the JAX package's
`optax.chain(clip_by_global_norm(10), adamw(warmup_cosine_decay_schedule(
0, lr, warmup, total), weight_decay))` computes, step for step, written
out here because torch's stock pieces differ in three places:
  - the clip scales by max/norm only when norm >= max, as optax does
    (clip_grad_norm_ scales by max/(norm + 1e-6) whenever norm > max);
  - the schedule counts from 0 at the first update (so the first update
    has a learning rate of 0) and its decay horizon includes the warmup;
  - the weight decay applies to every parameter, biases included.
Its state is plain tensors: {"count": int, "mu": {name: tensor}, "nu":
{name: tensor}} keyed by the model's parameter names.

Checkpoints are one file, <path> = <ckpt_dir>/state.pt: torch.save of the
params' state_dict, the optimizer state and the step. (JAX writes orbax
directories; orbax is on neither machine the port runs on.)

Multi-device training (mesh, TP, FSDP) is ROADMAP item 10: a mesh, fsdp,
shard_train_state and train_state_shardings raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device, to_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.precision import precision_scope
from xrseg_tpu_torch.train.losses import (classification_loss,
                                          detection_loss)

ITEM_10 = ("multi-device training (mesh, TP, FSDP) is not ported yet "
           "(ROADMAP item 10); train on one device")


@dataclasses.dataclass
class TrainState:
    """What a step updates, in place: the model (its parameters are the
    params), the optimizer state and the number of steps taken."""
    params: yolo11.YOLO11
    opt_state: Dict[str, Any]
    step: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Global-norm clip, then AdamW under a linear-warmup cosine schedule
    (module docstring). `update` reads each parameter's .grad."""
    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    max_norm: float = 10.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, total) at
        `count` updates done, in float32 as optax evaluates it."""
        f32 = np.float32
        lr, w = f32(self.lr), self.warmup_steps
        if count < w:
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return float(-lr * frac + lr)
        span = f32(self.total_steps - w)
        c = min(f32(count - w), span)
        return float(lr * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                                       / span))))

    def init(self, model: torch.nn.Module) -> Dict[str, Any]:
        """Zero moments keyed (and ordered) by the parameter names."""
        return {"count": 0,
                "mu": {n: torch.zeros_like(p)
                       for n, p in model.named_parameters()},
                "nu": {n: torch.zeros_like(p)
                       for n, p in model.named_parameters()}}

    @torch.no_grad()
    def update(self, model: torch.nn.Module,
               opt_state: Dict[str, Any]) -> torch.Tensor:
        """One update of `model`'s parameters from their .grad (a missing
        grad counts as zero, as JAX's zero cotangent); returns the global
        grad norm before clipping. No host sync."""
        named = dict(model.named_parameters())
        params = [named[n] for n in opt_state["mu"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        mu, nu = list(opt_state["mu"].values()), list(opt_state["nu"].values())
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # clip_by_global_norm: g if norm < max else (g / norm) * max
        keep = norm < self.max_norm
        one = torch.ones((), device=norm.device)
        g = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * self.max_norm))
        # adam moments: (1 - b) * g**order + b * moment
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_add_(nu, g2)
        count = opt_state["count"]
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count + 1))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count + 1))
        # mu_hat / (sqrt(nu_hat) + eps) + wd * p, times -lr(count)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -self.schedule(count))
        torch._foreach_add_(params, upd)
        opt_state["count"] = count + 1
        return norm


def make_optimizer(lr: float = 1e-3, weight_decay: float = 5e-4,
                   warmup_steps: int = 100, total_steps: int = 10_000
                   ) -> Optimizer:
    return Optimizer(lr, weight_decay, warmup_steps,
                     max(total_steps, warmup_steps + 1))


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     optimizer: Optimizer, device="cuda") -> TrainState:
    """A fresh model from `gen` (models/yolo11.init_params) on `device`,
    with zero optimizer moments."""
    model = yolo11.init_params(gen, cfg).to(resolve_device(device))
    return TrainState(params=model, opt_state=optimizer.init(model), step=0)


class TrainStep:
    """step(state, batch) -> (state, metrics): one update of `state` in
    place. metrics holds 0-dim tensors on the device: loss, the loss's aux
    terms and grad_norm (before clipping)."""

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 use_remat: bool, grad_accum: int, label_smoothing: float,
                 device: torch.device):
        self.cfg, self.optimizer = cfg, optimizer
        self.use_remat, self.grad_accum = use_remat, grad_accum
        self.label_smoothing, self.device = label_smoothing, device

    def loss_fn(self, model: yolo11.YOLO11, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        images = batch["images"]
        if self.use_remat:
            # keep only the input; the backward runs the forward again
            out = checkpoint(model.forward_train, images,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = model.forward_train(images)
        if cfg.task == "classify":
            return classification_loss(out["logits"], batch["labels"],
                                       label_smoothing=self.label_smoothing)
        tgt = {k: batch[k] for k in ("boxes_xywh", "boxes_xywhr", "kpts",
                                     "labels", "sample_weight")
               if k in batch}
        if "masks" in batch and cfg.task == "segment":
            tgt["masks"] = batch["masks"]
        # anchors follow the batch's own (H, W) (multi-scale buckets)
        hw = tuple(int(d) for d in images.shape[1:3])
        loss, aux = detection_loss(out, tgt, cfg, input_hw=hw)
        if "o2o_cls_logits" in out:
            # the NMS-free one-to-one head trains with TAL topk=1 on boxes
            # and classes; masks train through the one-to-many loss
            o2o_out = {"box_logits": out["o2o_box_logits"],
                       "cls_logits": out["o2o_cls_logits"],
                       "boxes_xywh": out["o2o_boxes_xywh"]}
            o2o_tgt = {k: tgt[k] for k in ("boxes_xywh", "labels",
                                           "sample_weight") if k in tgt}
            l2, a2 = detection_loss(o2o_out, o2o_tgt,
                                    dataclasses.replace(cfg, task="detect"),
                                    input_hw=hw, assigner_topk=1)
            loss = loss + l2
            aux = {**aux, **{f"o2o_{k}": v for k, v in a2.items()}}
        return loss, aux

    def compute_grads(self, model: yolo11.YOLO11,
                      batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss and aux (detached) with every parameter's .grad set to the
        batch's gradient (the mean over grad_accum microbatches). The
        backward runs under the model's matmul precision too: autograd
        launches the backward convolutions after forward_train has left
        its precision scope, and cuDNN reads the TF32 switch at launch (as
        XLA's transposed ops keep the forward's precision)."""
        with precision_scope(self.cfg.matmul_precision):
            return self._compute_grads(model, batch)

    def _compute_grads(self, model, batch):
        model.zero_grad(set_to_none=True)
        accum = self.grad_accum
        if accum <= 1:
            loss, aux = self.loss_fn(model, batch)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in aux.items()}
        B = batch["images"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by grad_accum "
                             f"{accum}")
        mb = B // accum
        losses, auxs = [], []
        for i in range(accum):
            loss, aux = self.loss_fn(
                model, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            loss.backward()
            losses.append(loss.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        torch._foreach_div_(grads, float(accum))
        return (torch.stack(losses).mean(),
                {k: torch.stack([a[k] for a in auxs]).mean()
                 for k in auxs[0]})

    def __call__(self, state: TrainState, batch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {k: to_device(v, self.device) for k, v in batch.items()}
        loss, aux = self.compute_grads(state.params, batch)
        grad_norm = self.optimizer.update(state.params, state.opt_state)
        state.step += 1
        return state, {"loss": loss, **aux, "grad_norm": grad_norm}


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh=None,
                    use_remat: bool = True, fsdp: bool = False,
                    grad_accum: int = 1, label_smoothing: float = 0.0,
                    device="cuda") -> TrainStep:
    """The train step for ANY task on `device` (module docstring).
    label_smoothing: the classify task's CE target smoothing; no effect on
    the detection tasks.

    detect/segment/pose/obb batch: {"images": [B,H,W,3] f32 in [0,1],
        "boxes_xywh": [B,G,4], "labels": [B,G] (-1 pad), "masks":
        [B,G,mh,mw] (segment), "boxes_xywhr"/"kpts" (obb/pose),
        "sample_weight": [B] (optional)}
    classify batch: {"images": [B,H,W,3] f32, "labels": [B] (-1 pad)}
    Numpy arrays or tensors on any device; they are moved to `device`."""
    if mesh is not None or fsdp:
        raise NotImplementedError(ITEM_10)
    return TrainStep(cfg, optimizer, use_remat, grad_accum, label_smoothing,
                     resolve_device(device))


def make_classify_train_step(cfg: ModelConfig, optimizer: Optimizer,
                             device="cuda") -> TrainStep:
    """Back-compat alias: classify routes through make_train_step."""
    return make_train_step(cfg, optimizer, use_remat=False, device=device)


def save_train_state(path: str, state: TrainState) -> None:
    """The FULL training state (params, optimizer moments, step) for
    resume, as one torch.save file written atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opt = state.opt_state
    blob = {"params": {k: v.detach().cpu()
                       for k, v in state.params.state_dict().items()},
            "opt_state": {"count": int(opt["count"]),
                          "mu": {k: v.cpu() for k, v in opt["mu"].items()},
                          "nu": {k: v.cpu() for k, v in opt["nu"].items()}},
            "step": int(state.step)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a save_train_state file into `like` (its model and moments
    are overwritten in place, on their devices)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    like.params.load_state_dict(blob["params"], strict=True)
    opt = like.opt_state
    saved = blob["opt_state"]
    if list(saved["mu"]) != list(opt["mu"]):
        raise ValueError(f"{path}: the optimizer state was saved for other "
                         "parameters")
    with torch.no_grad():
        for key in ("mu", "nu"):
            for name, t in opt[key].items():
                t.copy_(saved[key][name])
    opt["count"] = int(saved["count"])
    like.step = int(blob["step"])
    return like


def shard_train_state(*args, **kwargs):
    """Multi-device placement: ROADMAP item 10."""
    raise NotImplementedError(ITEM_10)


def train_state_shardings(*args, **kwargs):
    """Multi-device placement: ROADMAP item 10."""
    raise NotImplementedError(ITEM_10)
