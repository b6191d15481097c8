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
params' state_dict, the optimizer state and the step, always the full
tensors (a state sharded over a mesh is gathered), so a checkpoint written
on a mesh reloads on one device and the reverse. (JAX writes orbax
directories; orbax is on neither machine the port runs on.)

Training over a mesh (parallel/mesh.Mesh). JAX jits one program and XLA
inserts the collectives; here the host drives each device:
  - shard_train_state places a state: the model and its moments on the
    mesh's first device, and a module for each data row (the rows on one
    device share one; another device gets a replica, refreshed after each
    update). With a model axis wider than 1 (TP), a row's convolutions
    whose output channels reach tp_min_channels run as slices, each taken
    in the forward from the full parameter (parallel/batch.place_row), so
    the gradients and the optimizer state stay keyed by parameter name.
  - DP: each row runs forward_train -> loss -> backward on its shard of
    the batch, on its device, under the model's precision scope. Every
    shard divides by the WHOLE batch's denominator (losses.py), so the
    rows' gradients sum to the unsharded batch's; they are summed onto the
    first device, where one Optimizer.update runs.
  - FSDP (ZeRO-3): each leaf that parallel/mesh.fsdp_param_shardings
    splits lives between steps as one slice per data position, on that
    position's device, and so do its moments (`Shards`); the module holds
    an empty tensor in its place. A step gathers the full weights, runs
    the DP step, scatters the summed gradient into slices and updates each
    slice with its moments; the global-norm clip reads the full gradient
    before the scatter, so it takes every leaf once, as DP does.
  - across processes (parallel/multihost), each process runs its rows and
    the gradients and the denominators are all-reduced with
    torch.distributed, so every process applies the same update; the
    initial weights are rank 0's. FSDP across processes raises, as in JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device, to_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.parallel import mesh as mesh_lib
from xrseg_tpu_torch.parallel.batch import on_device, place_row
from xrseg_tpu_torch.parallel.mesh import Mesh, Sharding
from xrseg_tpu_torch.parallel.multihost import ProcessShard
from xrseg_tpu_torch.precision import precision_scope
from xrseg_tpu_torch.train.losses import (batch_denominator,
                                          classification_loss,
                                          detection_loss)


@dataclasses.dataclass
class Shards:
    """A leaf that lives as one slice per data position of a mesh (FSDP):
    parts[i], on position i's device, holds the i-th of len(parts) equal
    pieces along `dim`."""
    parts: List[torch.Tensor]
    dim: int

    @classmethod
    def split(cls, t: torch.Tensor, dim: int, devices) -> "Shards":
        """Each piece copied to its device into storage of its own (a view
        would keep the full tensor alive)."""
        return cls([torch.empty_like(c, device=dev,
                                     memory_format=torch.contiguous_format)
                    .copy_(c) for c, dev in zip(t.chunk(len(devices), dim),
                                                devices)], dim)

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(s)

    def full(self, device) -> torch.Tensor:
        return torch.cat([p.to(device) for p in self.parts], self.dim)


def _full(t, device) -> torch.Tensor:
    return t.full(device) if isinstance(t, Shards) else t.to(device)


@dataclasses.dataclass(eq=False)
class Placement:
    """Where a TrainState lives on a mesh (shard_train_state): `rows[i]` is
    the module data row i runs on `row_devices[i]` (None for a row that
    another process runs); `replicas` are the copies of the model on
    devices other than the first; `split` holds the FSDP slices of the
    parameters the rule splits (empty otherwise)."""
    mesh: Mesh
    tp_min_channels: int
    fsdp: bool
    fsdp_min_size: int
    rows: List[Optional[nn.Module]]
    row_devices: List[Optional[torch.device]]
    replicas: List[nn.Module]
    split: Dict[str, Shards]


@dataclasses.dataclass
class TrainState:
    """What a step updates, in place: the model (its parameters are the
    params), the optimizer state and the number of steps taken. On a mesh
    `placement` says where the rest lives (module docstring); under FSDP
    the model's split leaves are empty between steps and their moments are
    Shards: gathered_params / full_parameters read the full weights."""
    params: yolo11.YOLO11
    opt_state: Dict[str, Any]
    step: int
    placement: Optional[Placement] = None


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
        return self.apply(params, grads, list(opt_state["mu"].values()),
                          list(opt_state["nu"].values()), opt_state)

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the leaves' norms, on the first grad's device."""
        home = grads[0].device
        return torch.linalg.vector_norm(torch.stack(
            [n.to(home) for n in torch._foreach_norm(grads)]))

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              mu: List[torch.Tensor], nu: List[torch.Tensor],
              opt_state: Dict[str, Any],
              norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """update() on matching lists of tensors, which may lie on several
        devices (FSDP slices): the clip by `norm` (default: the global
        norm of `grads`), then each device's tensors updated where they
        are."""
        if norm is None:
            norm = self.global_norm(grads)
        groups: Dict[torch.device, List[int]] = {}
        for i, p in enumerate(params):
            groups.setdefault(p.device, []).append(i)
        for dev, idx in groups.items():
            self._adamw([params[i] for i in idx], [grads[i] for i in idx],
                        [mu[i] for i in idx], [nu[i] for i in idx],
                        norm.to(dev), opt_state["count"])
        opt_state["count"] += 1
        return norm

    def _adamw(self, params, grads, mu, nu, norm, count) -> None:
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

    def loss_fn(self, model: yolo11.YOLO11, batch: Dict[str, torch.Tensor],
                batch_denom: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The batch's loss and aux terms; with batch_denom (a shard of a
        larger batch) the shard's share of the whole batch's (losses.py)."""
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
                                       label_smoothing=self.label_smoothing,
                                       batch_denom=batch_denom)
        tgt = {k: batch[k] for k in ("boxes_xywh", "boxes_xywhr", "kpts",
                                     "labels", "sample_weight")
               if k in batch}
        if "masks" in batch and cfg.task == "segment":
            tgt["masks"] = batch["masks"]
        # anchors follow the batch's own (H, W) (multi-scale buckets)
        hw = tuple(int(d) for d in images.shape[1:3])
        loss, aux = detection_loss(out, tgt, cfg, input_hw=hw,
                                   batch_denom=batch_denom)
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
                                    input_hw=hw, assigner_topk=1,
                                    batch_denom=batch_denom)
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


FSDP_ACROSS_PROCESSES = (
    "fsdp across processes is unsupported: each process holds the full "
    "state (parallel/multihost.py); use DP")


def _materialize(split: Dict[str, Shards], modules) -> None:
    """FSDP: the split leaves of each module gathered onto its device."""
    for m in modules:
        named = dict(m.named_parameters())
        for n, sh in split.items():
            named[n].data = sh.full(named[n].device)


def _release(split: Dict[str, Shards], modules) -> None:
    """FSDP: the split leaves of each module (and their grads) freed; the
    slices in `split` are what remains of them."""
    for m in modules:
        named = dict(m.named_parameters())
        for n in split:
            named[n].data = named[n].data.new_empty(0)
            named[n].grad = None


def _all_reduce_(tensors: List[torch.Tensor], scale: float) -> None:
    """Each tensor summed over the processes and times `scale`, in place,
    in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.mul_(scale)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class MeshRun:
    """The host side of a step over a mesh, shared by the train step and
    the distillation step (module docstring): placing the state, the
    batch's shards and microbatches, the whole batch's sums, and the
    reduction and the update after the rows' backward.

    Across processes every process of a data row runs that row (as JAX's
    replicas along the model axis do), so what the processes all-reduce
    is divided by the model axis."""

    def __init__(self, mesh: Mesh, tp_min_channels: int, fsdp: bool,
                 fsdp_min_size: int):
        if fsdp and mesh.multiprocess:
            raise ValueError(FSDP_ACROSS_PROCESSES)
        self.mesh, self.tp_min_channels = mesh, tp_min_channels
        self.fsdp, self.fsdp_min_size = fsdp, fsdp_min_size
        self.first = mesh.first_device
        self.copies = mesh.shape["model"] if mesh.multiprocess else 1

    def placed(self, state: TrainState) -> TrainState:
        """`state` placed on this mesh the way the step runs it (JAX's
        in_shardings): as it is if it already is."""
        p = state.placement
        if (p is None or p.mesh is not self.mesh or p.fsdp != self.fsdp
                or (self.fsdp and p.fsdp_min_size != self.fsdp_min_size)):
            return shard_train_state(state, self.mesh, self.tp_min_channels,
                                     self.fsdp, self.fsdp_min_size)
        return state

    def shards(self, batch) -> List[Optional[Dict[str, torch.Tensor]]]:
        """The batch as one dict per data row, on the row's device (None
        for a row this process does not run). A host batch is split here;
        a list is taken as it is (Loader(mesh=), shard_batch); a dict of
        multihost.ProcessShard holds this process's rows of a batch that
        spans processes."""
        d = self.mesh.shape["data"]
        if isinstance(batch, list):
            if len(batch) != d:
                raise ValueError(f"{len(batch)} shards for a mesh with data "
                                 f"axis {d}")
            return batch
        if not any(isinstance(v, ProcessShard) for v in batch.values()):
            return mesh_lib.shard_batch(batch, self.mesh)
        ps = next(iter(batch.values()))
        rows = ps.global_batch // d
        rank = mesh_lib.process_rank()
        out = []
        for i in range(d):
            if rank not in self.mesh.ranks[i]:
                out.append(None)
                continue
            lo = i * rows - ps.start
            if lo < 0 or lo + rows > len(ps.data):
                raise ValueError(
                    f"this process holds rows [{ps.start}, "
                    f"{ps.start + len(ps.data)}), not data row {i}'s")
            out.append({k: v.data[lo:lo + rows] for k, v in batch.items()})
        return out

    def _all_rows(self, shards) -> List[Dict[str, torch.Tensor]]:
        """Every row's shard on the CPU, from the processes that hold them
        (grad_accum across processes: a microbatch takes rows that another
        process was given)."""
        mine = {i: {k: v.cpu() for k, v in s.items()}
                for i, s in enumerate(shards) if s is not None}
        parts: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        rows: Dict[int, Dict[str, torch.Tensor]] = {}
        for part in parts:
            for i, s in part.items():
                rows.setdefault(i, s)
        return [rows[i] for i in range(len(shards))]

    def microbatches(self, p: Placement, shards, accum: int) -> list:
        """JAX's split into `accum` microbatches of consecutive rows, each
        sharded over the data axis: microbatch a's part on row i holds the
        global rows from a * mb + i * mb / d, taken from whichever shard
        holds them and moved to row i's device."""
        if accum <= 1:
            return [shards]
        d = len(shards)
        if any(s is None for s in shards):
            shards = self._all_rows(shards)
        r = len(shards[0]["images"])
        B = r * d
        if B % accum:
            raise ValueError(f"batch {B} not divisible by grad_accum "
                             f"{accum}")
        mb = B // accum
        if mb % d:
            raise ValueError(
                f"microbatch {mb} (batch {B} / grad_accum {accum}) must "
                f"stay divisible by the data axis {d} — a smaller "
                "microbatch would silently replicate (SPMD full-remat) "
                "instead of shard")
        per = mb // d
        out = []
        for a in range(accum):
            parts = []
            for i in range(d):
                if p.rows[i] is None:
                    parts.append(None)
                    continue
                j, off = divmod(a * mb + i * per, r)
                parts.append({k: v[off:off + per].to(p.row_devices[i])
                              for k, v in shards[j].items()})
            out.append(parts)
        return out

    def global_sum(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The sum of per-row values over the rows of every process, on
        the first device."""
        total = torch.zeros((), device=self.first)
        for v in values:
            total = total + v.to(self.first)
        if self.mesh.multiprocess:
            _all_reduce_([total], 1.0 / self.copies)
        return total

    def denominator(self, parts, task: str) -> torch.Tensor:
        """The whole batch's loss denominator (losses.batch_denominator)."""
        return self.global_sum([batch_denominator(part, task)
                                for part in parts if part is not None]
                               ).clamp_min(1.0)

    def begin(self, state: TrainState) -> None:
        """Before the rows' backward: every module's grads cleared once,
        the FSDP leaves gathered."""
        p = state.placement
        modules = [state.params] + p.replicas
        for m in modules:
            m.zero_grad(set_to_none=True)
        _materialize(p.split, modules)

    def backward_rows(self, p: Placement, parts, loss_fn):
        """loss_fn(i, part) -> (loss, aux) on each row this process runs,
        on the row's device, each followed by its backward; the rows'
        (detached) sums on the first device."""
        loss = aux = None
        for i, part in enumerate(parts):
            if part is None:
                continue
            with on_device(p.row_devices[i]):
                l, a = loss_fn(i, part)
                l.backward()
            l = l.detach().to(self.first)
            a = {k: v.detach().to(self.first) for k, v in a.items()}
            loss = l if loss is None else loss + l
            aux = a if aux is None else {k: aux[k] + a[k] for k in aux}
        return loss, aux

    def metrics(self, losses: list, auxs: list):
        """The mean over the microbatches, summed over the processes."""
        if len(losses) == 1:
            loss, aux = losses[0], auxs[0]
        else:
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        if self.mesh.multiprocess:
            vals = torch.stack([loss, *aux.values()])
            _all_reduce_([vals], 1.0 / self.copies)
            loss, aux = vals[0], dict(zip(aux, vals[1:]))
        return loss, aux

    @torch.no_grad()
    def finish(self, state: TrainState, optimizer: Optimizer,
               accum: int) -> torch.Tensor:
        """The replicas' grads summed onto the first device's, divided by
        the microbatches and all-reduced over the processes; one update
        (FSDP: each slice with its slice of the gradient and moments); the
        FSDP leaves freed and the replicas refreshed. Returns the global
        grad norm."""
        p, model, opt = state.placement, state.params, state.opt_state
        for rep in p.replicas:
            for pm, pr in zip(model.parameters(), rep.parameters()):
                if pr.grad is not None:
                    g = pr.grad.to(self.first)
                    pm.grad = g if pm.grad is None else pm.grad.add_(g)
                    pr.grad = None
        named = dict(model.named_parameters())
        grads = [torch.zeros_like(named[n]) if named[n].grad is None
                 else named[n].grad for n in opt["mu"]]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        if self.mesh.multiprocess:
            _all_reduce_(grads, 1.0 / self.copies)
        # the norm of the full leaves, as DP takes it (FSDP's slices would
        # round it otherwise, and Adam magnifies float-noise gradients)
        norm = optimizer.global_norm(grads)
        params, flat_g, mu, nu = [], [], [], []
        for n, g in zip(opt["mu"], grads):
            if n in p.split:
                # the reduce-scatter: each slice takes its piece
                sh = p.split[n]
                params += sh.parts
                flat_g += [c.to(t.device) for c, t in
                           zip(g.chunk(len(sh.parts), sh.dim), sh.parts)]
                mu += opt["mu"][n].parts
                nu += opt["nu"][n].parts
            else:
                params.append(named[n])
                flat_g.append(g)
                mu.append(opt["mu"][n])
                nu.append(opt["nu"][n])
        _release(p.split, [model] + p.replicas)
        optimizer.apply(params, flat_g, mu, nu, opt, norm)
        for rep in p.replicas:
            for (n, pm), pr in zip(model.named_parameters(),
                                   rep.parameters()):
                if n not in p.split:
                    pr.copy_(pm)
        return norm


class MeshTrainStep(TrainStep):
    """The train step over a mesh (module docstring). `shard_step` is the
    single-device step on one shard's rows on the first device: what the
    memory preflight measures."""

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 use_remat: bool, grad_accum: int, label_smoothing: float,
                 run: MeshRun):
        super().__init__(cfg, optimizer, use_remat, grad_accum,
                         label_smoothing, run.first)
        self.run = run
        self.shard_step = TrainStep(cfg, optimizer, use_remat, grad_accum,
                                    label_smoothing, run.first)

    def __call__(self, state: TrainState, batch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        run = self.run
        state = run.placed(state)
        p = state.placement
        shards = run.shards(batch)
        losses, auxs = [], []
        with precision_scope(self.cfg.matmul_precision):
            micro = run.microbatches(p, shards, self.grad_accum)
            run.begin(state)
            for parts in micro:
                denom = run.denominator(parts, self.cfg.task)
                loss, aux = run.backward_rows(
                    p, parts, lambda i, part: self.loss_fn(
                        p.rows[i], part, denom.to(p.row_devices[i])))
                losses.append(loss)
                auxs.append(aux)
        loss, aux = run.metrics(losses, auxs)
        grad_norm = run.finish(state, self.optimizer, self.grad_accum)
        state.step += 1
        return state, {"loss": loss, **aux, "grad_norm": grad_norm}


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    mesh: Optional[Mesh] = None,
                    tp_min_channels: int = 100000, use_remat: bool = True,
                    fsdp: bool = False, fsdp_min_size: int = 65536,
                    grad_accum: int = 1, label_smoothing: float = 0.0,
                    device="cuda") -> TrainStep:
    """The train step for ANY task on `device`, or over `mesh` (module
    docstring; the mesh's devices then stand for `device`).
    label_smoothing: the classify task's CE target smoothing; no effect on
    the detection tasks. tp_min_channels: the TP rule for a state the
    step has to place itself (a state placed by shard_train_state keeps
    its own). fsdp (requires a mesh): params and moments sharded over the
    data axis, leaves of at least fsdp_min_size values.

    detect/segment/pose/obb batch: {"images": [B,H,W,3] f32 in [0,1],
        "boxes_xywh": [B,G,4], "labels": [B,G] (-1 pad), "masks":
        [B,G,mh,mw] (segment), "boxes_xywhr"/"kpts" (obb/pose),
        "sample_weight": [B] (optional)}
    classify batch: {"images": [B,H,W,3] f32, "labels": [B] (-1 pad)}
    Numpy arrays or tensors on any device; they are moved to `device`.
    Over a mesh also a list of per-row shards (shard_batch, Loader(mesh=))
    or a dict of this process's rows (multihost.shard_host_batch)."""
    if mesh is None:
        if fsdp:
            raise ValueError("fsdp=True requires a mesh")
        return TrainStep(cfg, optimizer, use_remat, grad_accum,
                         label_smoothing, resolve_device(device))
    return MeshTrainStep(cfg, optimizer, use_remat, grad_accum,
                         label_smoothing,
                         MeshRun(mesh, tp_min_channels, fsdp, fsdp_min_size))


def make_classify_train_step(cfg: ModelConfig, optimizer: Optimizer,
                             device="cuda") -> TrainStep:
    """Back-compat alias: classify routes through make_train_step."""
    return make_train_step(cfg, optimizer, use_remat=False, device=device)


def shard_train_state(state: TrainState, mesh: Mesh,
                      tp_min_channels: int = 100000, fsdp: bool = False,
                      fsdp_min_size: int = 65536) -> TrainState:
    """`state` placed on `mesh` (module docstring): its model and moments
    are moved, not copied, so read the result, not the argument. A state
    placed before is gathered first. Across processes every process takes
    rank 0's weights and moments."""
    if fsdp and mesh.multiprocess:
        raise ValueError(FSDP_ACROSS_PROCESSES)
    if state.placement is not None:
        state = gather_train_state(state)
    first = mesh.first_device
    model = state.params.to(first)
    opt = {"count": state.opt_state["count"],
           **{key: {n: t.to(first) for n, t in state.opt_state[key].items()}
              for key in ("mu", "nu")}}
    d = mesh.shape["data"]
    if mesh.multiprocess:
        from xrseg_tpu_torch.parallel.multihost import replicate_params
        replicate_params(model, mesh)
        for key in ("mu", "nu"):
            for t in opt[key].values():
                dist.broadcast(t, src=0)
        rank = mesh_lib.process_rank()
        row_devs = [[first] if rank in mesh.ranks[i] else None
                    for i in range(d)]
    else:
        row_devs = [list(mesh.devices[i]) for i in range(d)]
    split: Dict[str, Shards] = {}
    rules = mesh_lib.param_shardings(model, mesh, tp_min_channels)
    if fsdp:
        rules = {n: Sharding() for n in rules}          # no TP under FSDP
        devs = [mesh.devices[i, 0] for i in range(d)]
        named = dict(model.named_parameters())
        for n, r in mesh_lib.fsdp_param_shardings(
                model, mesh, min_size=fsdp_min_size).items():
            if r.axis is not None:
                split[n] = Shards.split(named[n].detach(), r.dim, devs)
                for key in ("mu", "nu"):
                    opt[key][n] = Shards.split(opt[key][n], r.dim, devs)
        _release(split, [model])
        row_devs = [[dv] for dv in devs]
    bases: Dict[str, nn.Module] = {str(first): model}
    replicas, views, rows = [], {}, []
    for devs in row_devs:
        if devs is None:
            rows.append(None)
            continue
        key = tuple(str(dv) for dv in devs)
        if key not in views:
            if key[0] not in bases:
                bases[key[0]] = copy.deepcopy(model).to(devs[0])
                replicas.append(bases[key[0]])
            views[key] = place_row(bases[key[0]], devs, rules, train=True)
        rows.append(views[key])
    placement = Placement(mesh, tp_min_channels, fsdp, fsdp_min_size, rows,
                          [devs[0] if devs else None for devs in row_devs],
                          replicas, split)
    return TrainState(model, opt, state.step, placement)


def gather_train_state(state: TrainState) -> TrainState:
    """A placed state as a single-device one on the mesh's first device:
    the FSDP leaves gathered into the model, the moments full. The placed
    state is spent (its model now holds the full weights)."""
    p = state.placement
    if p is None:
        return state
    first = p.mesh.first_device
    _materialize(p.split, [state.params])
    opt = {"count": state.opt_state["count"],
           **{key: {n: _full(t, first)
                    for n, t in state.opt_state[key].items()}
              for key in ("mu", "nu")}}
    return TrainState(state.params, opt, state.step)


def full_parameters(state: TrainState) -> List[torch.Tensor]:
    """The full weights in the model's parameter order: the parameters
    themselves, and under FSDP each split leaf gathered on the first
    device."""
    p = state.placement
    if p is None or not p.split:
        return list(state.params.parameters())
    first = p.mesh.first_device
    return [p.split[n].full(first) if n in p.split else t
            for n, t in state.params.named_parameters()]


def gathered_params(state: TrainState) -> yolo11.YOLO11:
    """The model with its full weights (what validation, the EMA and the
    npz files read): the state's own module, or under FSDP a copy with the
    split leaves gathered."""
    p = state.placement
    if p is None or not p.split:
        return state.params
    model = copy.deepcopy(state.params)
    _materialize(p.split, [model])
    return model


@contextlib.contextmanager
def full_weights(state: TrainState):
    """The state's model with its FSDP leaves gathered for the duration
    (the memory preflight runs the step's forward and backward on it)."""
    split = state.placement.split if state.placement is not None else {}
    _materialize(split, [state.params])
    try:
        yield state.params
    finally:
        _release(split, [state.params])


def train_state_shardings(cfg: ModelConfig, optimizer: Optimizer,
                          mesh: Mesh, fsdp_min_size: int = 65536
                          ) -> TrainState:
    """Where each leaf of a TrainState lives under FSDP, derived with no
    device work (the model built on the meta device): the moments follow
    their parameter; the count and the step replicate."""
    with torch.device("meta"):
        model = yolo11.YOLO11(cfg)
    rules = mesh_lib.fsdp_param_shardings(model, mesh,
                                          min_size=fsdp_min_size)
    opt = optimizer.init(model)
    return TrainState(params=rules,
                      opt_state={"count": Sharding(),
                                 **{key: {n: rules[n] for n in opt[key]}
                                    for key in ("mu", "nu")}},
                      step=Sharding())


def save_train_state(path: str, state: TrainState) -> None:
    """The FULL training state (params, optimizer moments, step) for
    resume, as one torch.save file written atomically; a placed state is
    gathered to its full tensors."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cpu = torch.device("cpu")
    opt = state.opt_state
    params = {k: v.detach().cpu()
              for k, v in state.params.state_dict().items()}
    if state.placement is not None:
        for n, sh in state.placement.split.items():
            params[n] = sh.full(cpu)
    blob = {"params": params,
            "opt_state": {"count": int(opt["count"]),
                          **{key: {k: _full(v, cpu)
                                   for k, v in opt[key].items()}
                             for key in ("mu", "nu")}},
            "step": int(state.step)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a save_train_state file into `like` (its model and moments
    are overwritten in place, on their devices). A placed `like` is
    gathered, loaded and placed again the same way: read the result."""
    p = like.placement
    if p is not None:
        full = load_train_state(path, gather_train_state(like))
        return shard_train_state(full, p.mesh, p.tp_min_channels, p.fsdp,
                                 p.fsdp_min_size)
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
