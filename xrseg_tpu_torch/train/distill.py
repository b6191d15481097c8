"""Knowledge distillation (counterpart of xrseg_tpu/train/distill.py):
train a small or other-generation student from a larger teacher's
responses, on unlabelled frames (yolo11s -> yolo11n, yolo11n -> yolov8n).

One step: the teacher's forward_train under torch.no_grad (JAX's
stop_gradient) in the teacher's precision scope; the student's
forward_train (under torch.utils.checkpoint with use_remat), the loss and
its backward in the student's precision scope (cuDNN reads the TF32
switch when autograd launches the backward convolutions; the train
step's pattern, train/train_step.TrainStep.compute_grads); then the train
step's Optimizer.update. The step updates its TrainState in place.

Losses (detect-family tasks), as in the JAX package:
  - class response KL: per-class binary KL between the teacher's and the
    student's sigmoid scores at temperature T, scaled by T^2;
  - box distribution KL: KL between the DFL softmax distributions over
    the reg_max bins, per box side;
  - anchors weighted by the teacher's max class probability (^fg_power),
    normalized over the batch.
Classify: softmax KL at temperature T. Mask and proto branches are not
distilled (mask coefficients are basis-relative); det_weight > 0 mixes
the ground-truth loss in (detection_loss, or classification_loss for
classify), its terms under a "gt_" prefix.

log-sigmoid is F.logsigmoid: torch's softplus turns linear above its
threshold of 20, JAX's does not, so -softplus(-x) would differ there.

Over a mesh (DP, as in JAX): the batch is split over the data axis, the
teacher runs on each row's device (a copy per device, kept), and the
student is placed and updated as the train step does
(train_step.MeshRun). The batch normalisers (the teacher weights' sum,
the row count for classify, the ground-truth loss's denominator) are
summed over the rows before any backward, so every shard takes its share
of the whole batch's loss.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device, to_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.precision import precision_scope
from xrseg_tpu_torch.train.losses import (classification_loss,
                                          detection_loss)
from xrseg_tpu_torch.parallel.mesh import Mesh
from xrseg_tpu_torch.train.train_step import (MeshRun, Optimizer,
                                              TrainState)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    temperature: float = 2.0   # KL temperature (cls + box), loss x T^2
    cls_weight: float = 1.0    # class-response KL weight
    box_weight: float = 1.0    # DFL-distribution KL weight
    fg_power: float = 1.0      # anchor weight = (teacher max prob)^p
    det_weight: float = 0.0    # ground-truth loss mix (0 = pure distillation)


def _binary_kl(t_logits, s_logits, T: float):
    """Per-element KL( sigmoid(t/T) || sigmoid(s/T) ) * T^2 in logit space:
    p(log p - log q) + (1-p)(log(1-p) - log(1-q))."""
    t, s = t_logits / T, s_logits / T
    p = torch.sigmoid(t)
    log_p, log_1p = F.logsigmoid(t), F.logsigmoid(-t)
    log_q, log_1q = F.logsigmoid(s), F.logsigmoid(-s)
    return (p * (log_p - log_q) + (1.0 - p) * (log_1p - log_1q)) * T * T


def _dfl_kl(t_box, s_box, reg_max: int, T: float):
    """KL between DFL bin distributions per anchor (mean over the 4 box
    sides): inputs [B,A,4*reg_max] raw logits -> [B,A]."""
    B, A, _ = t_box.shape
    t = t_box.reshape(B, A, 4, reg_max) / T
    s = s_box.reshape(B, A, 4, reg_max) / T
    p = t.softmax(-1)
    kl = (p * (t.log_softmax(-1) - s.log_softmax(-1))).sum(-1)
    return kl.mean(-1) * T * T


def teacher_weights(teacher_out: Dict[str, torch.Tensor],
                    dcfg: DistillConfig) -> torch.Tensor:
    """The anchor weights [B, A] before normalisation: the teacher's max
    class probability ^ fg_power (foreground focus: anchors the teacher
    believes in dominate the loss)."""
    return torch.sigmoid(teacher_out["cls_logits"].float()).amax(-1) \
        ** dcfg.fg_power


def distill_loss(student_out: Dict[str, torch.Tensor],
                 teacher_out: Dict[str, torch.Tensor],
                 dcfg: DistillConfig, reg_max: int,
                 w_total: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detect-family response distillation on forward_train outputs (raw
    logits); the teacher's carry no gradient. w_total: the whole batch's
    teacher-weight sum when these rows are a shard of it."""
    t_cls = teacher_out["cls_logits"].float()
    s_cls = student_out["cls_logits"].float()
    t_box = teacher_out["box_logits"].float()
    s_box = student_out["box_logits"].float()

    w = teacher_weights(teacher_out, dcfg)                     # [B, A]
    w = w / ((w.sum() if w_total is None else w_total) + 1e-9)

    cls_kl = _binary_kl(t_cls, s_cls, dcfg.temperature).sum(-1)
    box_kl = _dfl_kl(t_box, s_box, reg_max, dcfg.temperature)
    l_cls = (w * cls_kl).sum()
    l_box = (w * box_kl).sum()
    loss = dcfg.cls_weight * l_cls + dcfg.box_weight * l_box
    # argmax takes the first maximum, as jnp.argmax
    agree = (w * (s_cls.argmax(-1) == t_cls.argmax(-1))).sum()
    return loss, {"distill_cls": l_cls, "distill_box": l_box,
                  "teacher_agreement": agree}


def distill_loss_classify(student_logits: torch.Tensor,
                          teacher_logits: torch.Tensor, dcfg: DistillConfig,
                          rows: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax KL at temperature T (Hinton's formulation). rows: the whole
    batch's row count when these rows are a shard of it."""
    T = dcfg.temperature
    t = teacher_logits.float() / T
    s = student_logits.float() / T
    p = t.softmax(-1)
    kl = (p * (t.log_softmax(-1) - s.log_softmax(-1))).sum(-1)
    hit = (s.argmax(-1) == t.argmax(-1)).float()
    if rows is None:
        kl, agree = kl.mean(), hit.mean()
    else:
        kl, agree = kl.sum() / rows, hit.sum() / rows
    loss = dcfg.cls_weight * kl * T * T
    return loss, {"distill_cls": loss, "teacher_agreement": agree}


class DistillStep:
    """step(state, teacher_model, batch) -> (state, metrics): one update of
    the student `state` in place. metrics holds 0-dim tensors on the
    device: loss, the distillation terms (and gt_* in mixed mode) and
    grad_norm (before clipping). The teacher is a YOLO11 on the step's
    device."""

    def __init__(self, student_cfg: ModelConfig, optimizer: Optimizer,
                 dcfg: DistillConfig, use_remat: bool, device: torch.device):
        self.scfg, self.optimizer, self.dcfg = student_cfg, optimizer, dcfg
        self.use_remat, self.device = use_remat, device
        self.classify = student_cfg.task == "classify"

    def loss_fn(self, model: yolo11.YOLO11, batch: Dict[str, torch.Tensor],
                t_out: Dict[str, torch.Tensor],
                norms: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """norms (a shard of a larger batch): the whole batch's "teacher"
        normaliser (the teacher weights' sum, or the row count for
        classify) and "gt" denominator (losses.batch_denominator)."""
        cfg, dcfg = self.scfg, self.dcfg
        norms = norms or {}
        images = batch["images"]
        if self.use_remat:
            # keep only the input; the backward runs the forward again
            out = checkpoint(model.forward_train, images,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = model.forward_train(images)
        if self.classify:
            loss, aux = distill_loss_classify(out["logits"],
                                              t_out["logits"], dcfg,
                                              norms.get("teacher"))
            if dcfg.det_weight > 0.0:
                ce, ce_aux = classification_loss(
                    out["logits"], batch["labels"],
                    batch_denom=norms.get("gt"))
                loss = loss + dcfg.det_weight * ce
                aux = {**aux, **{f"gt_{k}": v for k, v in ce_aux.items()}}
            return loss, aux
        loss, aux = distill_loss(out, t_out, dcfg, cfg.reg_max,
                                 norms.get("teacher"))
        if dcfg.det_weight > 0.0:
            tgt = {k: batch[k] for k in ("boxes_xywh", "boxes_xywhr",
                                         "kpts", "labels", "sample_weight")
                   if k in batch}
            if "masks" in batch and cfg.task == "segment":
                tgt["masks"] = batch["masks"]
            det, det_aux = detection_loss(
                out, tgt, cfg,
                input_hw=tuple(int(d) for d in images.shape[1:3]),
                batch_denom=norms.get("gt"))
            loss = loss + dcfg.det_weight * det
            aux = {**aux, **{f"gt_{k}": v for k, v in det_aux.items()}}
        return loss, aux

    def compute_grads(self, model: yolo11.YOLO11, teacher: yolo11.YOLO11,
                      batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss and aux (detached) with every student parameter's .grad set
        to the batch's gradient."""
        with torch.no_grad():
            # forward_train enters the teacher's own precision scope
            t_out = teacher.forward_train(batch["images"])
        with precision_scope(self.scfg.matmul_precision):
            model.zero_grad(set_to_none=True)
            loss, aux = self.loss_fn(model, batch, t_out)
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def __call__(self, state: TrainState, teacher_model: yolo11.YOLO11,
                 batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {k: to_device(v, self.device) for k, v in batch.items()}
        loss, aux = self.compute_grads(state.params, teacher_model, batch)
        grad_norm = self.optimizer.update(state.params, state.opt_state)
        state.step += 1
        return state, {"loss": loss, **aux, "grad_norm": grad_norm}


class MeshDistillStep(DistillStep):
    """The distillation step over a mesh (module docstring)."""

    def __init__(self, student_cfg: ModelConfig, optimizer: Optimizer,
                 dcfg: DistillConfig, use_remat: bool, run: MeshRun):
        super().__init__(student_cfg, optimizer, dcfg, use_remat, run.first)
        self.run = run
        self._teachers: Dict[tuple, yolo11.YOLO11] = {}

    def _teacher_on(self, teacher: yolo11.YOLO11,
                    dev: torch.device) -> yolo11.YOLO11:
        """The teacher on `dev`: itself there, else a copy made once."""
        dev = torch.empty(0, device=dev).device        # "cuda" -> "cuda:0"
        if next(teacher.parameters()).device == dev:
            return teacher
        key = (id(teacher), str(dev))
        if key not in self._teachers:
            self._teachers[key] = copy.deepcopy(teacher).to(dev)
        return self._teachers[key]

    def __call__(self, state: TrainState, teacher_model: yolo11.YOLO11,
                 batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        run = self.run
        state = run.placed(state)
        p = state.placement
        parts = run.shards(batch)
        t_outs = {}
        with torch.no_grad():
            for i, part in enumerate(parts):
                if part is not None:
                    t_outs[i] = self._teacher_on(
                        teacher_model, p.row_devices[i]).forward_train(
                            part["images"])
        norms = {"teacher": run.global_sum(
            [torch.tensor(float(len(parts[i]["images"]))) for i in t_outs]
            if self.classify else
            [teacher_weights(t, self.dcfg).sum() for t in t_outs.values()])}
        if self.dcfg.det_weight > 0.0:
            norms["gt"] = run.denominator(parts, self.scfg.task)
        with precision_scope(self.scfg.matmul_precision):
            run.begin(state)
            loss, aux = run.backward_rows(p, parts, lambda i, part: (
                self.loss_fn(p.rows[i], part, t_outs[i],
                             {k: v.to(p.row_devices[i])
                              for k, v in norms.items()})))
        loss, aux = run.metrics([loss], [aux])
        grad_norm = run.finish(state, self.optimizer, 1)
        state.step += 1
        return state, {"loss": loss, **aux, "grad_norm": grad_norm}


def make_distill_step(student_cfg: ModelConfig, teacher_cfg: ModelConfig,
                      optimizer: Optimizer,
                      dcfg: DistillConfig = DistillConfig(),
                      mesh: Optional[Mesh] = None,
                      use_remat: bool = True, device="cuda") -> DistillStep:
    """The distillation step on `device`, or over `mesh` (DP: the batch
    split over the data axis, the teacher on every row's device; module
    docstring).

    batch needs "images" (f32 [B,H,W,3] in [0,1]); ground-truth keys (the
    train step's contract) only when dcfg.det_weight > 0. Teacher and
    student must agree on the class count (and reg_max for the detect
    family); arch and scale are free."""
    if teacher_cfg.num_classes != student_cfg.num_classes:
        raise ValueError(
            f"teacher/student class-count mismatch: "
            f"{teacher_cfg.num_classes} vs {student_cfg.num_classes}")
    if (student_cfg.task == "classify") != (teacher_cfg.task == "classify"):
        raise ValueError("classify students need classify teachers")
    if student_cfg.task != "classify" \
            and teacher_cfg.reg_max != student_cfg.reg_max:
        raise ValueError(
            f"teacher/student reg_max mismatch: {teacher_cfg.reg_max} vs "
            f"{student_cfg.reg_max} (the DFL KL needs matching bins)")
    if dcfg.det_weight < 0:
        raise ValueError("det_weight must be >= 0")
    if mesh is not None:
        return MeshDistillStep(student_cfg, optimizer, dcfg, use_remat,
                               MeshRun(mesh, 100000, False, 65536))
    return DistillStep(student_cfg, optimizer, dcfg, use_remat,
                       resolve_device(device))
