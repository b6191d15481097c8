"""The training loop: Trainer.fit() over the data pipeline (counterpart of
xrseg_tpu/train/trainer.py), single device.

  data.Loader -> train_step.make_train_step -> per-epoch metrics ->
  optional validation mAP through the deployed pipeline (compile.
  build_pipeline + eval/dataset_eval; on the card its NMS is K1, or K3 for
  obb) -> checkpoints with resume.

  - the EMA of the weights is a real copy of the model, updated under
    no_grad after each step with JAX's ramp d * (1 - exp(-(step+1)/2000))
    evaluated at the step count after the update; validation and `best`
    use it;
  - the validation pipeline is built once and holds its OWN copy of the
    EMA weights (build_pipeline binds the module it is given), refreshed
    in place before each evaluation; it never aliases the trained module;
  - checkpoints: <ckpt_dir>/state.pt (train_step.save_train_state), the
    EMA and best weights as ema.npz and best.npz (io/weights.save_npz: the
    JAX package's npz layout, so load_params_auto, the server's /reload and
    JAX's load_npz read them as they are), history.json and best.json.
    (JAX writes orbax directories; orbax is on neither machine the port
    runs on.)
  - over a mesh (Trainer(mesh=)): the Loader yields batches split over the
    data axis, the state is placed after init and resume
    (train_step.shard_train_state: DP, TP from tp_min_channels, or FSDP
    from TrainConfig.fsdp), the preflight measures one shard's
    microbatch, and the EMA, the checkpoints, ema.npz, best.npz and
    validation read the gathered weights (train_step.gathered_params);
    validation runs on the mesh's first device.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.train import data as data_lib
from xrseg_tpu_torch.train import train_step as ts


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 10
    batch: int = 16
    lr: float = 1e-3
    weight_decay: float = 5e-4
    warmup_steps: int = 100
    max_gt: int = 16
    seed: int = 0
    aug: data_lib.AugmentConfig = data_lib.AugmentConfig()
    tp_min_channels: int = 100000      # TP off by default (DP only)
    # FSDP/ZeRO-3: params and optimizer moments sharded over the mesh's
    # data axis (train_step.make_train_step). Requires a mesh; one
    # process only.
    fsdp: bool = False
    # split each batch into A sequential microbatches (grads averaged
    # before the one optimizer update): a large effective batch without
    # the full batch's activation memory
    grad_accum: int = 1
    # device-memory preflight (train/preflight.py): measure the step's
    # peak on the card before training and raise grad_accum with a logged
    # line instead of running out of memory. Skipped on the CPU unless
    # hbm_budget is set (and then it cannot measure and logs "skipped").
    preflight: bool = True
    hbm_budget: Optional[int] = None
    use_remat: bool = True
    log_every: int = 10
    ckpt_dir: Optional[str] = None     # directory for checkpoints + history
    ckpt_every_epochs: int = 1
    # TensorBoard scalars (train/tb.py): per-step metrics at log_every
    # cadence + the full per-epoch history row. None = off; "auto" =
    # <ckpt_dir>/tb when ckpt_dir is set.
    tb_dir: Optional[str] = None
    # validation postprocess: low score gate + high cap, the standard mAP
    # evaluation setting
    val_score_threshold: float = 0.05
    val_max_detections: int = 50
    val_max_images: int = 64
    # exponential moving average of params (the YOLO-family eval/deploy
    # weights); 0 disables. Validation and `best` use the EMA.
    ema_decay: float = 0.9995
    # multi-scale training: tuple of (H,W) buckets (multiples of 32).
    # None = fixed cfg size.
    scales: Optional[tuple] = None
    # keep a `best` copy of the eval (EMA) params whenever validation
    # improves (val_mask_mAP for segment when present, else val_box_mAP;
    # tasks: val_oks_mAP / val_rbox_mAP / val_top1_acc)
    save_best: bool = True
    # pose: keypoint left/right permutation applied on hflip augmentation
    kpt_flip_idx: Optional[tuple] = None
    # disable mosaic/mixup for the LAST N epochs (ultralytics
    # close_mosaic). 0 = off.
    close_mosaic: int = 0
    # classify-task CE label smoothing
    label_smoothing: float = 0.0


class Trainer:
    """fit()/evaluate() around the train step, on `device` ("cuda" unless
    the caller asks for the CPU; without a card it raises), or over `mesh`
    (its devices stand for `device`). `params`: an optional YOLO11 to start
    from (copied; the caller's module is not trained in place)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                 mesh=None, params=None, device="cuda"):
        self.mesh = mesh
        self.device = (mesh.first_device if mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.tcfg = tcfg
        self.optimizer: Optional[ts.Optimizer] = None   # built in fit
        self.state: Optional[ts.TrainState] = None
        self._init_params = params
        self.history: List[Dict] = []
        self.ema_params = None         # EMA copy of the model
        self._val_pipe = None          # cached validation pipeline
        self._val_model = None         # the pipeline's own weights
        self.preflight_bytes: Optional[int] = None   # the estimate, if run

    # -- state ----------------------------------------------------------

    def _ckpt_path(self) -> Optional[str]:
        if self.tcfg.ckpt_dir is None:
            return None
        return os.path.join(self.tcfg.ckpt_dir, "state.pt")

    def _load_history(self) -> None:
        if self.tcfg.ckpt_dir is None or self.history:
            return
        hist = os.path.join(self.tcfg.ckpt_dir, "history.json")
        if os.path.exists(hist):
            with open(hist) as f:
                self.history = json.load(f)

    def _init_state(self, total_steps: int, resume: bool) -> None:
        from xrseg_tpu_torch.io.weights import load_npz

        t = self.tcfg
        self.optimizer = ts.make_optimizer(
            t.lr, t.weight_decay, t.warmup_steps,
            total_steps=max(total_steps, t.warmup_steps + 1))
        if self._init_params is not None:
            # a copy that trains, whatever the source: another Trainer's
            # eval_params (its EMA) are frozen
            model = copy.deepcopy(self._init_params).to(
                self.device).requires_grad_(True)
            state = ts.TrainState(params=model,
                                  opt_state=self.optimizer.init(model),
                                  step=0)
        else:
            state = ts.init_train_state(
                torch.Generator().manual_seed(t.seed), self.cfg,
                self.optimizer, device=self.device)
        path = self._ckpt_path()
        if resume and path and os.path.exists(path):
            state = ts.load_train_state(path, state)
            self._load_history()
        if self.mesh is not None:
            state = ts.shard_train_state(state, self.mesh,
                                         t.tp_min_channels, fsdp=t.fsdp)
        self.state = state
        if t.ema_decay > 0:
            ema_path = (os.path.join(t.ckpt_dir, "ema.npz")
                        if t.ckpt_dir else None)
            if resume and ema_path and os.path.exists(ema_path):
                ema = load_npz(ema_path, self.cfg)
            else:
                ema = copy.deepcopy(ts.gathered_params(state))
            self.ema_params = ema.to(self.device).requires_grad_(False)

    @torch.no_grad()
    def _ema_update(self) -> None:
        """ema = ema * dd + params * (1 - dd), dd = d * (1 -
        exp(-(step + 1) / 2000)) in float32 at the step count after the
        update (ultralytics' ramp: early EMA tracks the fresh weights)."""
        f32 = np.float32
        dd = f32(self.tcfg.ema_decay) * (f32(1) - np.exp(
            -(f32(self.state.step) + f32(1)) / f32(2000)))
        ema = list(self.ema_params.parameters())
        torch._foreach_mul_(ema, float(dd))
        torch._foreach_add_(ema, torch._foreach_mul(
            ts.full_parameters(self.state), float(f32(1) - dd)))

    def save(self) -> Optional[str]:
        from xrseg_tpu_torch.io.weights import save_npz

        path = self._ckpt_path()
        if path is None or self.state is None:
            return None
        os.makedirs(self.tcfg.ckpt_dir, exist_ok=True)
        ts.save_train_state(path, self.state)
        if self.ema_params is not None:
            save_npz(os.path.join(self.tcfg.ckpt_dir, "ema.npz"),
                     self.ema_params)
        with open(os.path.join(self.tcfg.ckpt_dir, "history.json"),
                  "w") as f:
            json.dump(self.history, f, indent=1)
        return path

    @property
    def params(self):
        """The trained model with its full weights (under FSDP a gathered
        copy)."""
        if self.state is None:
            raise RuntimeError("fit() or _init_state() first")
        return ts.gathered_params(self.state)

    @property
    def eval_params(self):
        """What you validate/deploy: the EMA weights when enabled."""
        return self.ema_params if self.ema_params is not None else self.params

    # -- training -------------------------------------------------------

    def _preflight(self, build_step, verbose: bool) -> int:
        """grad_accum from the memory preflight; the configured one when it
        is off or cannot run (the estimator must never kill a run)."""
        t = self.tcfg
        if not t.preflight:
            return t.grad_accum
        try:
            from xrseg_tpu_torch.train import preflight as pf
            budget = t.hbm_budget or pf.hbm_budget_bytes(self.device)
            if not budget:
                return t.grad_accum
            # estimate at the LARGEST configured shape (multi-scale: the
            # biggest bucket dominates the peak); over a mesh, one data
            # shard's batch on its device
            shards = self.mesh.shape["data"] if self.mesh else 1
            hw = max(t.scales) if t.scales else self.cfg.input_size
            sds = pf.batch_shapes(self.cfg, t.batch // shards, t.max_gt,
                                  input_hw=hw)
            grad_accum, est = pf.auto_grad_accum(
                build_step, self.state, sds, budget, t.batch,
                start=t.grad_accum, data_shards=shards)
            self.preflight_bytes = est
            if verbose:
                print(f"preflight: estimated step peak {est/1e9:.2f} GB "
                      f"(budget {budget/1e9:.2f} GB, grad_accum="
                      f"{grad_accum})", flush=True)
            return grad_accum
        except Exception as e:  # estimator must never kill a run
            print(f"preflight: skipped ({type(e).__name__}: {e})",
                  flush=True)
            return t.grad_accum

    def fit(self, dataset, val_dataset=None, resume: bool = False,
            epochs: Optional[int] = None, verbose: bool = True
            ) -> List[Dict]:
        """Train for `epochs` over `dataset`; returns per-epoch history
        [{epoch, loss, box, cls, dfl, seg?, grad_norm, sec,
          val_box_mAP?, val_mask_mAP?}, ...]."""
        t = self.tcfg
        epochs = t.epochs if epochs is None else epochs
        loader = data_lib.Loader(dataset, self.cfg, t.batch,
                                 max_gt=t.max_gt, aug=t.aug, seed=t.seed,
                                 mesh=self.mesh, scales=t.scales,
                                 kpt_flip_idx=t.kpt_flip_idx,
                                 device=self.device)
        closed_loader = None
        if t.close_mosaic > 0 and (t.aug.mosaic > 0 or t.aug.mixup > 0):
            # ultralytics' close_mosaic: the final N epochs train on
            # un-collaged images. Same seed => identical shuffle order;
            # only the augmentation recipe differs.
            closed_aug = dataclasses.replace(t.aug, mosaic=0.0, mixup=0.0)
            closed_loader = data_lib.Loader(
                dataset, self.cfg, t.batch, max_gt=t.max_gt,
                aug=closed_aug, seed=t.seed, mesh=self.mesh,
                scales=t.scales, kpt_flip_idx=t.kpt_flip_idx,
                device=self.device)
        steps_per_epoch = loader.steps_per_epoch()
        if self.state is None:
            # On resume the restored step continues from the prior run, so
            # the LR schedule's horizon covers the epochs already trained
            # PLUS this call's.
            if resume:
                self._load_history()
            self._init_state(steps_per_epoch * (len(self.history) + epochs),
                             resume)

        def build_step(accum: int):
            return ts.make_train_step(self.cfg, self.optimizer,
                                      mesh=self.mesh,
                                      tp_min_channels=t.tp_min_channels,
                                      use_remat=t.use_remat, fsdp=t.fsdp,
                                      grad_accum=accum,
                                      label_smoothing=t.label_smoothing,
                                      device=self.device)

        step_fn = build_step(self._preflight(build_step, verbose))
        tb = None
        tb_dir = t.tb_dir
        if tb_dir == "auto":
            tb_dir = os.path.join(t.ckpt_dir, "tb") if t.ckpt_dir else None
        if tb_dir:
            from xrseg_tpu_torch.train.tb import TBWriter
            tb = TBWriter(tb_dir)
        start_epoch = len(self.history)
        end_epoch = start_epoch + epochs
        try:
            for e in range(start_epoch, end_epoch):
                t0 = time.perf_counter()
                sums: Dict[str, float] = {}
                n = 0
                use_loader = (closed_loader if closed_loader is not None
                              and e >= end_epoch - t.close_mosaic
                              else loader)
                for batch in use_loader.epoch(e):
                    self.state, metrics = step_fn(self.state, batch)
                    if self.ema_params is not None:
                        self._ema_update()
                    # one host copy of every metric (the step's only sync)
                    m = dict(zip(metrics, torch.stack(
                        list(metrics.values())).tolist()))
                    for k, v in m.items():
                        sums[k] = sums.get(k, 0.0) + v
                    n += 1
                    if t.log_every and n % t.log_every == 0:
                        if verbose:
                            print(f"epoch {e} step {n}/{steps_per_epoch} "
                                  f"loss={m['loss']:.4f}", flush=True)
                        if tb is not None:
                            tb.add_scalars(
                                {f"train/{k}": v for k, v in m.items()},
                                step=e * steps_per_epoch + n)
                row = {"epoch": e,
                       **{k: v / max(n, 1) for k, v in sums.items()},
                       "sec": time.perf_counter() - t0}
                if val_dataset is not None:
                    row.update(self.evaluate(val_dataset,
                                             max_images=t.val_max_images))
                    self._maybe_save_best(row)
                self.history.append(row)
                if tb is not None:
                    tb.add_scalars({f"epoch/{k}": v for k, v in row.items()
                                    if k != "epoch"}, step=e)
                if verbose:
                    extras = "".join(
                        f" {k}={row[k]:.4f}"
                        for k in ("val_box_mAP", "val_mask_mAP",
                                  "val_oks_mAP", "val_rbox_mAP",
                                  "val_top1_acc") if k in row)
                    print(f"epoch {e}: loss="
                          f"{row.get('loss', float('nan')):.4f}"
                          f" ({row['sec']:.1f}s){extras}", flush=True)
                if t.ckpt_dir and (e + 1) % t.ckpt_every_epochs == 0:
                    self.save()
        finally:
            if tb is not None:
                tb.close()
        return self.history

    def _best_metric(self, row: Dict) -> Optional[float]:
        for k in ("val_mask_mAP", "val_box_mAP", "val_oks_mAP",
                  "val_rbox_mAP", "val_top1_acc"):
            if k in row:
                return float(row[k])
        return None

    def _maybe_save_best(self, row: Dict) -> None:
        """Write ckpt_dir/best.npz (eval/EMA params) when validation
        improves."""
        from xrseg_tpu_torch.io.weights import save_npz

        t = self.tcfg
        if not (t.save_best and t.ckpt_dir):
            return
        m = self._best_metric(row)
        if m is None:
            return
        prev = [self._best_metric(r) for r in self.history]
        prev = [p for p in prev if p is not None]
        if prev and m <= max(prev):
            return
        os.makedirs(t.ckpt_dir, exist_ok=True)
        save_npz(os.path.join(t.ckpt_dir, "best.npz"), self.eval_params)
        with open(os.path.join(t.ckpt_dir, "best.json"), "w") as f:
            json.dump(row, f, indent=1)

    # -- validation -----------------------------------------------------

    def evaluate(self, dataset, max_images: Optional[int] = None,
                 batch: int = 8) -> Dict[str, float]:
        """Validation of the CURRENT (EMA) params through the deployed
        pipeline against the dataset's GT. detect/segment return
        {val_box_mAP, val_box_AP50, val_mask_mAP?}; tasks return their
        family metric (pose {val_oks_mAP, val_oks_AP50}, obb
        {val_rbox_mAP, val_rbox_AP50}, classify {val_top1_acc}).

        The pipeline is built once per Trainer (and batch size) around its
        own copy of the weights, which later calls refresh in place."""
        from xrseg_tpu_torch.compile import build_pipeline
        from xrseg_tpu_torch.config import ExecutorConfig, PostprocessConfig
        from xrseg_tpu_torch.eval.dataset_eval import (evaluate_dataset,
                                                       evaluate_task_dataset)

        t = self.tcfg
        is_task = self.cfg.task in ("pose", "obb", "classify")
        src = self.eval_params
        if (self._val_pipe is not None
                and self._val_pipe.input_shape[0] != batch):
            self._val_pipe = None           # batch changed: rebuild
        if self._val_pipe is None:
            self._val_model = copy.deepcopy(src).requires_grad_(False)
            ex_cfg = ExecutorConfig(
                model=self.cfg,
                post=PostprocessConfig(
                    score_threshold=t.val_score_threshold,
                    max_detections=t.val_max_detections))
            self._val_pipe = build_pipeline(ex_cfg, self._val_model,
                                            crop_masks=not is_task,
                                            frame_hw=self.cfg.input_size,
                                            batch=batch, device=self.device)
        else:
            with torch.no_grad():
                torch._foreach_copy_(list(self._val_model.parameters()),
                                     list(src.parameters()))
        kw = dict(score_threshold=t.val_score_threshold,
                  max_detections=t.val_max_detections,
                  max_images=max_images, batch=batch, pipe=self._val_pipe,
                  device=self.device)
        if is_task:
            m = evaluate_task_dataset(self.cfg, self._val_model, dataset,
                                      **kw)
            return {f"val_{k}": float(v) for k, v in m.items()
                    if k not in ("n_images", "n_gt")}
        m = evaluate_dataset(self.cfg, self._val_model, dataset, **kw)
        out = {"val_box_mAP": m["box_mAP"], "val_box_AP50": m["box_AP50"]}
        if "mask_mAP" in m:
            out["val_mask_mAP"] = m["mask_mAP"]
        return out
