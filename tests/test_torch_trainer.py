"""The port's Trainer (xrseg_tpu_torch/train/trainer.py), its TensorBoard
writer and its memory preflight, with device="cpu", held to what
tests/test_trainer.py and tests/test_task_trainer.py hold the JAX
package's Trainer to, and against the JAX package where both compute the
same thing:

- fit, then evaluate, then resume: history, the checkpoint files
  (state.pt, ema.npz, history.json), the EMA, the validation pipeline's
  own copy of the weights, and the LR horizon on resume;
- 2 epochs equal 1 epoch plus a resumed 1, bit for bit;
- best.npz read back by the port's load_params_auto and the JAX
  package's load_npz; close_mosaic; the task trainers (pose with its flip
  permutation, obb, classify with resume);
- TensorBoard events read back by the JAX package's read_events, equal
  to the port's reader's apart from wall_time, and the same scalars
  written by both writers read back equal apart from wall_time;
- auto_grad_accum makes the JAX package's choice, with its log lines,
  under one stubbed estimator; an estimator that cannot run (the CPU)
  never stops a run;
- refusals: a mesh, fsdp, and device="cuda" without a card.
"""
import json
import os

import numpy as np
import pytest
import torch

from xrseg_tpu.io import weights as jweights
from xrseg_tpu.train import preflight as jpf
from xrseg_tpu.train import tb as jtb
from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.weights import load_params_auto, params_to_tree
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import data as D
from xrseg_tpu_torch.train import preflight as pf
from xrseg_tpu_torch.train import tb as ttb
from xrseg_tpu_torch.train import trainer as trainer_mod
from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

limit_cpu_threads()

NO_AUG = D.AugmentConfig(mosaic=0.0, hsv=False, scale=0.0, translate=0.0)
CFG64 = ModelConfig(scale="n", input_size=(64, 64), dtype="float32")


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_trainer_fit_evaluate_resume(tmp_path):
    ds = D.SyntheticShapesDataset(n=8, hw=(64, 64))
    tcfg = TrainConfig(epochs=1, batch=4, max_gt=4, lr=1e-3,
                       warmup_steps=2, log_every=1, ckpt_dir=str(tmp_path),
                       use_remat=False, aug=NO_AUG, val_max_images=4,
                       tb_dir="auto")
    tr = Trainer(CFG64, tcfg, device="cpu")
    hist = tr.fit(ds, val_dataset=ds, verbose=False)
    assert len(hist) == 1
    row = hist[0]
    assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
    assert {"box", "cls", "dfl", "seg", "val_box_mAP"} <= set(row)

    # TensorBoard: the JAX package's reader reads the port's file, and
    # agrees with the port's reader apart from wall_time
    tb_files = os.listdir(tmp_path / "tb")
    assert len(tb_files) == 1
    path = str(tmp_path / "tb" / tb_files[0])
    events = list(jtb.read_events(path))
    mine = list(ttb.read_events(path))
    assert [{k: v for k, v in e.items() if k != "wall_time"}
            for e in events] == [{k: v for k, v in e.items()
                                  if k != "wall_time"} for e in mine]
    step_rows = [e for e in events if "train/loss" in e["scalars"]]
    assert [e["step"] for e in step_rows] == [1, 2]
    epoch_rows = [e for e in events if "epoch/loss" in e["scalars"]]
    assert len(epoch_rows) == 1
    assert epoch_rows[0]["scalars"]["epoch/loss"] == pytest.approx(
        row["loss"], rel=1e-6)
    assert "epoch/val_box_mAP" in epoch_rows[0]["scalars"]

    for name in ("state.pt", "ema.npz", "history.json", "best.npz"):
        assert os.path.exists(tmp_path / name), name
    with open(tmp_path / "history.json") as f:
        assert len(json.load(f)) == 1

    m = tr.evaluate(ds, max_images=4, batch=2)
    assert 0.0 <= m["val_box_mAP"] <= 1.0 and "val_box_AP50" in m
    # the pipeline holds its own copy of the EMA weights
    val = tr._val_pipe.params
    assert val is tr._val_model and val is not tr.ema_params
    own = {p.data_ptr() for p in val.parameters()}
    assert not own & {p.data_ptr() for p in tr.state.params.parameters()}
    assert not own & {p.data_ptr() for p in tr.ema_params.parameters()}
    assert _params_equal(val, tr.ema_params)

    # EMA tracked, differs from the raw params after steps
    assert not torch.equal(tr.ema_params.b0.weight, tr.state.params.b0.weight)

    # resume: a fresh Trainer picks up state, history and EMA
    tr2 = Trainer(CFG64, tcfg, device="cpu")
    tr2.fit(ds, resume=True, epochs=0, verbose=False)
    assert len(tr2.history) == 1
    assert tr2.state.step == tr.state.step == 2
    assert tr2.state.opt_state["count"] == 2
    assert _params_equal(tr2.state.params, tr.state.params)
    assert _params_equal(tr2.ema_params, tr.ema_params)


def test_two_epochs_equal_one_plus_resume(tmp_path):
    """The resumed run sees the same batches, LR horizon, optimizer
    moments and EMA, so it ends bit for bit where the straight run does."""
    ds = D.SyntheticShapesDataset(n=6, hw=(48, 64))
    cfg = ModelConfig(scale="n", input_size=(64, 64), dtype="float32",
                      num_classes=3)
    kw = dict(batch=3, max_gt=4, lr=2e-3, warmup_steps=2, log_every=0,
              use_remat=True, aug=D.AugmentConfig(mixup=0.3))
    straight = Trainer(cfg, TrainConfig(epochs=2, ckpt_dir=str(
        tmp_path / "a"), **kw), device="cpu")
    straight.fit(ds, verbose=False)
    part = TrainConfig(epochs=1, ckpt_dir=str(tmp_path / "b"), **kw)
    Trainer(cfg, part, device="cpu").fit(ds, verbose=False)
    resumed = Trainer(cfg, part, device="cpu")
    resumed.fit(ds, resume=True, verbose=False)
    assert resumed.state.step == straight.state.step == 4
    assert _params_equal(resumed.state.params, straight.state.params)
    assert _params_equal(resumed.ema_params, straight.ema_params)
    for a, b in zip(straight.history, resumed.history):
        assert {k: v for k, v in a.items() if k != "sec"} == \
            {k: v for k, v in b.items() if k != "sec"}


def test_best_checkpoint_reloads(tmp_path):
    """best.npz (+best.json) is written on the first validated epoch, and
    both packages' loaders read it as the EMA weights."""
    cfg = ModelConfig(scale="n", input_size=(32, 32), dtype="float32",
                      num_classes=3)
    ds = D.SyntheticShapesDataset(n=8, hw=(32, 32))
    tcfg = TrainConfig(epochs=1, batch=4, max_gt=4, warmup_steps=2,
                       log_every=0, ckpt_dir=str(tmp_path), use_remat=False,
                       val_max_images=4, aug=NO_AUG)
    tr = Trainer(cfg, tcfg, device="cpu")
    tr.fit(ds, val_dataset=ds, verbose=False)
    with open(tmp_path / "best.json") as f:
        assert "val_box_mAP" in json.load(f)
    model, _ = load_params_auto(str(tmp_path / "best.npz"), cfg)
    assert _params_equal(model, tr.ema_params)
    jtree = jweights.load_npz(str(tmp_path / "best.npz"))
    mine = params_to_tree(tr.ema_params)
    flat_j = jweights.flatten_params(jtree)
    flat_t = jweights.flatten_params(mine)
    assert set(flat_j) == set(flat_t)
    assert all(np.array_equal(flat_j[k], flat_t[k]) for k in flat_j)


def test_resume_schedule_horizon_extends(tmp_path, monkeypatch):
    """On resume the LR schedule's horizon covers the prior epochs plus
    the new call's."""
    captured = []
    real_make = trainer_mod.ts.make_optimizer

    def spy(lr=1e-3, weight_decay=5e-4, warmup_steps=100, total_steps=1000):
        captured.append(total_steps)
        return real_make(lr, weight_decay, warmup_steps, total_steps)

    monkeypatch.setattr(trainer_mod.ts, "make_optimizer", spy)
    ds = D.SyntheticShapesDataset(n=8, hw=(64, 64))
    tcfg = TrainConfig(epochs=1, batch=4, max_gt=4, warmup_steps=1,
                       log_every=0, ckpt_dir=str(tmp_path), use_remat=False,
                       ema_decay=0.0, aug=NO_AUG)
    Trainer(CFG64, tcfg, device="cpu").fit(ds, verbose=False)
    assert captured[-1] == 2
    tr2 = Trainer(CFG64, tcfg, device="cpu")
    tr2.fit(ds, resume=True, epochs=1, verbose=False)
    assert captured[-1] == 4
    assert len(tr2.history) == 2
    assert tr2.optimizer.schedule(2) == real_make(
        1e-3, 5e-4, 1, 4).schedule(2)


def test_close_mosaic_final_epochs(monkeypatch):
    """close_mosaic=N: the last N epochs train through the un-collaged
    loader: no mosaic4 call in the final epoch."""
    calls_by_epoch = {}
    current_epoch = [0]
    real_mosaic4 = D.mosaic4

    def counting_mosaic4(*a, **k):
        e = current_epoch[0]
        calls_by_epoch[e] = calls_by_epoch.get(e, 0) + 1
        return real_mosaic4(*a, **k)

    monkeypatch.setattr(D, "mosaic4", counting_mosaic4)

    class EpochMarkingLoader(D.Loader):
        def _host_batches(self, epoch):
            current_epoch[0] = epoch
            return super()._host_batches(epoch)

    monkeypatch.setattr(D, "Loader", EpochMarkingLoader)
    ds = D.SyntheticShapesDataset(n=4, hw=(64, 64))
    tcfg = TrainConfig(epochs=2, batch=2, max_gt=4, lr=1e-3,
                       warmup_steps=1, log_every=0, use_remat=False,
                       ema_decay=0.0, close_mosaic=1,
                       aug=D.AugmentConfig(mosaic=1.0, hsv=False, scale=0.0,
                                           translate=0.0, hflip=0.0))
    hist = Trainer(CFG64, tcfg, device="cpu").fit(ds, verbose=False)
    assert len(hist) == 2
    assert calls_by_epoch.get(0, 0) > 0
    assert calls_by_epoch.get(1, 0) == 0


TASKS = {
    "pose": (ModelConfig(scale="n", input_size=(64, 64), dtype="float32",
                         task="pose", kpt_shape=(5, 3), num_classes=2),
             D.SyntheticPoseDataset(n=4, hw=(64, 64), max_objects=1),
             "val_oks_mAP"),
    "obb": (ModelConfig(scale="n", input_size=(64, 64), dtype="float32",
                        task="obb", num_classes=2),
            D.SyntheticOBBDataset(n=4, hw=(64, 64), max_objects=1),
            "val_rbox_mAP"),
    "classify": (ModelConfig(scale="n", input_size=(32, 32),
                             dtype="float32", task="classify",
                             num_classes=3),
                 D.SyntheticClassifyDataset(n=8, hw=(32, 32)),
                 "val_top1_acc"),
}


@pytest.mark.parametrize("task", list(TASKS))
def test_task_trainer_fit_with_validation(task, tmp_path):
    cfg, ds, metric = TASKS[task]
    tcfg = TrainConfig(epochs=2 if task == "classify" else 1, batch=4,
                       max_gt=4, lr=2e-3, warmup_steps=2, log_every=0,
                       use_remat=False, aug=NO_AUG, val_max_images=4,
                       ckpt_dir=str(tmp_path),
                       kpt_flip_idx=(0, 4, 3, 2, 1) if task == "pose"
                       else None)
    tr = Trainer(cfg, tcfg, device="cpu")
    hist = tr.fit(ds, val_dataset=ds, verbose=False)
    row = hist[-1]
    assert np.isfinite(row["loss"])
    assert 0.0 <= row[metric] <= 1.0
    assert {"pose": "kpt", "obb": "box", "classify": "acc"}[task] in row
    assert tr.ema_params is not None
    assert os.path.exists(tmp_path / "best.npz")
    if task == "classify":
        assert hist[-1]["loss"] != hist[0]["loss"]
        tr2 = Trainer(cfg, tcfg, device="cpu")
        tr2.fit(ds, resume=True, epochs=0, verbose=False)
        assert tr2.state.step == tr.state.step


def test_tensorboard_writers_agree(tmp_path):
    """The same scalars through both packages' writers read back equal
    (apart from wall_time) by the JAX package's reader."""
    scalars = [({"train/loss": 0.5, "train/box": 1.25}, 3),
               ({"epoch/loss": np.float32(0.25),
                 "epoch/val_box_mAP": torch.tensor(0.125)}, 1)]
    paths = []
    for mod, sub in ((jtb, "jax"), (ttb, "port")):
        w = mod.TBWriter(str(tmp_path / sub))
        for s, step in scalars:
            w.add_scalars(s, step=step)
        w.add_scalar("x/y", 7.0, step=9)
        w.close()
        paths.append(w.path)
    ev = [[{k: v for k, v in e.items() if k != "wall_time"}
           for e in jtb.read_events(p)] for p in paths]
    assert ev[0] == ev[1] and len(ev[0]) == 4
    assert ttb.crc32c(b"123456789") == jtb.crc32c(b"123456789") == \
        0xE3069283


BUDGETS = {"fits": (int(100e9), 1), "split": (int(4e9), 1),
           "none_fits": (int(1e9), 1), "shards": (int(4e9), 4),
           "start_2": (int(100e9), 1)}


@pytest.mark.parametrize("case", list(BUDGETS))
def test_auto_grad_accum_same_choice_as_jax(case, monkeypatch):
    """One stubbed estimator (bytes by grad_accum) in both packages: the
    same grad_accum, estimate and log lines."""
    budget, shards = BUDGETS[case]
    start = 2 if case == "start_2" else 1
    est = {1: int(3e9), 2: int(2e9), 4: int(1.2e9), 8: int(0.9e9)}

    def stub(step, state, sds):
        return est.get(step, int(5e9))

    results = []
    for mod in (jpf, pf):
        monkeypatch.setattr(mod, "estimate_step_bytes", stub)
        logs = []
        got = mod.auto_grad_accum(lambda a: a, None, None, budget, 8,
                                  start=start, data_shards=shards,
                                  log=logs.append)
        results.append((got, logs))
    assert results[0] == results[1]


def test_preflight_that_cannot_measure_never_stops_a_run(capsys):
    """On the CPU the estimator cannot measure: with a budget set the
    trainer logs "preflight: skipped" and trains with its grad_accum."""
    ds = D.SyntheticShapesDataset(n=4, hw=(64, 64))
    tcfg = TrainConfig(epochs=1, batch=4, max_gt=4, warmup_steps=1,
                       log_every=0, use_remat=False, ema_decay=0.0,
                       aug=NO_AUG, preflight=True, hbm_budget=int(250e6))
    hist = Trainer(CFG64, tcfg, device="cpu").fit(ds, verbose=False)
    assert len(hist) == 1 and "loss" in hist[0]
    assert "preflight: skipped" in capsys.readouterr().out
    shapes = pf.batch_shapes(ModelConfig(task="pose", kpt_shape=(5, 3)),
                             8, 16)
    assert shapes["kpts"][0] == (8, 16, 5, 3)


@pytest.mark.parametrize("case", ["mesh", "fsdp", "cuda"])
def test_trainer_refusals(case, monkeypatch):
    """JAX's refusals: a batch the mesh's data axis does not divide, fsdp
    without a mesh (at fit, when the step is built); a card that is not
    there raises."""
    if case == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(CFG64)
        return
    from xrseg_tpu_torch.parallel.mesh import make_mesh
    ds = D.SyntheticShapesDataset(n=4, hw=(64, 64))
    tcfg = TrainConfig(epochs=1, batch=3, max_gt=4, log_every=0,
                       ema_decay=0.0, fsdp=case == "fsdp",
                       aug=D.AugmentConfig(mosaic=0.0))
    if case == "mesh":
        mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
        with pytest.raises(ValueError, match="divisible"):
            Trainer(CFG64, tcfg, mesh=mesh).fit(ds, verbose=False)
    else:
        with pytest.raises(ValueError, match="requires a mesh"):
            Trainer(CFG64, tcfg, device="cpu").fit(ds, verbose=False)


def test_train_config_fields_and_defaults_match_jax():
    import dataclasses

    from xrseg_tpu.train import data as jdata
    from xrseg_tpu.train.trainer import TrainConfig as JTrainConfig

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    mine, theirs = fields(TrainConfig), fields(JTrainConfig)
    assert set(mine) == set(theirs)
    for k in mine:
        if k == "aug":
            assert fields(D.AugmentConfig) == fields(jdata.AugmentConfig)
        else:
            assert mine[k] == theirs[k], k
