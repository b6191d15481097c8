"""Training over a mesh in the port (xrseg_tpu_torch/train/train_step.py
make_train_step(mesh=), shard_train_state, the Loader's, the Trainer's and
the distill step's mesh) on the CPU, against the JAX package's sharded
step and the port's own unsharded step.

Torch has one CPU device, so the meshes repeat it ([cpu] * n); JAX's side
uses conftest's 8 virtual devices. 64x64 (32x32 for distillation), scale
n, float32 with matmul_precision "highest", tests/torch_parity weights.

- DP+TP on a (4,2) mesh with tp_min_channels=64 against JAX's
  make_train_step(mesh=make_mesh((4,2)), tp_min_channels=64) on the same
  weights and batch (non-uniform sample_weight, a padded row): loss, aux
  terms and grad norm within rtol 1e-4, every param after the step within
  atol 2e-5, rtol 2e-4 (tests/test_train.py's bounds), and the first
  moment (0.1 x the clipped gradient) within 1e-4 of each leaf's max abs.
  The learning rate is 1e-5, as in test_torch_train.py (Adam turns
  float-noise gradients into O(lr) updates). The module's one JAX compile.
- FSDP (8,1) with fsdp_min_size=1024 against the port's DP for 3 steps at
  tests/test_train.py's bounds; the slices' shapes before and after.
- DP with unequal sample_weight, a shard of padding rows only and the
  Loader's padded last batch, segment and classify, against the unsharded
  step; grad_accum=2 on a mesh against the unsharded grad_accum=2 step
  (also from pre-split shards, whose microbatches cross shards), and the
  microbatch divisibility error. These run at lr 1e-5 and hold the
  metrics within rtol 1e-5, the params at tests/test_train.py's bounds and
  the moments within 1e-4 of each leaf's max abs.
- Loader(mesh=) shards feeding the step; Trainer(mesh=, fsdp=True).fit
  with save and resume against an uninterrupted fit; the preflight's one
  shard; the DP distill step against the unsharded one; a checkpoint
  written under FSDP reloading on one device and the reverse.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JCfg
from xrseg_tpu.parallel import mesh as jmesh
from xrseg_tpu.train import train_step as JTS
from xrseg_tpu_torch.config import ModelConfig as TCfg
from xrseg_tpu_torch.io.bridge import params_from_jax, state_dict_from_jax
from xrseg_tpu_torch.parallel.mesh import Sharding, make_mesh, shard_batch
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import data as D
from xrseg_tpu_torch.train import distill as TD
from xrseg_tpu_torch.train import train_step as TTS
from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

CPU = torch.device("cpu")
HW = (64, 64)
EXACT = dict(scale="n", input_size=HW, dtype="float32",
             matmul_precision="highest", num_classes=3)


def _mesh(d, m=1):
    return make_mesh((d, m), devices=[CPU] * (d * m))


def _batch(rng, B, task="segment", sw=None, G=3):
    images = rng.uniform(0, 1, (B,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 3, (B, G)).astype(np.int32)
    labels[-1, -1] = -1
    if task == "classify":
        out = {"images": images,
               "labels": rng.integers(0, 3, (B,)).astype(np.int32)}
        out["labels"][-1] = -1
        return out
    boxes = np.concatenate([rng.uniform(16, 48, (B, G, 2)),
                            rng.uniform(10, 30, (B, G, 2))],
                           -1).astype(np.float32)
    out = {"images": images, "boxes_xywh": boxes, "labels": labels,
           "masks": (rng.uniform(0, 1, (B, G, 16, 16)) > 0.5
                     ).astype(np.float32)}
    if sw is not None:
        out["sample_weight"] = np.asarray(sw, np.float32)
    return out


def _state(model, opt):
    model = copy.deepcopy(model)
    return TTS.TrainState(model, opt.init(model), 0)


def _run(model, opt, batches, mesh=None, **kw):
    """Steps of the port's step from a copy of `model`; the state and the
    metrics as floats."""
    state = _state(model, opt)
    step = TTS.make_train_step(CFG_T if "cfg" not in kw else kw.pop("cfg"),
                               opt, mesh=mesh, device="cpu", **kw)
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _full(state):
    names = [n for n, _ in state.params.named_parameters()]
    return dict(zip(names, (t.detach() for t in
                            TTS.full_parameters(state))))


def _same_metrics(got, want, rtol, what=""):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   err_msg=f"{what} {k}")


def _same_params(a, b, atol=2e-5, rtol=2e-4):
    """Params at tests/test_train.py's bounds, and each moment within 1e-4
    of its leaf's max abs (the moments carry the gradients; the params
    move by about the learning rate a step)."""
    fa, fb = _full(a), _full(b)
    assert set(fa) == set(fb)
    for n in fa:
        np.testing.assert_allclose(fa[n].numpy(), fb[n].numpy(), atol=atol,
                                   rtol=rtol, err_msg=n)
    for key in ("mu", "nu"):
        for n, t in a.opt_state[key].items():
            want = TTS._full(b.opt_state[key][n], CPU).numpy()
            tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
            got = TTS._full(t, CPU).numpy()
            assert float(np.abs(got - want).max()) <= tol, (key, n)


JCFG = JCfg(**EXACT)
CFG_T = TCfg(**EXACT)


# ---------------------------------------------------------------------------
# DP + TP against JAX's sharded step
# ---------------------------------------------------------------------------

def test_dp_tp_step_matches_jax():
    tree = seeded_tree(JCFG, seed=1)
    batch = _batch(np.random.default_rng(2), 4, sw=[1.0, 0.5, 2.0, 0.0])
    jopt = JTS.make_optimizer(1e-5, warmup_steps=0, total_steps=10)
    jmesh_ = jmesh.make_mesh((4, 2))
    params = jax.tree.map(jnp.asarray, tree)
    js = JTS.TrainState(params=params, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    js = JTS.shard_train_state(js, jmesh_, tp_min_channels=64)
    jstep = JTS.make_train_step(JCFG, jopt, mesh=jmesh_, tp_min_channels=64,
                                use_remat=False)
    js, jm = jstep(js, jmesh.shard_batch(batch, jmesh_))
    js, jm = jax.device_get((js, jm))

    topt = TTS.make_optimizer(1e-5, warmup_steps=0, total_steps=10)
    mesh = _mesh(4, 2)
    state = TTS.shard_train_state(
        _state(params_from_jax(tree, CFG_T), topt), mesh,
        tp_min_channels=64)
    # the TP rule split the wide convs: a row's b7 runs as two slices
    assert type(state.placement.rows[0].b7).__name__ == "_TrainSlicedConv"
    step = TTS.make_train_step(CFG_T, topt, mesh=mesh, tp_min_channels=64)
    state, tm = step(state, batch)
    _same_metrics({k: float(v) for k, v in tm.items()},
                  {k: float(v) for k, v in jm.items()}, 1e-4, "TP")
    want = state_dict_from_jax(js.params)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=2e-4, err_msg=name)
    mu = state_dict_from_jax(js.opt_state[1][0].mu)
    for name, m in state.opt_state["mu"].items():
        ref = mu[name].numpy()
        tol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(m.numpy() - ref).max()) <= tol, name


# ---------------------------------------------------------------------------
# FSDP against DP
# ---------------------------------------------------------------------------

def test_fsdp_three_steps_match_dp():
    model = params_from_jax(seeded_tree(JCFG, seed=3), CFG_T)
    opt = TTS.make_optimizer(2e-3, warmup_steps=1, total_steps=50)
    mesh = _mesh(8)
    rng = np.random.default_rng(3)
    batches = [_batch(rng, 8) for _ in range(3)]
    fstate = TTS.shard_train_state(_state(model, opt), mesh, fsdp=True,
                                   fsdp_min_size=1024)

    def slices(state):
        sp = state.placement.split
        b7 = sp["b7.weight"]
        assert b7.shape == (256, 128, 3, 3)
        assert [tuple(p.shape) for p in b7.parts] == [(32, 128, 3, 3)] * 8
        mu = state.opt_state["mu"]["b7.weight"]
        assert isinstance(mu, TTS.Shards) and \
            [tuple(p.shape) for p in mu.parts] == [(32, 128, 3, 3)] * 8
        named = dict(state.params.named_parameters())
        assert named["b7.weight"].numel() == 0       # no full copy left
        assert "b0.bias" not in sp and named["b0.bias"].shape == (16,)
        assert not isinstance(state.opt_state["mu"]["b0.bias"], TTS.Shards)

    slices(fstate)
    rules = TTS.train_state_shardings(CFG_T, opt, mesh, fsdp_min_size=1024)
    assert rules.params["b7.weight"] == Sharding("data", 0)
    assert rules.opt_state["nu"]["b7.weight"] == Sharding("data", 0)
    assert rules.params["b0.bias"] == Sharding()
    assert {n for n, r in rules.params.items() if r.axis} == \
        set(fstate.placement.split)
    fstep = TTS.make_train_step(CFG_T, opt, mesh=mesh, use_remat=False,
                                fsdp=True, fsdp_min_size=1024)
    dstate, dm = _run(model, opt, batches, mesh, use_remat=False)
    for b, want in zip(batches, dm):
        fstate, fm = fstep(fstate, b)
        np.testing.assert_allclose(float(fm["loss"]), want["loss"],
                                   rtol=2e-4)
    slices(fstate)
    _same_params(fstate, dstate)


# ---------------------------------------------------------------------------
# the whole batch's denominator, grad_accum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["segment", "classify"])
def test_dp_with_unequal_weights_and_padding_matches_unsharded(task):
    """Shards whose sample weights (or valid labels) sum differently, then
    a shard of padding rows alone, then the Loader's padded last batch:
    each shard divides by the whole batch's denominator, so DP equals the
    unsharded step. (With one shard all padding, a shard dividing by its
    own weights would give the same numbers: the first batch is the one
    that tells.)"""
    cfg = TCfg(**{**EXACT, "task": task})
    model = params_from_jax(detecting_tree(JCfg(**{**EXACT, "task": task})),
                            cfg)
    opt = TTS.make_optimizer(1e-5, warmup_steps=1, total_steps=50)
    rng = np.random.default_rng(4)
    b = _batch(rng, 4, task, sw=None if task == "classify"
               else [2.0, 0.5, 1.0, 0.0])
    pad = _batch(rng, 4, task, sw=None if task == "classify"
                 else [1.0, 0.5, 0.0, 0.0])
    if task == "classify":
        b["labels"][:] = [0, 1, 2, -1]        # 2 and 1 valid rows
        pad["labels"][2:] = -1                # shard 1: padding rows only
    loader = D.Loader(D.SyntheticShapesDataset(n=6, hw=HW, n_classes=3)
                      if task == "segment" else
                      D.SyntheticClassifyDataset(n=6, hw=HW, n_classes=3),
                      cfg, 4, max_gt=3, drop_last=False,
                      aug=D.AugmentConfig(mosaic=0.0), device="cpu")
    last = list(loader._host_batches(0))[-1]
    assert last["sample_weight"].tolist() == [1, 1, 0, 0]
    batches = [b, pad, last]
    want_s, want = _run(model, opt, batches, cfg=cfg, use_remat=False)
    got_s, got = _run(model, opt, batches, _mesh(2), cfg=cfg,
                      use_remat=False)
    for g, w in zip(got, want):
        _same_metrics(g, w, 1e-5)
    _same_params(got_s, want_s)


def test_grad_accum_on_a_mesh():
    """JAX's microbatches of consecutive rows, each sharded over the data
    axis: equal to the unsharded grad_accum=2 step, from a host batch and
    from pre-split shards (microbatch 0's second row then comes from shard
    0); a microbatch smaller than the data axis raises JAX's error."""
    model = params_from_jax(seeded_tree(JCFG, seed=5), CFG_T)
    opt = TTS.make_optimizer(1e-5, warmup_steps=0, total_steps=50)
    mesh = _mesh(2)
    b = _batch(np.random.default_rng(5), 8, sw=[1, 2, 0.5, 1, 0, 1, 3, 1])
    want_s, want = _run(model, opt, [b], use_remat=False, grad_accum=2)
    for batch in (b, shard_batch(b, mesh)):
        got_s, got = _run(model, opt, [batch], mesh, use_remat=False,
                          grad_accum=2)
        _same_metrics(got[0], want[0], 1e-5)
        _same_params(got_s, want_s)
    with pytest.raises(ValueError, match="must stay divisible by the data"):
        _run(model, opt, [b], _mesh(4), use_remat=False, grad_accum=4)


# ---------------------------------------------------------------------------
# the Loader, the Trainer and the preflight over a mesh
# ---------------------------------------------------------------------------

def test_loader_shards_feed_the_step():
    cfg = TCfg(**{**EXACT, "matmul_precision": "default"})
    mesh = _mesh(2)
    ds = D.SyntheticShapesDataset(n=8, hw=(48, 48), n_classes=3)
    ld = D.Loader(ds, cfg, 4, max_gt=4, seed=0, mesh=mesh,
                  aug=D.AugmentConfig(mosaic=0.5), device="cpu")
    host = list(ld._host_batches(0))
    state = _state(params_from_jax(seeded_tree(JCFG), cfg),
                   TTS.make_optimizer())
    step = TTS.make_train_step(cfg, TTS.make_optimizer(), mesh=mesh)
    losses = []
    for hb, shards in zip(host, ld.epoch(0)):
        assert isinstance(shards, list) and len(shards) == 2
        for i, s in enumerate(shards):
            for k, v in s.items():
                assert torch.equal(v, torch.from_numpy(hb[k][2 * i:2 * i + 2]))
        state, m = step(state, shards)
        losses.append(float(m["loss"]))
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    with pytest.raises(ValueError, match="divisible"):
        D.Loader(ds, cfg, 3, mesh=mesh, device="cpu")


def _trainer(tmp_path, mesh):
    tcfg = TrainConfig(epochs=1, batch=4, max_gt=4, warmup_steps=1,
                       log_every=0, ckpt_dir=str(tmp_path), fsdp=True,
                       aug=D.AugmentConfig(mosaic=0.0))
    return Trainer(CFG_T, tcfg, mesh=mesh,
                   params=params_from_jax(seeded_tree(JCFG, seed=6), CFG_T))


def test_trainer_fsdp_fit_save_resume(tmp_path):
    """Two FSDP epochs equal one, a save and a resumed one, bit for bit;
    the resumed state is split again; ema.npz and the trained weights
    (gathered) load under the config."""
    from xrseg_tpu_torch.io.weights import load_npz
    mesh = _mesh(2)
    ds = D.SyntheticShapesDataset(n=8, hw=HW, n_classes=3)
    whole = _trainer(tmp_path / "a", mesh)
    whole.fit(ds, epochs=2, verbose=False)
    half = _trainer(tmp_path / "b", mesh)
    half.fit(ds, epochs=1, verbose=False)
    assert half.state.placement.split            # FSDP really split
    resumed = _trainer(tmp_path / "b", mesh)
    resumed._init_params = None
    hist = resumed.fit(ds, resume=True, epochs=1, verbose=False)
    assert len(hist) == 2 and resumed.state.step == whole.state.step == 4
    assert set(resumed.state.placement.split) == \
        set(whole.state.placement.split)
    assert hist[-1]["loss"] == whole.history[-1]["loss"]
    for (n, a), b in zip(whole.params.named_parameters(),
                         resumed.params.parameters()):
        assert a.shape == b.shape and a.numel() > 0, n
        assert torch.equal(a, b), n
    ema = load_npz(str(tmp_path / "b" / "ema.npz"), CFG_T)
    for a, b in zip(ema.parameters(), resumed.ema_params.parameters()):
        assert torch.equal(a, b)


def test_mesh_preflight_measures_one_shard(monkeypatch):
    """The preflight passes data_shards and measures one shard's batch."""
    from xrseg_tpu_torch.train import preflight as pf
    seen = []

    def stub(step_fn, state, shapes):
        seen.append((step_fn.shard_step.grad_accum, shapes["images"][0]))
        return 10 ** 9 * step_fn.grad_accum ** -1

    monkeypatch.setattr(pf, "estimate_step_bytes", stub)
    tcfg = TrainConfig(epochs=1, batch=8, max_gt=4, log_every=0,
                       hbm_budget=int(1.2e9), ema_decay=0.0,
                       aug=D.AugmentConfig(mosaic=0.0))
    tr = Trainer(CFG_T, tcfg, mesh=_mesh(2))
    tr.fit(D.SyntheticShapesDataset(n=8, hw=HW, n_classes=3), verbose=False)
    # valid accums keep 8 / a divisible by 2: 1, 2, 4; 1 GB / 2 fits 0.72
    assert seen == [(1, (4, 64, 64, 3)), (2, (4, 64, 64, 3))]


# ---------------------------------------------------------------------------
# distillation and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["detect", "mixed", "classify"])
def test_dp_distill_matches_unsharded(mode):
    task = {"detect": "detect", "mixed": "segment",
            "classify": "classify"}[mode]
    kw = {**EXACT, "input_size": (32, 32), "task": task}
    jcfg, cfg = JCfg(**kw), TCfg(**kw)
    teacher = params_from_jax(detecting_tree(jcfg, seed=1), cfg)
    student = params_from_jax(seeded_tree(jcfg, seed=2), cfg)
    dcfg = TD.DistillConfig(det_weight=1.0 if mode == "mixed" else 0.0)
    opt = TTS.make_optimizer(1e-5, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(7)
    b = {"images": rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)}
    if mode == "mixed":
        b.update(boxes_xywh=np.tile(np.float32([16, 16, 12, 12]),
                                    (4, 1, 1)),
                 labels=np.asarray([[1], [2], [0], [-1]], np.int32),
                 masks=np.ones((4, 1, 8, 8), np.float32),
                 sample_weight=np.float32([1, 2, 0.5, 0]))
    runs = []
    for mesh in (None, _mesh(2)):
        state = _state(student, opt)
        step = TD.make_distill_step(cfg, cfg, opt, dcfg, mesh=mesh,
                                    use_remat=False, device="cpu")
        for _ in range(2):
            state, m = step(state, teacher, b)
        runs.append((state, {k: float(v) for k, v in m.items()}))
    (want_s, want), (got_s, got) = runs
    assert want["loss"] > 1e-4
    _same_metrics(got, want, 1e-5)
    _same_params(got_s, want_s)


def test_fsdp_checkpoint_reloads_on_one_device(tmp_path):
    model = params_from_jax(seeded_tree(JCFG, seed=8), CFG_T)
    opt = TTS.make_optimizer(2e-3, warmup_steps=1, total_steps=50)
    mesh = _mesh(4)
    b = _batch(np.random.default_rng(8), 4)
    step = TTS.make_train_step(CFG_T, opt, mesh=mesh, use_remat=False,
                               fsdp=True, fsdp_min_size=1024)
    fstate, _ = step(TTS.shard_train_state(
        _state(model, opt), mesh, fsdp=True, fsdp_min_size=1024), b)
    path = str(tmp_path / "state.pt")
    TTS.save_train_state(path, fstate)
    one = TTS.load_train_state(path, _state(
        params_from_jax(seeded_tree(JCFG, seed=9), CFG_T), opt))
    assert one.step == 1 and one.opt_state["count"] == 1
    full = _full(fstate)
    for n, p in one.params.named_parameters():
        assert torch.equal(p.detach(), full[n]), n
    for n, t in one.opt_state["nu"].items():
        assert torch.equal(t, TTS._full(fstate.opt_state["nu"][n], CPU)), n
    # and the reverse: a one-device checkpoint into a split state
    TTS.save_train_state(path, one)
    back = TTS.load_train_state(path, TTS.shard_train_state(
        _state(model, opt), mesh, fsdp=True, fsdp_min_size=1024))
    assert back.placement.split and back.step == 1
    _same_params(back, one, atol=0, rtol=0)
