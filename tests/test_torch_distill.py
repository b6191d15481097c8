"""The port's distillation (xrseg_tpu_torch/train/distill.py) against the
JAX package's (xrseg_tpu/train/distill.py), on the CPU.

- distill_loss and distill_loss_classify on seeded logits, some beyond
  +-20 (where torch's softplus turns linear and JAX's does not), within
  1e-6 relative of JAX's, every aux term too;
- two distill steps (detect, 32x32, float32 "highest", the JAX step
  compiled once in a module fixture) from the same bridged weights: losses
  and metrics within rtol 1e-5, params within lr x 0.1 (Adam turns
  float-noise gradients into O(0.1) updates in either framework, so lr is
  1e-5, as tests/test_torch_train.py holds the train step);
- port only, as tests/test_distill.py holds JAX: a YOLOv8 student learns
  its YOLO11 teacher, the classify mode, the mixed mode (det_weight > 0)
  against its two parts computed apart, and the refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JCfg
from xrseg_tpu.train import distill as JD
from xrseg_tpu.train import train_step as JTS
from xrseg_tpu_torch.config import ModelConfig as TCfg
from xrseg_tpu_torch.io.bridge import params_from_jax, state_dict_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import distill as TD
from xrseg_tpu_torch.train import train_step as TTS
from xrseg_tpu_torch.train.losses import detection_loss
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

HW = (32, 32)
EXACT = dict(scale="n", input_size=HW, dtype="float32",
             matmul_precision="highest")


def _cfgs(**kw):
    kw = {**EXACT, "task": "detect", "num_classes": 3, **kw}
    return JCfg(**kw), TCfg(**kw)


def _logits(rng, shape, wide: bool):
    x = rng.normal(0, 2, shape).astype(np.float32)
    if wide:            # a share of logits beyond softplus's threshold
        x[..., ::3] *= 15.0
    return x


DCFGS = {"default": {}, "sharp": dict(temperature=0.5, fg_power=2.0),
         "weights": dict(temperature=2.5, cls_weight=0.7, box_weight=1.3)}


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("name", list(DCFGS))
def test_distill_loss_matches_jax(name, wide):
    rng = np.random.default_rng(len(name) + wide)
    B, A, nc, R = 2, 37, 5, 16
    s_cls, t_cls = (_logits(rng, (B, A, nc), wide) for _ in range(2))
    s_box, t_box = (_logits(rng, (B, A, 4 * R), wide) for _ in range(2))
    if wide:
        assert np.abs(t_cls).max() > 20 and np.abs(s_box).max() > 20
    jd, td = JD.DistillConfig(**DCFGS[name]), TD.DistillConfig(**DCFGS[name])
    jl, ja = JD.distill_loss(
        {"cls_logits": jnp.asarray(s_cls), "box_logits": jnp.asarray(s_box)},
        {"cls_logits": jnp.asarray(t_cls), "box_logits": jnp.asarray(t_box)},
        jd, R)
    tl, ta = TD.distill_loss(
        {"cls_logits": torch.from_numpy(s_cls),
         "box_logits": torch.from_numpy(s_box)},
        {"cls_logits": torch.from_numpy(t_cls),
         "box_logits": torch.from_numpy(t_box)}, td, R)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
def test_distill_classify_loss_matches_jax(wide):
    rng = np.random.default_rng(7 + wide)
    s, t = (_logits(rng, (6, 11), wide) for _ in range(2))
    t[0, 3] = t[0, 5] = t[0].max() + 1.0       # a tie: the first maximum
    for kw in ({}, dict(temperature=3.0, cls_weight=0.5)):
        jl, ja = JD.distill_loss_classify(jnp.asarray(s), jnp.asarray(t),
                                          JD.DistillConfig(**kw))
        tl, ta = TD.distill_loss_classify(torch.from_numpy(s),
                                          torch.from_numpy(t),
                                          TD.DistillConfig(**kw))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        for k in ja:
            np.testing.assert_allclose(float(ta[k]), float(ja[k]),
                                       rtol=1e-6, err_msg=k)


STEP_LR, N_STEPS = 1e-5, 2


@pytest.fixture(scope="module")
def two_steps():
    """JAX's jitted distill step and the port's, N_STEPS each on the same
    unlabelled batch, from the same student and teacher weights."""
    jcfg, tcfg = _cfgs()
    teacher = detecting_tree(jcfg, seed=5, label=2)
    student = seeded_tree(jcfg, seed=6)
    batch = {"images": np.random.default_rng(3).uniform(
        0, 1, (2,) + HW + (3,)).astype(np.float32)}
    jopt = JTS.make_optimizer(STEP_LR, warmup_steps=1, total_steps=10)
    params = jax.tree.map(jnp.asarray, student)
    js = JTS.TrainState(params=params, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = JD.make_distill_step(jcfg, jcfg, jopt, JD.DistillConfig(),
                                 use_remat=False)
    jteacher = jax.tree.map(jnp.asarray, teacher)
    topt = TTS.make_optimizer(STEP_LR, warmup_steps=1, total_steps=10)
    model = params_from_jax(student, tcfg)
    ts = TTS.TrainState(params=model, opt_state=topt.init(model), step=0)
    tstep = TD.make_distill_step(tcfg, tcfg, topt, TD.DistillConfig(),
                                 device="cpu")
    tteacher = params_from_jax(teacher, tcfg)
    jm, tm = [], []
    for _ in range(N_STEPS):
        js, m = jstep(js, jteacher, batch)
        jm.append({k: float(v) for k, v in m.items()})
        ts, m = tstep(ts, tteacher, batch)
        tm.append({k: float(v) for k, v in m.items()})
    return dict(jstate=jax.device_get(js), tstate=ts, jm=jm, tm=tm)


def test_distill_step_metrics_match_jax(two_steps):
    for i, (a, b) in enumerate(zip(two_steps["jm"], two_steps["tm"])):
        assert set(a) == set(b), (set(a), set(b))
        assert a["teacher_agreement"] > 0
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_distill_step_params_match_jax(two_steps):
    js, ts = two_steps["jstate"], two_steps["tstate"]
    assert ts.step == ts.opt_state["count"] == N_STEPS
    want = state_dict_from_jax(js.params)
    for name, p in ts.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=STEP_LR * 0.1, err_msg=name)
    # the second step moved them (the first has lr 0 after warmup 1)
    start = params_from_jax(seeded_tree(_cfgs()[0], seed=6), _cfgs()[1])
    assert any(not torch.equal(a, b) for a, b in
               zip(start.parameters(), ts.params.parameters()))


def _images(seed, B, hw=HW):
    return np.random.default_rng(seed).uniform(
        0, 1, (B,) + hw + (3,)).astype(np.float32)


def test_cross_arch_student_learns_teacher():
    """A YOLOv8 student trained only on a YOLO11 teacher's responses
    converges toward it (tests/test_distill.py's case, on the port)."""
    jt, tt = _cfgs(num_classes=4)
    _, ts_cfg = _cfgs(arch="yolov8", num_classes=4)
    teacher = params_from_jax(detecting_tree(jt, seed=0, label=2), tt)
    opt = TTS.make_optimizer(lr=2e-3, warmup_steps=5, total_steps=80)
    state = TTS.init_train_state(torch.Generator().manual_seed(1), ts_cfg,
                                 opt, device="cpu")
    step = TD.make_distill_step(ts_cfg, tt, opt, TD.DistillConfig(),
                                device="cpu")
    batch = {"images": _images(2, 2)}
    history = []
    for _ in range(60):
        state, m = step(state, teacher, batch)
        history.append((float(m["loss"]), float(m["teacher_agreement"])))
    first = np.mean([l for l, _ in history[:5]])
    last = np.mean([l for l, _ in history[-5:]])
    assert all(np.isfinite(l) for l, _ in history)
    assert last < 0.5 * first, history[:3]
    assert history[-1][1] > history[0][1]
    assert history[-1][1] > 0.5, history[-1]


def test_distill_classify_end_to_end():
    _, cfg = _cfgs(task="classify", num_classes=5)
    jcfg = _cfgs(task="classify", num_classes=5)[0]
    tree = seeded_tree(jcfg, seed=3)
    # sharpen the teacher head so its per-image responses are distinctive
    tree["cls_head"]["lin_w"] = tree["cls_head"]["lin_w"] * 30.0
    tree["cls_head"]["lin_b"] = np.random.default_rng(7).normal(
        0, 2, 5).astype(np.float32)
    teacher = params_from_jax(tree, cfg)
    opt = TTS.make_optimizer(lr=2e-3, warmup_steps=5, total_steps=80)
    state = TTS.init_train_state(torch.Generator().manual_seed(1), cfg, opt,
                                 device="cpu")
    step = TD.make_distill_step(cfg, cfg, opt, TD.DistillConfig(),
                                device="cpu")
    batch = {"images": _images(2, 4)}
    state, m0 = step(state, teacher, batch)
    assert set(m0) == {"loss", "distill_cls", "teacher_agreement",
                       "grad_norm"}
    for _ in range(40):
        state, m = step(state, teacher, batch)
    assert float(m["loss"]) < 0.5 * float(m0["loss"])
    assert float(m["teacher_agreement"]) >= float(m0["teacher_agreement"])


@pytest.mark.parametrize("task", ["segment", "classify"])
def test_mixed_mode_adds_the_ground_truth_loss(task):
    """det_weight > 0: the step's loss is the distillation loss plus
    det_weight x the ground-truth loss, each computed apart on the same
    outputs; the ground-truth terms come back under "gt_"."""
    jcfg, cfg = _cfgs(task=task)
    tree = seeded_tree(jcfg, seed=2)
    teacher = params_from_jax(detecting_tree(jcfg, seed=4), cfg)
    rng = np.random.default_rng(5)
    batch = {"images": _images(6, 2)}
    if task == "classify":
        batch["labels"] = np.asarray([1, 2], np.int32)
    else:
        batch["boxes_xywh"] = np.asarray([[[16, 16, 12, 12]], [[8, 8, 6, 6]]],
                                         np.float32)
        batch["labels"] = np.asarray([[1], [2]], np.int32)
        batch["masks"] = (rng.uniform(0, 1, (2, 1, 8, 8)) > 0.5).astype(
            np.float32)
    dcfg = TD.DistillConfig(det_weight=0.5)
    opt = TTS.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    model = params_from_jax(tree, cfg)
    step = TD.make_distill_step(cfg, cfg, opt, dcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = step.compute_grads(model, teacher, tb)
    assert any(k.startswith("gt_") for k in aux)
    with torch.no_grad():
        s_out, t_out = model.forward_train(tb["images"]), \
            teacher.forward_train(tb["images"])
        if task == "classify":
            d, _ = TD.distill_loss_classify(s_out["logits"],
                                            t_out["logits"], dcfg)
            from xrseg_tpu_torch.train.losses import classification_loss
            g, _ = classification_loss(s_out["logits"], tb["labels"])
        else:
            d, _ = TD.distill_loss(s_out, t_out, dcfg, cfg.reg_max)
            g, _ = detection_loss(s_out, {k: tb[k] for k in (
                "boxes_xywh", "labels", "masks")}, cfg, input_hw=HW)
    np.testing.assert_allclose(float(loss), float(d + 0.5 * g), rtol=1e-6)
    state = TTS.TrainState(model, opt.init(model), 0)
    for _ in range(2):
        state, m = step(state, teacher, batch)
    assert all(np.isfinite(float(v)) for v in m.values())


def test_distill_refusals(monkeypatch):
    """The JAX package's validation errors (a mesh step also refuses a
    batch its data axis does not divide); a card that is not there
    raises."""
    opt = TTS.make_optimizer()
    _, a = _cfgs()
    with pytest.raises(ValueError, match="class-count"):
        TD.make_distill_step(a, dataclasses.replace(a, num_classes=4), opt,
                             device="cpu")
    with pytest.raises(ValueError, match="reg_max"):
        TD.make_distill_step(a, dataclasses.replace(a, reg_max=8), opt,
                             device="cpu")
    with pytest.raises(ValueError, match="classify"):
        TD.make_distill_step(a, dataclasses.replace(a, task="classify"),
                             opt, device="cpu")
    with pytest.raises(ValueError, match="det_weight"):
        TD.make_distill_step(a, a, opt, TD.DistillConfig(det_weight=-1.0),
                             device="cpu")
    from xrseg_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    model = TTS.init_train_state(torch.Generator(), a, opt, device="cpu")
    with pytest.raises(ValueError, match="not divisible by data axis"):
        TD.make_distill_step(a, a, opt, mesh=mesh)(
            model, model.params, {"images": np.zeros((3,) + HW + (3,),
                                                     np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.make_distill_step(a, a, opt)
