"""The port's training forward, losses, assigner and train step
(xrseg_tpu_torch/models/yolo11.forward_train, train/losses.py,
train/train_step.py) against the JAX package's, on the CPU at 64x64,
scale n, float32 with matmul_precision "highest".

- forward_train per task (segment, detect, pose, obb, classify, and o2o)
  within 1e-4 of JAX's; each task's loss and every aux term within rtol
  1e-5 of JAX's on the same (JAX's) forward outputs.
- the TAL assigner on tests/test_assigner_fuzz.py's scene generators:
  axis-aligned, fg and gt_idx EQUAL to JAX's and target_scores within
  1e-6; rotated, the same except at metric ties within float rounding of
  a GT's k-th value (XLA's and torch's transcendentals differ by an ulp),
  scores within 1e-6 + 2e-5 relative; a tie case with more than topk
  candidates on a GT, in the assigner and in the seg loss's slate.
- three optimizer steps (the JAX step compiled once, in a module fixture;
  warmup included, clipping engaged): metrics within rtol 1e-5, each
  gradient leaf within 1e-4 of that leaf's max abs, params and moments
  within rtol 1e-5, atol 1e-6. The learning rate is 1e-5: Adam divides by
  sqrt(nu) + 1e-8, so gradients at float-noise level (~1e-9, where the two
  frameworks' summation orders disagree) become O(0.1) updates in either
  framework, and the params can agree only to lr times that.
- the optimizer's schedule against optax's, grad_accum=2 against one
  batch, remat on against off, o2o and label smoothing against JAX, bf16
  gradients against JAX's bf16 gradients (tests/test_train.py's bound),
  checkpoint resume, and the refusals (JAX's over a mesh, a card that is
  not there; training over a mesh itself is tests/test_torch_train_mesh.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JCfg
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.train import losses as JL
from xrseg_tpu.train import train_step as JTS
from xrseg_tpu_torch.config import ModelConfig as TCfg
from xrseg_tpu_torch.io.bridge import params_from_jax, state_dict_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import losses as TL
from xrseg_tpu_torch.train import train_step as TTS
from test_assigner_fuzz import (A as FUZZ_A, CFG as FUZZ_JCFG, MODES,
                                ROT_MODES, SIZE as FUZZ_SIZE, TOPK,
                                make_rot_scene, make_scene, tal_oracle)
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

HW = (64, 64)
EXACT = dict(scale="n", input_size=HW, dtype="float32",
             matmul_precision="highest")
TASKS = {"segment": {}, "detect": {"task": "detect"},
         "pose": {"task": "pose", "kpt_shape": (5, 3)},
         "obb": {"task": "obb"}, "classify": {"task": "classify"},
         "o2o": {"o2o": True}}


def _cfgs(**kw):
    kw = {**EXACT, "num_classes": 3, **kw}
    return JCfg(**kw), TCfg(**kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(task: str, rng, B: int = 2, G: int = 3) -> dict:
    """Seeded images and targets in the train step's contract."""
    images = rng.uniform(0, 1, (B,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 3, (B, G)).astype(np.int32)
    labels[-1, -1] = -1                                 # a padded GT row
    if task == "classify":
        return {"images": images,
                "labels": np.asarray([0, 2][:B], np.int32)}
    boxes = np.concatenate([rng.uniform(16, 48, (B, G, 2)),
                            rng.uniform(10, 30, (B, G, 2))],
                           -1).astype(np.float32)
    if task == "obb":
        ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, G, 1))
        return {"images": images, "labels": labels,
                "boxes_xywhr": np.concatenate([boxes, ang],
                                              -1).astype(np.float32)}
    out = {"images": images, "boxes_xywh": boxes, "labels": labels}
    if task == "pose":
        k = np.concatenate([boxes[:, :, None, :2]
                            + rng.normal(0, 4, (B, G, 5, 2)),
                            rng.uniform(0, 1, (B, G, 5, 1)) > 0.3], -1)
        out["kpts"] = k.astype(np.float32)
    elif task in ("segment", "o2o"):
        out["masks"] = (rng.uniform(0, 1, (B, G) + (HW[0] // 4, HW[1] // 4))
                        > 0.5).astype(np.float32)
    return out


def _assert_close(got, want, rtol=1e-4, what=""):
    want = np.asarray(want)
    got = np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# forward_train and each task's loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TASKS))
def test_forward_train_and_loss_match_jax(name):
    """forward_train within 1e-4 of JAX's (per output, relative to its max
    abs); the loss and every aux term within rtol 1e-5 of JAX's on JAX's
    own forward outputs."""
    kw = TASKS[name]
    task = kw.get("task", "segment")
    jcfg, tcfg = _cfgs(**kw)
    tree = detecting_tree(jcfg)
    if name == "o2o":
        tree["det_o2o"] = jax.tree.map(lambda a: a * np.float32(0.9),
                                       tree["det"])
    batch = _batch(name, np.random.default_rng(5))
    fwd = jy.classify_forward if task == "classify" else jy.forward_train
    jout = jax.device_get(jax.jit(lambda p, x: fwd(p, x, jcfg))(
        tree, batch["images"]))
    model = params_from_jax(tree, tcfg)
    with torch.no_grad():
        tout = model.forward_train(_t(batch["images"]))
    want_keys = set(jout) - ({"probs"} if task != "classify" else set())
    assert want_keys <= set(tout), (set(jout), set(tout))
    for k in want_keys:
        _assert_close(tout[k].numpy(), jout[k], what=k)

    tj = {k: _t(v) for k, v in jout.items()}
    if task == "classify":
        lj, aj = JL.classification_loss(jout["logits"], batch["labels"])
        lt, at = TL.classification_loss(tj["logits"], _t(batch["labels"]))
    else:
        tgt = {k: v for k, v in batch.items() if k != "images"}
        hw = HW
        lj, aj = jax.jit(lambda o, t: JL.detection_loss(o, t, jcfg,
                                                        input_hw=hw))(
            {k: v for k, v in jout.items() if not k.startswith("o2o")}, tgt)
        lt, at = TL.detection_loss(
            {k: v for k, v in tj.items() if not k.startswith("o2o")},
            {k: _t(v) for k, v in tgt.items()}, tcfg, input_hw=hw)
        assert float(aj["box"]) > 0, "no positives: the check is empty"
    assert set(aj) == set(at)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_forward_train_follows_the_batch_shape():
    """Anchors come from the batch's own (H, W): a 96x64 batch decodes on
    its own grid (JAX's multi-scale contract), and the grid is cached."""
    jcfg, tcfg = _cfgs()
    tree = seeded_tree(jcfg)
    x = np.random.default_rng(0).uniform(0, 1, (1, 96, 64, 3)).astype(
        np.float32)
    jout = jax.device_get(jax.jit(lambda p, x: jy.forward_train(
        p, x, jcfg))(tree, x))
    model = params_from_jax(tree, tcfg)
    with torch.no_grad():
        tout = model.forward_train(_t(x))
    assert tout["boxes_xywh"].shape[1] == (12 * 8 + 6 * 4 + 3 * 2)
    _assert_close(tout["boxes_xywh"].numpy(), jout["boxes_xywh"])
    assert (96, 64, torch.device("cpu")) in model._train_anchors
    with pytest.raises(ValueError, match="multiples of 32"):
        model.forward_train(torch.zeros(1, 80, 64, 3))


# ---------------------------------------------------------------------------
# the assigner
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tal(rotated: bool):
    fn = functools.partial(JL.assign_targets_tal, cfg=FUZZ_JCFG, topk=TOPK,
                           input_hw=FUZZ_SIZE)
    if rotated:
        return jax.jit(lambda p, l, g, lab, gr, pr: fn(
            p, l, g, lab, gt_rboxes=gr, pred_rboxes=pr))
    return jax.jit(lambda p, l, g, lab: fn(p, l, g, lab))


def _tal_both(rotated, pred, logits, gtb, lab, gt_rb=None, pred_rb=None):
    tcfg = TCfg(num_classes=FUZZ_JCFG.num_classes, input_size=FUZZ_SIZE)
    if rotated:
        want = _jax_tal(True)(pred, logits, gtb, lab, gt_rb, pred_rb)
        got = TL.assign_targets_tal(_t(pred), _t(logits), _t(gtb), _t(lab),
                                    tcfg, topk=TOPK, input_hw=FUZZ_SIZE,
                                    gt_rboxes=_t(gt_rb),
                                    pred_rboxes=_t(pred_rb))
    else:
        want = _jax_tal(False)(pred, logits, gtb, lab)
        got = TL.assign_targets_tal(_t(pred), _t(logits), _t(gtb), _t(lab),
                                    tcfg, topk=TOPK, input_hw=FUZZ_SIZE)
    return {k: v.numpy() for k, v in got.items()}, jax.device_get(want)


def _same_assignment(got, want, what):
    np.testing.assert_array_equal(got["fg"], want["fg"], err_msg=what)
    np.testing.assert_array_equal(got["gt_idx"], want["gt_idx"],
                                  err_msg=what)
    np.testing.assert_allclose(got["target_scores"], want["target_scores"],
                               rtol=0, atol=1e-6, err_msg=what)


def test_tal_fuzz_equals_jax():
    """Every axis-aligned fuzz scene of tests/test_assigner_fuzz.py (25
    seeds per mode): fg and gt_idx EQUAL to JAX's, target_scores within
    1e-6."""
    n_fg = 0
    for mode in MODES:
        for seed in range(25):
            got, want = _tal_both(False, *make_scene(seed, mode))
            _same_assignment(got, want, f"{mode}/{seed}")
            n_fg += int(got["fg"].sum())
    assert n_fg > 500


def test_tal_rotated_fuzz_matches_jax():
    """Every rotated fuzz scene (25 seeds per mode). probIoU's log, exp
    and sqrt and the angle's cos and sin round differently in XLA and in
    torch (1 ulp on 4-16% of inputs), and the metric takes IoU to the
    6th power, so the rotated assigner is held as tests/test_assigner_
    fuzz.py holds JAX's against its oracle: fg and gt_idx EQUAL except at
    anchors whose metric lies within 3e-5 of their GT's k-th value
    (boundary: at most 2 of the 100 scenes), target_scores within 1e-6 +
    2e-5 relative on every GT whose positives hold no boundary anchor."""
    boundary_scenes = 0
    for mode in ROT_MODES:
        for seed in range(25):
            pred_rb, gt_rb, logits, lab, gt_aabb = make_rot_scene(seed, mode)
            got, want = _tal_both(True, np.zeros((FUZZ_A, 4), np.float32),
                                  logits, gt_aabb, lab, gt_rb, pred_rb)
            what = f"{mode}/{seed}"
            ref = tal_oracle(None, logits, None, lab, rot=True, gt_rb=gt_rb,
                             pred_rb=pred_rb)
            m, kth = ref["metric"], ref["kth"][None]
            near = ((m > 0) & (np.abs(m - kth) <= 3e-5 * np.maximum(
                kth, 1e-30))).any(1)
            differ = ((got["fg"] != want["fg"])
                      | (got["gt_idx"] != want["gt_idx"]))
            assert not (differ & ~near).any(), what
            boundary_scenes += bool(differ.any())
            tainted = np.zeros(len(lab), bool)
            for a in np.nonzero(differ)[0]:
                tainted[[got["gt_idx"][a], want["gt_idx"][a]]] = True
            keep = ~(want["fg"] & tainted[want["gt_idx"]]) & ~differ
            np.testing.assert_allclose(got["target_scores"][keep],
                                       want["target_scores"][keep],
                                       rtol=2e-5, atol=1e-6, err_msg=what)
    assert boundary_scenes <= 2, boundary_scenes


def test_tal_ties_beyond_topk_equal_jax():
    """A GT with more than topk candidates tied at its k-th metric: every
    tied anchor is a candidate, in both packages."""
    A, nc = FUZZ_A, FUZZ_JCFG.num_classes
    gtb = np.asarray([[32, 32, 40, 40], [20, 20, 8, 8]], np.float32)
    lab = np.asarray([1, 2], np.int32)
    pred = np.tile(np.asarray([[32, 32, 30, 30]], np.float32), (A, 1))
    logits = np.zeros((A, nc), np.float32)
    got, want = _tal_both(False, pred, logits, gtb, lab)
    _same_assignment(got, want, "ties")
    assert ((got["gt_idx"] == 0) & got["fg"]).sum() > TOPK


def test_seg_slate_ties_match_jax():
    """More positives than the slate's topk*G places (ties): the slate
    keeps the lowest-index positives, as lax.top_k does, so the seg loss
    and its gradient equal JAX's."""
    jcfg, tcfg = _cfgs()
    anchors, _ = jy.make_anchors(HW)
    A, nm = anchors.shape[0], jcfg.num_masks
    rng = np.random.default_rng(3)
    out = {"box_logits": np.zeros((1, A, 4 * jcfg.reg_max), np.float32),
           "cls_logits": np.zeros((1, A, 3), np.float32),
           "boxes_xywh": np.tile(np.asarray([32, 32, 30, 30], np.float32),
                                 (1, A, 1)),
           "mask_coefs": rng.normal(0, 1, (1, A, nm)).astype(np.float32),
           "protos": rng.normal(0, 1, (1, 16, 16, nm)).astype(np.float32)}
    tgt = {"boxes_xywh": np.asarray([[[32, 32, 40, 40]]], np.float32),
           "labels": np.asarray([[1]], np.int32),
           "masks": (rng.uniform(0, 1, (1, 1, 16, 16)) > 0.5).astype(
               np.float32)}

    def jseg(coefs):
        return JL.detection_loss(dict(out, mask_coefs=coefs), tgt,
                                 jcfg)[1]["seg"]

    vj, gj = jax.jit(jax.value_and_grad(jseg))(out["mask_coefs"])
    coefs = _t(out["mask_coefs"]).requires_grad_(True)
    a = TL.assign_targets_tal(_t(out["boxes_xywh"]), _t(out["cls_logits"]),
                              _t(tgt["boxes_xywh"]), _t(tgt["labels"]), tcfg)
    assert int(a["fg"].sum()) > TOPK           # the slate truncates
    vt = TL.detection_loss(
        {**{k: _t(v) for k, v in out.items()}, "mask_coefs": coefs},
        {k: _t(v) for k, v in tgt.items()}, tcfg)[1]["seg"]
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    _assert_close(coefs.grad.numpy(), gj, rtol=1e-5)


def test_assigners_are_detached_and_center_assigner_matches():
    """No gradient reaches the TAL assignment; the center-inside-box
    assigner equals JAX's on the fuzz scenes."""
    tcfg = TCfg(num_classes=FUZZ_JCFG.num_classes, input_size=FUZZ_SIZE)
    pred, logits, gtb, lab = make_scene(0, "random")
    p, lg = _t(pred).requires_grad_(True), _t(logits).requires_grad_(True)
    a = TL.assign_targets_tal(p, lg, _t(gtb), _t(lab), tcfg)
    assert not a["target_scores"].requires_grad
    center = jax.jit(functools.partial(JL.assign_targets, cfg=FUZZ_JCFG,
                                       input_hw=FUZZ_SIZE))
    for mode in MODES:
        for seed in range(5):
            _, _, gtb, lab = make_scene(seed, mode)
            want = center(gtb, lab)
            got = TL.assign_targets(_t(gtb), _t(lab), tcfg,
                                    input_hw=FUZZ_SIZE)
            np.testing.assert_array_equal(got["fg"].numpy(), want["fg"])
            np.testing.assert_array_equal(got["gt_idx"].numpy(),
                                          want["gt_idx"])


def test_sample_weight_removes_padded_rows():
    """drop_last=False padding: the weighted loss of a padded batch equals
    the loss of its real rows, and JAX's on the same inputs."""
    jcfg, tcfg = _cfgs(task="detect")
    tree = detecting_tree(jcfg)
    batch = _batch("detect", np.random.default_rng(9), B=3)
    batch["labels"][1:] = -1
    batch["sample_weight"] = np.asarray([1, 0, 0], np.float32)
    model = params_from_jax(tree, tcfg)
    with torch.no_grad():
        out = model.forward_train(_t(batch["images"]))
        one = model.forward_train(_t(batch["images"][:1]))
    tgt = {k: _t(v) for k, v in batch.items() if k != "images"}
    l_pad, _ = TL.detection_loss(out, tgt, tcfg)
    l_one, _ = TL.detection_loss(
        one, {k: v[:1] for k, v in tgt.items() if k != "sample_weight"},
        tcfg)
    np.testing.assert_allclose(float(l_pad), float(l_one), rtol=1e-5)
    lj, _ = jax.jit(lambda o, t: JL.detection_loss(o, t, jcfg))(
        {k: v.numpy() for k, v in out.items()},
        {k: v.numpy() for k, v in tgt.items()})
    np.testing.assert_allclose(float(l_pad), float(lj), rtol=1e-5)


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (100, 10_000)])
def test_schedule_matches_optax(warmup, total):
    opt = TTS.make_optimizer(lr=1e-3, warmup_steps=warmup,
                             total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup, max(total, warmup + 1))
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                         total - 1, total, total + 7} - {-1}):
        np.testing.assert_allclose(opt.schedule(count),
                                   float(sched(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12, err_msg=count)


STEP_LR, STEP_WARMUP, STEP_TOTAL, N_STEPS = 1e-5, 2, 10, 3


@pytest.fixture(scope="module")
def three_steps():
    """JAX's jitted step and the port's step, 3 steps each on the same
    segment batch from the same weights; JAX's state after step 1 too."""
    jcfg, tcfg = _cfgs()
    tree = seeded_tree(jcfg)
    batch = _batch("segment", np.random.default_rng(1))
    jopt = JTS.make_optimizer(STEP_LR, warmup_steps=STEP_WARMUP,
                              total_steps=STEP_TOTAL)
    params = jax.tree.map(jnp.asarray, tree)
    js = JTS.TrainState(params=params, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = JTS.make_train_step(jcfg, jopt, use_remat=False)
    topt = TTS.make_optimizer(STEP_LR, warmup_steps=STEP_WARMUP,
                              total_steps=STEP_TOTAL)
    model = params_from_jax(tree, tcfg)
    tstate = TTS.TrainState(params=model, opt_state=topt.init(model), step=0)
    tstep = TTS.make_train_step(tcfg, topt, use_remat=False, device="cpu")
    jm, tm, first = [], [], None
    for i in range(N_STEPS):
        js, m = jstep(js, batch)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = (jax.device_get(js.opt_state[1][0].mu),
                     {k: v.clone() for k, v in
                      tstate.opt_state["mu"].items()})
    return dict(jstate=jax.device_get(js), tstate=tstate, jm=jm, tm=tm,
                first=first)


def test_step_metrics_match_jax(three_steps):
    jm, tm = three_steps["jm"], three_steps["tm"]
    assert any(m["grad_norm"] > 10.0 for m in jm)       # clipping engaged
    for i, (a, b) in enumerate(zip(jm, tm)):
        assert set(a) == set(b), (set(a), set(b))
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_step_grads_match_jax(three_steps):
    """The first step's clipped gradient (its first moment / (1 - b1)),
    leaf by leaf, within 1e-4 of the leaf's max abs."""
    mu_j, mu_t = three_steps["first"]
    want = state_dict_from_jax(mu_j)
    assert set(want) == set(mu_t)
    for name, g in mu_t.items():
        ref = want[name].numpy() / 0.1
        got = g.numpy() / 0.1
        tol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= tol, name


def test_step_params_and_moments_match_jax(three_steps):
    js, ts_ = three_steps["jstate"], three_steps["tstate"]
    assert int(js.step) == ts_.step == N_STEPS
    assert ts_.opt_state["count"] == N_STEPS
    params = state_dict_from_jax(js.params)
    for name, p in ts_.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    adam = js.opt_state[1][0]
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_from_jax(tree)
        for name, v in ts_.opt_state[key].items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} {name}")


def _port_step(tcfg, tree, batch, lr=2e-3, **kw):
    opt = TTS.make_optimizer(lr, warmup_steps=1, total_steps=50)
    model = params_from_jax(tree, tcfg)
    state = TTS.TrainState(params=model, opt_state=opt.init(model), step=0)
    step = TTS.make_train_step(tcfg, opt, device="cpu", **kw)
    return step, state


def test_grad_accum_matches_single_microbatch():
    """grad_accum=2 over a batch that is the same microbatch twice equals
    the plain step on the one microbatch (each microbatch normalises its
    own loss); an indivisible batch raises."""
    jcfg, tcfg = _cfgs()
    tree = seeded_tree(jcfg, seed=4)
    mb = _batch("segment", np.random.default_rng(4))
    doubled = {k: np.concatenate([v, v]) for k, v in mb.items()}
    step1, s1 = _port_step(tcfg, tree, mb, use_remat=False)
    step2, s2 = _port_step(tcfg, tree, doubled, use_remat=False,
                           grad_accum=2)
    for _ in range(2):
        s1, m1 = step1(s1, mb)
        s2, m2 = step2(s2, doubled)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4)
    for (n, a), b in zip(s1.params.named_parameters(),
                         s2.params.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)
    step3, s3 = _port_step(tcfg, tree, doubled, use_remat=False,
                           grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        step3(s3, doubled)


def test_remat_matches_no_remat():
    """torch.utils.checkpoint around forward_train changes no number."""
    jcfg, tcfg = _cfgs(task="pose", kpt_shape=(5, 3))
    tree = detecting_tree(jcfg)
    batch = {k: _t(v) for k, v in _batch("pose",
                                          np.random.default_rng(2)).items()}
    grads = []
    for remat in (False, True):
        step, state = _port_step(tcfg, tree, batch, use_remat=remat)
        loss, aux = step.compute_grads(state.params, batch)
        grads.append((float(loss), [p.grad.clone()
                                     for p in state.params.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


def test_o2o_step_loss_matches_jax():
    """With cfg.o2o the step adds the one-to-one head's TAL topk=1 loss
    (boxes and classes): loss and every aux term (o2o_* included) within
    rtol 1e-5 of the JAX step's loss function."""
    jcfg, tcfg = _cfgs(o2o=True)
    tree = detecting_tree(jcfg)
    tree["det_o2o"] = jax.tree.map(lambda a: a * np.float32(0.9),
                                   tree["det"])
    batch = _batch("segment", np.random.default_rng(6))

    def jloss(p, b):
        out = jy.forward_train(p, b["images"], jcfg)
        tgt = {k: b[k] for k in ("boxes_xywh", "labels", "masks")}
        loss, aux = JL.detection_loss(out, tgt, jcfg, input_hw=HW)
        l2, a2 = JL.detection_loss(
            {"box_logits": out["o2o_box_logits"],
             "cls_logits": out["o2o_cls_logits"],
             "boxes_xywh": out["o2o_boxes_xywh"]},
            {k: tgt[k] for k in ("boxes_xywh", "labels")},
            dataclasses.replace(jcfg, task="detect"), input_hw=HW,
            assigner_topk=1)
        return loss + l2, {**aux, **{f"o2o_{k}": v for k, v in a2.items()}}

    lj, aj = jax.jit(jloss)(tree, batch)
    step, state = _port_step(tcfg, tree, batch, use_remat=False)
    with torch.no_grad():
        lt, at = step.loss_fn(state.params,
                              {k: _t(v) for k, v in batch.items()})
    assert set(at) == set(aj) and "o2o_box" in at
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_label_smoothing_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 2, (6, 5)).astype(np.float32)
    labels = np.asarray([0, 4, 2, -1, 1, -1], np.int32)
    for eps in (0.0, 0.1):
        lj, aj = JL.classification_loss(logits, labels, label_smoothing=eps)
        lt, at = TL.classification_loss(_t(logits), _t(labels),
                                        label_smoothing=eps)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
        assert float(at["acc"]) == float(aj["acc"])
    # through the classify step: the smoothed loss is the step's loss
    jcfg, tcfg = _cfgs(task="classify")
    batch = _batch("classify", rng)
    step, state = _port_step(tcfg, seeded_tree(jcfg), batch,
                             use_remat=False, label_smoothing=0.1)
    with torch.no_grad():
        lt, _ = step.loss_fn(state.params,
                             {k: _t(v) for k, v in batch.items()})
    logits_t = state.params.forward_train(_t(batch["images"]))["logits"]
    lj, _ = JL.classification_loss(logits_t.detach().numpy(),
                                   batch["labels"], label_smoothing=0.1)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


def test_bf16_grads_match_jax_bf16():
    """dtype bfloat16 end to end: the port's bf16 gradients against JAX's
    bf16 gradients at tests/test_train.py's bound (loss within 5%, cosine
    similarity of the whole gradient above 0.98), finite and nonzero
    through every head."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", matmul_precision="default")
    tree = seeded_tree(jcfg, seed=2)
    batch = _batch("segment", np.random.default_rng(7))
    tgt = {k: batch[k] for k in ("boxes_xywh", "labels", "masks")}

    def f(p):
        out = jy.forward_train(p, batch["images"], jcfg)
        return JL.detection_loss(out, tgt, jcfg)[0]

    lj, gj = jax.jit(jax.value_and_grad(f))(tree)
    model = params_from_jax(tree, tcfg)
    out = model.forward_train(_t(batch["images"]))
    lt, _ = TL.detection_loss(out, {k: _t(v) for k, v in tgt.items()}, tcfg)
    lt.backward()
    assert np.isfinite(float(lt))
    assert float(lt) == pytest.approx(float(lj), rel=0.05)
    want = state_dict_from_jax(jax.device_get(gj))
    names = [n for n, _ in model.named_parameters()]
    got = {n: p.grad for n, p in model.named_parameters()}
    for head in ("b0.", "det.", "proto.", "seg_cv4."):
        sub = [got[n] for n in names if n.startswith(head)]
        assert all(torch.isfinite(g).all() for g in sub), head
        assert any(float(g.abs().max()) > 0 for g in sub), head
    va = np.concatenate([got[n].double().numpy().ravel() for n in names])
    vb = np.concatenate([want[n].double().numpy().ravel() for n in names])
    cos = float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
    assert cos > 0.98, cos


def test_train_state_checkpoint_resume(tmp_path):
    """Save the full state mid-run, restore into a fresh state, continue:
    the same trajectory, bit for bit."""
    jcfg, tcfg = _cfgs(task="detect")
    tree = seeded_tree(jcfg, seed=1)
    batches = [_batch("detect", np.random.default_rng(i)) for i in range(4)]
    step, ref = _port_step(tcfg, tree, None, lr=1e-3, use_remat=False)
    for b in batches:
        ref, m_ref = step(ref, b)
    _, s = _port_step(tcfg, tree, None, lr=1e-3, use_remat=False)
    for b in batches[:2]:
        s, _ = step(s, b)
    path = str(tmp_path / "state.pt")
    TTS.save_train_state(path, s)
    _, fresh = _port_step(tcfg, seeded_tree(jcfg, seed=3), None, lr=1e-3)
    s2 = TTS.load_train_state(path, fresh)
    assert s2.step == 2 and s2.opt_state["count"] == 2
    for b in batches[2:]:
        s2, m2 = step(s2, b)
    assert float(m2["loss"]) == float(m_ref["loss"])
    for a, b in zip(ref.params.parameters(), s2.params.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("call", ["mesh", "fsdp", "shard", "shardings",
                                  "cuda"])
def test_train_step_refusals(call, monkeypatch):
    """The JAX package's refusals over a mesh: a batch the data axis does
    not divide, fsdp without a mesh, FSDP across processes (a mesh whose
    rows belong to two ranks), a microbatch the data axis does not
    divide; and a card that is not there raises instead of falling back
    to the CPU."""
    _, tcfg = _cfgs()
    opt = TTS.make_optimizer()
    if call == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTS.make_train_step(tcfg, opt)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTS.init_train_state(torch.Generator(), tcfg, opt)
        return
    from xrseg_tpu_torch.parallel.mesh import Mesh, make_mesh
    cpu = torch.device("cpu")
    mesh = make_mesh((2, 1), devices=[cpu] * 2)
    batch = _batch("segment", np.random.default_rng(0), B=3)
    state = TTS.TrainState(*(lambda m: (m, opt.init(m), 0))(
        params_from_jax(seeded_tree(_cfgs()[0]), tcfg)))
    if call == "mesh":
        with pytest.raises(ValueError, match="not divisible by data axis"):
            TTS.make_train_step(tcfg, opt, mesh=mesh)(state, batch)
    elif call == "fsdp":
        with pytest.raises(ValueError, match="requires a mesh"):
            TTS.make_train_step(tcfg, opt, fsdp=True, device="cpu")
    elif call == "shard":
        two = Mesh(mesh.devices, ranks=np.asarray([[0], [1]]))
        with pytest.raises(ValueError, match="fsdp across processes"):
            TTS.shard_train_state(state, two, fsdp=True)
        with pytest.raises(ValueError, match="fsdp across processes"):
            TTS.make_train_step(tcfg, opt, mesh=two, fsdp=True)
    else:
        batch = _batch("segment", np.random.default_rng(0), B=4)
        with pytest.raises(ValueError, match="must stay divisible"):
            TTS.make_train_step(tcfg, opt, mesh=mesh, grad_accum=4)(
                state, batch)
