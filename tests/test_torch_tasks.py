"""The rest of the task family in the port against the JAX package, on the
CPU: YOLO11n-pose, YOLO11n-cls and the YOLOv8 arch (models/yolo11.py,
models/layers.C2f), the pose decode tail (ops/postprocess.
postprocess_pose_batch), the pose and classify slates of build_pipeline,
and the classify head's weight leaves (io/bridge.py, io/weights.py).

Weights: tests/torch_parity.py's seeded_tree (the JAX init's pytree
structure from eval_shape, every leaf from a numpy seed at fan-in scale),
carried across by io/bridge.py; for the pipelines its detecting_tree,
whose detect head fires at every anchor, so every slate fills. No JAX
init is run.

Tolerances, all in float32 with matmul_precision "highest":
- forward outputs: 1e-4 of each output's largest magnitude (both sides
  compute in float32; summation orders differ over the depth);
- decode_kpts: 1e-6 relative; postprocess_pose_batch against JAX's
  "scan" backend: indices, labels, valid, count EQUAL, keypoints 1e-6;
- pipeline slates: labels, valid, count, indices EQUAL; boxes 1e-3 px,
  scores 1e-5, keypoints 1e-3 px, classify probs 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.io import weights as jw
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import postprocess as jpost
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.ops import postprocess as tpost
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

EXACT = dict(dtype="float32", matmul_precision="highest")
POST = dict(iou_threshold=0.6, score_threshold=0.3)
# (arch, task) of the task family's new paths
CASES = [("yolo11", "pose"), ("yolo11", "classify"), ("yolov8", "segment"),
         ("yolov8", "detect"), ("yolov8", "pose"), ("yolov8", "classify")]
_jax_forward = jax.jit(jy.forward, static_argnames=("cfg", "concat_preds"))


def _model_kw(arch, task, size):
    kw = dict(EXACT, arch=arch, task=task, input_size=size)
    if task == "classify":
        kw["num_classes"] = 10
    return kw


@pytest.mark.parametrize("arch,task", CASES)
def test_forward_matches_jax(arch, task):
    """Every output of forward(concat_preds=True), 1e-4 relative. A
    non-square input for the detection tasks, so a swapped H/W or a
    scrambled anchor axis cannot pass."""
    kw = _model_kw(arch, task, (64, 64) if task == "classify" else (64, 96))
    jcfg, tcfg = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    p = seeded_tree(jcfg)
    x = np.random.default_rng(7).uniform(
        0, 1, (2,) + jcfg.input_size + (3,)).astype(np.float32)
    j = jax.device_get(_jax_forward(p, jnp.asarray(x), cfg=jcfg,
                                    concat_preds=True))
    with torch.no_grad():
        t = params_from_jax(p, tcfg)(torch.from_numpy(x))
    assert set(t) == set(j), (set(t), set(j))
    for k in sorted(j):
        a = np.asarray(j[k], np.float32)
        b = t[k].float().numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-6)
        assert err < 1e-4, (k, err)
    if task == "classify":
        assert t["probs"].shape == (2, 10)
        np.testing.assert_allclose(t["probs"].sum(-1).numpy(), 1, atol=1e-6)
    else:
        assert t["scores"].std() > 1e-3      # the weights make real activity


@pytest.mark.parametrize("D", [2, 3])
def test_decode_kpts_matches_jax(D):
    rng = np.random.default_rng(D)
    anchors, strides = jy.make_anchors((64, 96))
    raw = rng.standard_normal((2, len(anchors), 5 * D)).astype(np.float32)
    j = np.asarray(jy.decode_kpts(jnp.asarray(raw), jnp.asarray(anchors),
                                  jnp.asarray(strides), (5, D)))
    t = ty.decode_kpts(torch.from_numpy(raw), torch.from_numpy(anchors),
                       torch.from_numpy(strides), (5, D)).numpy()
    assert t.shape == j.shape == (2, len(anchors), 5, D)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    if D == 3:
        assert 0 < t[..., 2].min() and t[..., 2].max() < 1


def test_postprocess_pose_batch_matches_jax_scan():
    """Crowded boxes of three classes with bf16-tied logits: the port's
    "auto" (the plain loop on the CPU) against JAX's "scan" backend."""
    rng = np.random.default_rng(11)
    B, A, nc = 3, 300, 3
    xy = rng.uniform(0, 96, (B, A, 2))
    wh = rng.uniform(4, 30, (B, A, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    logits = rng.standard_normal((B, A, nc)).astype(np.float32)
    logits = np.array(jnp.asarray(logits).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    logits[2] = -9.0                             # an empty image
    kpts = rng.uniform(0, 96, (B, A, 17, 3)).astype(np.float32)
    cfg = dict(POST, max_detections=20)
    j = jax.device_get(jpost.postprocess_pose_batch(
        jnp.asarray(boxes), jnp.asarray(logits), jnp.asarray(kpts),
        jconfig.PostprocessConfig(**cfg), scores_are_logits=True,
        backend="scan"))
    t = tpost.postprocess_pose_batch(
        torch.from_numpy(boxes), torch.from_numpy(logits),
        torch.from_numpy(kpts), tconfig.PostprocessConfig(**cfg),
        scores_are_logits=True)
    assert set(t) == set(j)
    for k in ("indices", "labels", "valid", "count"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k in ("kpts", "boxes_xywh", "scores"):
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert int(t["count"][0]) == 20 and int(t["count"][2]) == 0
    assert not t["kpts"][2].any()                # invalid rows are zero


def _pipelines(arch, task, **kw):
    mk = _model_kw(arch, task, (64, 64))
    jcfg = jconfig.ExecutorConfig(model=jconfig.ModelConfig(**mk),
                                  post=jconfig.PostprocessConfig(**POST))
    tcfg = tconfig.ExecutorConfig(model=tconfig.ModelConfig(**mk),
                                  post=tconfig.PostprocessConfig(**POST))
    p = detecting_tree(jcfg.model)
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    j = jax.device_get(jcompile.build_pipeline(
        jcfg, p, frame_hw=(48, 64), batch=2, **kw)(jnp.asarray(frames)))
    pipe = tcompile.build_pipeline(tcfg, params_from_jax(p, tcfg.model),
                                   frame_hw=(48, 64), batch=2,
                                   device="cpu", **kw)
    return pipe, pipe(frames), j


def assert_slate_close(t, j):
    """The port's detection dict against the JAX one (module tolerances)."""
    assert set(t) == set(j), (set(t), set(j))
    if "probs" in j:
        for k in ("probs", "logits", "slate"):
            np.testing.assert_allclose(t[k].numpy(), j[k], atol=1e-5,
                                       rtol=0, err_msg=k)
        return
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k, tol in (("boxes_xywh", 1e-3), ("boxes_xywhr", 1e-3),
                   ("scores", 1e-5), ("kpts", 1e-3), ("coefs", 1e-4),
                   ("masks", 1e-4), ("slate", 1e-3)):
        if k in j:
            np.testing.assert_allclose(t[k].float().numpy(),
                                       np.asarray(j[k], np.float32),
                                       atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch,task", CASES)
def test_pipeline_slate_matches_jax(arch, task):
    pipe, t, j = _pipelines(arch, task)
    assert_slate_close(t, j)
    row = tcompile.task_slate_length(pipe.cfg.model, 50)
    assert tuple(t["slate"].shape) == (2, row)
    assert pipe.readback.buffer.numel() == 2 * row
    if task == "classify":
        assert row == 10
    else:
        assert int(t["count"].min()) == 50      # the fixture always detects
        h = tcompile.unpack_slate(t["slate"][1], 50)
        np.testing.assert_array_equal(h["labels"], t["labels"][1].numpy())
    if task == "pose":
        assert tuple(t["kpts"].shape) == (2, 50, 17, 3)


def test_v8_classify_has_no_sppf_and_loads_strictly():
    """v8-cls ends at the C2f(1024) (no b9); the bridge load is strict
    both ways: an extra b9 subtree, or a missing leaf, raises."""
    jcfg = jconfig.ModelConfig(**_model_kw("yolov8", "classify", (64, 64)))
    tree = seeded_tree(jcfg)
    assert "b9" not in tree and "b10" not in tree
    model = params_from_jax(tree, tconfig.ModelConfig(
        **_model_kw("yolov8", "classify", (64, 64))))
    assert not hasattr(model, "b9") and not hasattr(model, "h13")
    assert isinstance(model.b2, L.C2f)
    assert model.b2.m[0].cv1.weight.shape[0] == model.b2.m[0].cv1.weight.shape[1]
    tcfg = tconfig.ModelConfig(**_model_kw("yolov8", "classify", (64, 64)))
    extra = dict(tree, b9=seeded_tree(jconfig.ModelConfig(
        **_model_kw("yolov8", "detect", (64, 64))))["b9"])
    with pytest.raises(RuntimeError, match="b9"):
        params_from_jax(extra, tcfg)
    short = dict(tree, cls_head=dict(tree["cls_head"]))
    del short["cls_head"]["lin_b"]
    with pytest.raises(RuntimeError, match="lin_b"):
        params_from_jax(short, tcfg)


@pytest.mark.parametrize("arch", ["yolo11", "yolov8"])
@pytest.mark.parametrize("task", ["pose", "classify"])
def test_param_count_matches_jax(arch, task):
    jcfg = jconfig.ModelConfig(arch=arch, task=task, scale="s")
    tree = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                          jax.random.key(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    model = ty.YOLO11(tconfig.ModelConfig(arch=arch, task=task, scale="s"))
    assert ty.count_params(model) == n_jax


def test_classify_npz_round_trip_and_storage(tmp_path):
    """The classify head's lin_w/lin_b cross both ways in npz files; int8
    storage keeps lin_w in float32 as JAX's quantize_int8 does; bf16
    storage rounds lin_w and lin_b as JAX's cast_params does."""
    kw = _model_kw("yolo11", "classify", (64, 64))
    jcfg, tcfg = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    tree = seeded_tree(jcfg, seed=4)
    model = params_from_jax(tree, tcfg)
    tw.save_npz(str(tmp_path / "t.npz"), model)
    back = jw.flatten_params(jw.load_npz(str(tmp_path / "t.npz")))
    want = jw.flatten_params(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    jw.save_npz(str(tmp_path / "j.npz"), tree)
    loaded = tw.load_npz(str(tmp_path / "j.npz"), tcfg)
    assert torch.equal(loaded.cls_head.lin_w, model.cls_head.lin_w)

    q_t = tw.flatten_params(tw.quantize_int8(model))
    q_j = jw.flatten_params(jw.quantize_int8(tree))
    assert set(q_t) == set(q_j)
    for k in q_j:
        np.testing.assert_array_equal(q_t[k], np.asarray(q_j[k]), err_msg=k)
    assert q_t["cls_head/lin_w"].dtype == np.float32
    assert q_t["cls_head/conv/w/q"].dtype == np.int8

    cast = tw.cast_params(model, "bfloat16")
    jcast = jax.device_get(jw.cast_params(tree, "bfloat16"))
    for name in ("lin_w", "lin_b"):
        got = getattr(cast.cls_head, name).detach()
        assert got.dtype == torch.float32        # rounded, kept in f32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcast["cls_head"][name], np.float32))
    assert not torch.equal(cast.cls_head.lin_w, model.cls_head.lin_w)
    assert cast.cls_head.conv.weight.dtype == torch.bfloat16
    assert tw.donor_num_classes(tw.params_to_tree(model)) == 10


@pytest.mark.parametrize("task", ["pose", "classify"])
def test_params_match_config_agrees_with_jax(task):
    kw = _model_kw("yolo11", task, (64, 64))
    tree = tw.params_to_tree(ty.YOLO11(tconfig.ModelConfig(**kw)))
    for cfg_kw in (kw, dict(kw, task="detect"), dict(kw, num_classes=7),
                   dict(kw, task="segment")):
        t = tw.params_match_config(tree, tconfig.ModelConfig(**cfg_kw))
        j = jw.params_match_config(tree, jconfig.ModelConfig(**cfg_kw))
        assert t == j, cfg_kw
    assert tw.params_match_config(tree, tconfig.ModelConfig(**kw))


@pytest.mark.parametrize("change", [dict(arch="yolov9"),
                                    dict(arch="yolov8", scale="t"),
                                    dict(task="obb", o2o=True)])
def test_bad_configs_raise_as_jax(change):
    cfg = dict(input_size=(64, 64), **change)
    with pytest.raises(ValueError) as jerr:
        jax.eval_shape(lambda k: jy.init_params(
            k, jconfig.ModelConfig(**cfg)), jax.random.key(0))
    with pytest.raises(ValueError) as terr:
        ty.YOLO11(tconfig.ModelConfig(**cfg))
    assert str(terr.value) == str(jerr.value)


def test_detection_params_refuses_classify():
    from xrseg_tpu_torch.testing import detection_params
    cfg = tconfig.ModelConfig(task="classify", input_size=(64, 64))
    with pytest.raises(ValueError, match="classify"):
        detection_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    pose = dataclasses.replace(cfg, task="pose", arch="yolov8")
    model = detection_params(torch.Generator().manual_seed(0), pose,
                             device="cpu")
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3))
    assert float(out["scores"][..., 0].min()) > 0.5
