"""The model ensemble (xrseg_tpu_torch/compile.build_ensemble_pipeline)
against the JAX package's build_ensemble_pipeline, on the CPU at 64x64.

Members are YOLO11n-seg and YOLO11s-seg (or one checkpoint twice) with
tests/torch_parity.detecting_tree weights, run in float32 with
matmul_precision "highest". The candidates of both members meet in one
merge, WBF or NMS. Compared per slate: indices (which member and anchor
each survivor came from), labels, valid and count EQUAL; boxes 1e-3 px,
scores 1e-5, masks 1e-4, as tests/test_torch_tta.py holds TTA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree

limit_cpu_threads()

EXACT = dict(dtype="float32", matmul_precision="highest",
             input_size=(64, 64), num_classes=3)
POST = dict(iou_threshold=0.6, score_threshold=0.3, max_detections=20)


def _cfgs(task="segment", merge="wbf", scale="n", **post):
    m = dict(EXACT, task=task, scale=scale)
    p = dict(POST, merge=merge, **post)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**m),
                                   post=jconfig.PostprocessConfig(**p)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**m),
                                   post=tconfig.PostprocessConfig(**p)))


@pytest.fixture(scope="module")
def members():
    """(JAX trees, port modules, JAX model cfgs, port model cfgs) of
    YOLO11n-seg (label 0) and YOLO11s-seg (label 1)."""
    jn, tn = _cfgs(scale="n")
    js, ts = _cfgs(scale="s")
    trees = [detecting_tree(jn.model, seed=0, label=0),
             detecting_tree(js.model, seed=1, label=1)]
    return (trees, [params_from_jax(trees[0], tn.model),
                    params_from_jax(trees[1], ts.model)],
            [jn.model, js.model], [tn.model, ts.model])


def _frames(B=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, 48, 64, 3),
                                                np.uint8)


def _run(jcfg, tcfg, trees, mods, jmc=None, tmc=None, **kw):
    frames = _frames()
    kw = dict(frame_hw=(48, 64), batch=2, **kw)
    j = jax.device_get(jcompile.build_ensemble_pipeline(
        jcfg, trees, jmc, **kw)(jnp.asarray(frames)))
    t = tcompile.build_ensemble_pipeline(tcfg, mods, tmc, device="cpu",
                                         **kw)(frames)
    return t, j


def _assert_close(t, j):
    assert set(t) == set(j), (set(t), set(j))
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k, tol in (("boxes_xywh", 1e-3), ("scores", 1e-5), ("masks", 1e-4),
                   ("coefs", 1e-4), ("slate", 1e-3)):
        if k in j:
            np.testing.assert_allclose(t[k].float().numpy(),
                                       np.asarray(j[k], np.float32),
                                       atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("merge", ["wbf", "nms"])
def test_two_scales_match_jax(members, merge):
    trees, mods, jmc, tmc = members
    jcfg, tcfg = _cfgs(merge=merge)
    t, j = _run(jcfg, tcfg, trees, mods, jmc, tmc)
    _assert_close(t, j)
    A = tcfg.model.num_anchors
    member = (t["indices"][t["valid"]] // A).tolist()
    assert int(t["count"].min()) > 0
    if merge == "nms":
        # label 0 from the n member, label 1 from the s member: both
        # members' survivors are in the slate, each with its own masks
        assert set(member) == {0, 1}


def test_masks_come_from_each_survivors_member(members):
    """A survivor of member 1 takes member 1's protos: its mask equals
    the single-member pipeline's mask for the same anchor."""
    trees, mods, jmc, tmc = members
    _, tcfg = _cfgs(merge="nms")
    frames = _frames()
    t = tcompile.build_ensemble_pipeline(tcfg, mods, tmc, frame_hw=(48, 64),
                                         batch=2, device="cpu")(frames)
    A = tcfg.model.num_anchors
    for m, (mod, mc) in enumerate(zip(mods, tmc)):
        single = tcompile.build_pipeline(
            dataclasses.replace(tcfg, model=mc), mod, frame_hw=(48, 64),
            batch=2, device="cpu")(frames)
        for b in range(2):
            rows = [d for d in range(int(t["count"][b]))
                    if int(t["indices"][b, d]) // A == m]
            assert rows
            for d in rows:
                anchor = int(t["indices"][b, d]) % A
                sd = (single["indices"][b] == anchor).nonzero()
                if len(sd):
                    np.testing.assert_allclose(
                        t["masks"][b, d].numpy(),
                        single["masks"][b, int(sd[0, 0])].numpy(),
                        atol=1e-6, rtol=0)


@pytest.mark.parametrize("merge", ["wbf", "nms"])
def test_one_checkpoint_twice(members, merge):
    """As in JAX: duplicate candidates fuse to themselves (WBF) or
    suppress each other (NMS), so the slate is the single model's."""
    trees, mods, _, _ = members
    jcfg, tcfg = _cfgs(merge=merge)
    t, j = _run(jcfg, tcfg, [trees[0]] * 2, [mods[0]] * 2)
    _assert_close(t, j)
    plain = tcompile.build_pipeline(tcfg, mods[0], frame_hw=(48, 64),
                                    batch=2, device="cpu")(_frames())
    n = int(plain["count"][0])
    assert int(t["count"][0]) == n
    np.testing.assert_allclose(np.sort(t["scores"][0, :n].numpy()),
                               np.sort(plain["scores"][0, :n].numpy()),
                               atol=1e-5)


def test_pre_nms_topk_keeps_the_member_space(members):
    trees, mods, jmc, tmc = members
    jcfg, tcfg = _cfgs(pre_nms_topk=32)
    t, j = _run(jcfg, tcfg, trees, mods, jmc, tmc)
    _assert_close(t, j)
    idx = t["indices"][t["valid"]]
    assert bool((idx >= 0).all()) and bool(
        (idx < 2 * tcfg.model.num_anchors).all())


def test_detect_members(members):
    jn, tn = _cfgs(task="detect")
    js, ts = _cfgs(task="detect", scale="s")
    trees = [detecting_tree(jn.model, 2), detecting_tree(js.model, 3)]
    t, j = _run(jn, tn, trees, [params_from_jax(trees[0], tn.model),
                                params_from_jax(trees[1], ts.model)],
                [jn.model, js.model], [tn.model, ts.model])
    _assert_close(t, j)
    assert "masks" not in t


def _validation_cases():
    jc, tc = _cfgs()
    other = dict(EXACT, num_classes=4)
    return {
        "empty": (jc, tc, 0, None),
        "length": (jc, tc, 2, [dict(EXACT)]),
        "classes": (jc, tc, 2, [dict(EXACT), other]),
        "task": (*_cfgs(task="pose"), 1, None),
    }


@pytest.mark.parametrize("case", ["empty", "length", "classes", "task"])
def test_validations_match_jax(members, case):
    jc, tc, n, cfgs = _validation_cases()[case]
    trees, mods, _, _ = members
    jmc = None if cfgs is None else [jconfig.ModelConfig(**c) for c in cfgs]
    tmc = None if cfgs is None else [tconfig.ModelConfig(**c) for c in cfgs]
    with pytest.raises(ValueError) as jerr:
        jcompile.build_ensemble_pipeline(jc, trees[:1] * n, jmc)
    with pytest.raises(ValueError) as terr:
        tcompile.build_ensemble_pipeline(tc, mods[:1] * n, tmc, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_members_must_match_their_configs(members):
    _, mods, _, tmc = members
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="ModelConfig"):
        tcompile.build_ensemble_pipeline(tcfg, mods, tmc[::-1], device="cpu")
