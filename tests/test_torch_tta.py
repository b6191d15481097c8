"""Test-time augmentation in the port (build_pipeline(tta=True),
compile.TTAPipeline) against the JAX package's build_pipeline(tta=True),
on the CPU.

Weights: tests/torch_parity.detecting_tree (the JAX init's structure,
numpy leaves, the detect head patched so every anchor detects), so every
slate fills from the candidates of all views. The model runs in
float32 with matmul_precision "highest". Compared per slate: labels,
valid, count and indices (which view and anchor each survivor came from)
EQUAL; boxes 1e-3 px, scores 1e-5, keypoints 1e-3 px, masks 1e-4.

The scaled views' resize (ops/preprocess.resize_bilinear) is held
against jax.image.resize(..., "bilinear"), which antialiases when it
shrinks: 1e-5 in float32 (summation order) and EQUAL in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.ops import preprocess as tpre
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree

limit_cpu_threads()

EXACT = dict(dtype="float32", matmul_precision="highest")
POST = dict(iou_threshold=0.6, score_threshold=0.3)
# the COCO-17 skeleton's left/right joint permutation under a mirror
COCO17_FLIP = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)
CASES = {
    "segment-2views": ("segment", None),
    "obb-2views": ("obb", None),
    "pose-2views": ("pose", None),
    "detect-ultralytics": ("detect", jcompile.ULTRALYTICS_TTA_VIEWS),
    "obb-ultralytics": ("obb", jcompile.ULTRALYTICS_TTA_VIEWS),
}


def _configs(task, **model):
    kw = dict(EXACT, task=task, input_size=(64, 64), **model)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**kw),
                                   post=jconfig.PostprocessConfig(**POST)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**kw),
                                   post=tconfig.PostprocessConfig(**POST)))


def run_both(task, frames, **kw):
    """The JAX and the port's pipelines on the same weights and frames:
    (port det, JAX det, anchors per view)."""
    jcfg, tcfg = _configs(task)
    p = detecting_tree(jcfg.model)
    B = frames.shape[0]
    fhw = frames.shape[1:3]
    j = jax.device_get(jcompile.build_pipeline(
        jcfg, p, frame_hw=fhw, batch=B, **kw)(jnp.asarray(frames)))
    t = tcompile.build_pipeline(tcfg, params_from_jax(p, tcfg.model),
                                frame_hw=fhw, batch=B, device="cpu",
                                **kw)(frames)
    return t, j, tcfg.model.num_anchors


def assert_tta_close(t, j):
    assert set(t) == set(j), (set(t), set(j))
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k, tol in (("boxes_xywh", 1e-3), ("boxes_xywhr", 1e-3),
                   ("scores", 1e-5), ("kpts", 1e-3), ("masks", 1e-4),
                   ("coefs", 1e-4), ("slate", 1e-3)):
        if k in j:
            np.testing.assert_allclose(t[k].float().numpy(),
                                       np.asarray(j[k], np.float32),
                                       atol=tol, rtol=0, err_msg=k)


def _frames(B=2, hw=(48, 64), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B,) + hw + (3,),
                                                np.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tta_matches_jax(case):
    task, views = CASES[case]
    t, j, A = run_both(task, _frames(), tta=True, tta_views=views,
                       tta_kpt_flip_idx=COCO17_FLIP if task == "pose"
                       else None)
    assert_tta_close(t, j)
    assert int(t["count"].min()) == 50          # the fixture always detects
    # survivors from the flipped (or scaled) views too: the merge is real
    assert bool((t["indices"] >= A).any())
    if task == "segment":
        assert tuple(t["masks"].shape) == (2, 50, 16, 16)
    if task == "pose":
        assert tuple(t["kpts"].shape) == (2, 50, 17, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.83, 0.67])
@pytest.mark.parametrize("hw", [(37, 53), (64, 96)])
def test_tta_resize_matches_jax(hw, scale, dtype):
    x = np.random.default_rng(5).uniform(0, 1, (2,) + hw + (3,)) \
        .astype(np.float32)
    out = tuple(int(round(s * scale)) for s in hw)
    j = jax.image.resize(jnp.asarray(x).astype(dtype), (2,) + out + (3,),
                         "bilinear")
    t = tpre.resize_bilinear(torch.from_numpy(x).to(getattr(torch, dtype)),
                             out)
    assert t.dtype == getattr(torch, dtype) and tuple(t.shape[1:3]) == out
    j = np.asarray(j.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(t.float().numpy(), j)
    else:
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)
    # antialiased: a 2-tap resize of the same image differs
    two_tap = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(two_tap - j).max() > 1e-3


VALIDATION = {
    "classify": (dict(task="classify"), dict()),
    "o2o": (dict(task="detect", o2o=True), dict()),
    "pose-without-flip": (dict(task="pose"), dict()),
    "flip-not-a-permutation": (dict(task="pose"),
                               dict(tta_kpt_flip_idx=(0,) * 17)),
    "segment-coefs-only": (dict(task="segment"), dict(emit_masks="none")),
    "no-views": (dict(task="detect"), dict(tta_views=())),
    "scale-above-one": (dict(task="detect"),
                        dict(tta_views=((2.0, False),))),
    "scale-zero": (dict(task="obb"), dict(tta_views=((0.0, True),))),
    "scaled-segment": (dict(task="segment"),
                       dict(tta_views=jcompile.ULTRALYTICS_TTA_VIEWS)),
    "scaled-pose": (dict(task="pose"),
                    dict(tta_views=((0.5, False),),
                         tta_kpt_flip_idx=COCO17_FLIP)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_tta_validation_matches_jax(case):
    """Every check of the JAX build_pipeline(tta=True) raises in the port
    too, with the same message."""
    model, kw = VALIDATION[case]
    model = dict(model)
    task = model.pop("task")
    jcfg, tcfg = _configs(task, **model)
    with pytest.raises(ValueError) as jerr:
        jcompile.build_pipeline(jcfg, {}, tta=True, **kw)
    with pytest.raises(ValueError) as terr:
        tcompile.build_pipeline(tcfg, tcompile.yolo11.YOLO11(tcfg.model),
                                device="cpu", tta=True, **kw)
    assert str(terr.value) == str(jerr.value)


def test_wbf_and_the_ensemble_stay_refused():
    """Once refused (the name is kept): TTA under merge="wbf" fuses the
    views' candidates as the JAX package's does, and the ensemble builds
    and keeps JAX's validation."""
    frames = np.random.default_rng(4).integers(0, 256, (1, 48, 64, 3),
                                               np.uint8)
    jcfg, tcfg = _configs("detect")
    jcfg = jconfig.ExecutorConfig(model=jcfg.model, post=jconfig.
                                  PostprocessConfig(merge="wbf", **POST))
    tcfg = tconfig.ExecutorConfig(model=tcfg.model, post=tconfig.
                                  PostprocessConfig(merge="wbf", **POST))
    p = detecting_tree(jcfg.model)
    kw = dict(frame_hw=(48, 64), batch=1, tta=True)
    j = jax.device_get(jcompile.build_pipeline(jcfg, p, **kw)(
        jnp.asarray(frames)))
    t = tcompile.build_pipeline(tcfg, params_from_jax(p, tcfg.model),
                                device="cpu", **kw)(frames)
    assert int(t["count"][0]) > 0
    assert_tta_close(t, j)
    with pytest.raises(ValueError, match="non-empty"):
        tcompile.build_ensemble_pipeline(tcfg, [], device="cpu")