"""The port's frame pipeline (xrseg_tpu_torch/compile.py) against the JAX
package's build_pipeline, on weights from xrseg_tpu.testing.detection_params
carried across by io/bridge.py, on the CPU.

The model runs in float32 so the score order is the same on both sides
(detection_params spreads the scores by ~0.3 over 84 anchors at 64x64,
far beyond float32 differences). Compared per slate:
- labels, valid, count, indices: equal;
- boxes_xywh: atol 1e-3 px; scores: atol 1e-5; masks: atol 1e-4. Both
  sides compute in float32; the conv stacks differ in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrseg_tpu.testing as jtesting
from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import postprocess as jpost
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.ops import postprocess as tpost
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32")
POST = dict(iou_threshold=0.6, score_threshold=0.3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.ModelConfig(**MODEL)
    # the fixture's init, jitted (the same function, compiled once)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        p = jtesting.detection_params(jax.random.key(0), jcfg)
    finally:
        mp.undo()
    return jax.device_get(p)


def _configs(**post):
    kw = dict(POST, **post)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**MODEL),
                                   post=jconfig.PostprocessConfig(**kw)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL),
                                   post=tconfig.PostprocessConfig(**kw)))


def _frames(B, hw=(48, 64), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B,) + hw + (3,),
                                                np.uint8)


def _assert_det_close(t, j, keys):
    j = jax.device_get(j)
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(t["boxes_xywh"].numpy(), j["boxes_xywh"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"].numpy(), j["scores"], atol=1e-5,
                               rtol=0)
    for k in keys:
        np.testing.assert_allclose(t[k].float().numpy(),
                                   np.asarray(j[k]).astype(np.float32),
                                   atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(t["slate"].numpy(), j["slate"], atol=1e-3,
                               rtol=0)


VARIANTS = {
    "stretch": dict(),
    "letterbox_crop": dict(resize_mode="letterbox", crop_masks=True),
    "emit_none": dict(emit_masks="none"),
    "bf16_masks": dict(mask_dtype="bfloat16"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pipeline_matches_jax(weights, variant):
    kw = VARIANTS[variant]
    jcfg, tcfg = _configs()
    frames = _frames(2)
    j = jcompile.build_pipeline(jcfg, weights, frame_hw=(48, 64), batch=2,
                                **kw)(jnp.asarray(frames))
    pipe = tcompile.build_pipeline(tcfg, params_from_jax(weights,
                                                         tcfg.model),
                                   frame_hw=(48, 64), batch=2,
                                   device="cpu", **kw)
    t = pipe(frames)
    assert int(t["count"].min()) == 50          # the fixture always detects
    keys = ["coefs"] + (["protos"] if kw.get("emit_masks") == "none"
                        else ["masks"])
    assert set(t) == set(jax.device_get(j))
    _assert_det_close(t, j, keys)
    if kw.get("mask_dtype"):
        assert t["masks"].dtype == torch.bfloat16


def test_pipeline_backends_agree_on_cpu(weights):
    """nms_backend "cuda" (plain version for CPU tensors), "scan" and
    "auto" give the same slate."""
    frames = _frames(2, seed=1)
    slates = []
    for backend in ("auto", "scan", "cuda"):
        _, tcfg = _configs(nms_backend=backend)
        pipe = tcompile.build_pipeline(
            tcfg, params_from_jax(weights, tcfg.model), frame_hw=(48, 64),
            batch=2, device="cpu")
        slates.append(pipe(frames)["slate"])
    assert torch.equal(slates[0], slates[1])
    assert torch.equal(slates[0], slates[2])


@pytest.mark.parametrize("pre_topk", [0, 32])
def test_postprocess_b1_matches_jax(weights, pre_topk):
    """The b=1 entry point (concatenated preds, sigmoid scores), including
    the pre_topk compaction of the single-image path."""
    jcfg, tcfg = _configs(pre_nms_topk=pre_topk)
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    out = jax.device_get(jy.forward(weights, jnp.asarray(x), jcfg.model))
    j = jpost.postprocess(jnp.asarray(out["preds"]),
                          jnp.asarray(out["protos"]), jcfg.post)
    t = tpost.postprocess(out["preds"], out["protos"], tcfg.post,
                          device="cpu")
    _assert_det_close(dict(t, slate=tcompile.pack_slate(t, 50)),
                      dict(j, slate=jcompile.pack_slate(j, 50)),
                      ["coefs", "masks"])


def test_unpack_slate_round_trip(weights):
    _, tcfg = _configs()
    pipe = tcompile.load_model(tcfg, params_from_jax(weights, tcfg.model),
                               device="cpu", frame_hw=(48, 64))
    det = pipe(_frames(1))
    h = tcompile.unpack_slate(det["slate"][0], 50)
    np.testing.assert_array_equal(h["boxes_xywh"],
                                  det["boxes_xywh"][0].numpy())
    np.testing.assert_array_equal(h["labels"], det["labels"][0].numpy())
    assert h["count"] == int(det["count"][0])


@pytest.mark.parametrize("option", [
    dict(), dict(input_format="yuv420"),
    dict(mask_display_hw=(48, 64)), dict(params_dtype="bfloat16")])
def test_unported_options_refused(option, weights):
    """tta was refused until it was ported; now tta with each of the
    ported options matches the JAX pipeline (2 views, masks from each
    survivor's own view)."""
    jcfg, tcfg = _configs()
    frames = _frames(2, seed=3)
    if option.get("input_format") == "yuv420":
        from xrseg_tpu_torch.ops.yuv import rgb_to_yuv420_numpy
        planes = rgb_to_yuv420_numpy(frames)
        jin, tin = tuple(jnp.asarray(p) for p in planes), planes
    else:
        jin, tin = jnp.asarray(frames), frames
    j = jcompile.build_pipeline(jcfg, weights, frame_hw=(48, 64), batch=2,
                                tta=True, **option)(jin)
    t = tcompile.build_pipeline(tcfg, params_from_jax(weights, tcfg.model),
                                frame_hw=(48, 64), batch=2, device="cpu",
                                tta=True, **option)(tin)
    assert int(t["count"].min()) == 50
    assert set(t) == set(jax.device_get(j))
    _assert_det_close(t, j, ["coefs", "masks"])


def test_wbf_merge_refused():
    _, tcfg = _configs(merge="wbf")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcompile.build_pipeline(tcfg, tcompile.yolo11.YOLO11(tcfg.model),
                                device="cpu")


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    _, tcfg = _configs()
    model = tcompile.yolo11.YOLO11(tcfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcompile.build_pipeline(tcfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpost.postprocess(np.zeros((1, 84, 116), np.float32), None,
                          tcfg.post)
    other = dataclasses.replace(tcfg.model, input_size=(96, 96))
    with pytest.raises(ValueError, match="ModelConfig"):
        tcompile.build_pipeline(dataclasses.replace(tcfg, model=other),
                                model, device="cpu")
