"""Planar yuv420 input of the port (xrseg_tpu_torch/ops/yuv.py and
build_pipeline(input_format="yuv420")) against the JAX package, on the CPU.

- yuv420_to_rgb: atol 1e-4 on 0..255 values (both sides compute the same
  float32 expressions; the clip is exact).
- rgb_to_yuv420_numpy: equal (the same numpy code on both sides).
- preprocess of float frames (what yuv420_to_rgb returns), stretch and
  letterbox: atol 1e-6 in float32.
- the pipeline on yuv420 frames: the slate checks of test_torch_pipeline
  (labels, valid, count, indices equal; boxes 1e-3 px; scores 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrseg_tpu.testing as jtesting
from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import preprocess as jpre
from xrseg_tpu.ops import yuv as jyuv
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.ops import preprocess as tpre
from xrseg_tpu_torch.ops import yuv as tyuv
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32")
POST = dict(iou_threshold=0.6, score_threshold=0.3)
FRAME_HW = (48, 64)


def _planes(B, hw, seed):
    rng = np.random.default_rng(seed)
    H, W = hw
    return (rng.integers(0, 256, (B, H, W), np.uint8),
            rng.integers(0, 256, (B, H // 2, W // 2), np.uint8),
            rng.integers(0, 256, (B, H // 2, W // 2), np.uint8))


@pytest.mark.parametrize("hw", [(2, 2), (48, 64), (30, 18)])
def test_yuv420_to_rgb_matches_jax(hw):
    y, u, v = _planes(2, hw, seed=hw[0])
    j = np.asarray(jyuv.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(u),
                                      jnp.asarray(v)))
    t = tyuv.yuv420_to_rgb(*(torch.from_numpy(p) for p in (y, u, v)))
    assert t.dtype == torch.float32 and t.shape == (2,) + hw + (3,)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0)
    assert float(t.min()) >= 0.0 and float(t.max()) <= 255.0
    assert float(t.max()) == 255.0        # saturated chroma clips


def test_rgb_to_yuv420_numpy_matches_jax():
    rgb = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3),
                                            np.uint8)
    for a, b in zip(tyuv.rgb_to_yuv420_numpy(rgb),
                    jyuv.rgb_to_yuv420_numpy(rgb)):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["stretch", "letterbox"])
@pytest.mark.parametrize("hw", [(48, 64), (64, 64)])
def test_preprocess_takes_float_frames(mode, hw):
    x = np.random.default_rng(6).uniform(0, 255, (2,) + hw + (3,)) \
        .astype(np.float32)
    j = np.asarray(jpre.preprocess(jnp.asarray(x), (64, 64), mode=mode,
                                   dtype=jnp.float32))
    t = tpre.preprocess(torch.from_numpy(x), (64, 64), mode=mode,
                        dtype=torch.float32)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.ModelConfig(**MODEL)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        p = jtesting.detection_params(jax.random.key(0), jcfg)
    finally:
        mp.undo()
    return jax.device_get(p)


def _configs():
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**MODEL),
                                   post=jconfig.PostprocessConfig(**POST)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL),
                                   post=tconfig.PostprocessConfig(**POST)))


@pytest.mark.parametrize("resize_mode", ["stretch", "letterbox"])
def test_yuv420_pipeline_matches_jax(weights, resize_mode):
    jcfg, tcfg = _configs()
    rgb = np.random.default_rng(7).integers(0, 256, (2,) + FRAME_HW + (3,),
                                            np.uint8)
    planes = tyuv.rgb_to_yuv420_numpy(rgb)
    j = jax.device_get(jcompile.build_pipeline(
        jcfg, weights, frame_hw=FRAME_HW, batch=2, input_format="yuv420",
        resize_mode=resize_mode)(tuple(jnp.asarray(p) for p in planes)))
    pipe = tcompile.build_pipeline(
        tcfg, params_from_jax(weights, tcfg.model), frame_hw=FRAME_HW,
        batch=2, input_format="yuv420", resize_mode=resize_mode,
        device="cpu")
    t = pipe(planes)
    assert int(t["count"].min()) == 50
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(t["boxes_xywh"].numpy(), j["boxes_xywh"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"].numpy(), j["scores"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(t["masks"].numpy(), j["masks"], atol=1e-4,
                               rtol=0)


def test_yuv420_warmup_feeds_planes(weights):
    _, tcfg = _configs()
    pipe = tcompile.build_pipeline(
        tcfg, params_from_jax(weights, tcfg.model), frame_hw=FRAME_HW,
        batch=3, input_format="yuv420", device="cpu")
    y, u, v = pipe.dummy_input()
    assert y.shape == (3, 48, 64) and u.shape == v.shape == (3, 24, 32)
    assert pipe.warmup() is pipe
    with pytest.raises(ValueError, match="input_format"):
        tcompile.build_pipeline(tcfg, pipe.params, input_format="nv12",
                                device="cpu")
