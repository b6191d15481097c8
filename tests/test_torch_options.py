"""The frame pipeline's serving options in the port against the JAX package,
on the CPU: display-resolution masks (mask_display_hw), bf16 weight
storage (params_dtype) and the NMS-free one-to-one head (ModelConfig.o2o).

Tolerances:
- upsample_masks: atol 1e-4 on sigmoid values in 0..1 (pure upsampling is
  plain bilinear; any shrinking axis is antialiased on both sides with
  the same triangle filter; float32 sums in another order).
- pipelines in float32 compute: the slate checks of test_torch_pipeline
  (labels, valid, count, indices equal; boxes 1e-3 px; scores 1e-5;
  masks 1e-4). With bf16 storage and float32 compute both sides run
  float32 on the same bf16-valued weights, so these hold unchanged.
- bf16 storage with bf16 compute: the raw heads within 6e-2 of each
  output's max magnitude, the bf16 tolerance of test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import xrseg_tpu.testing as jtesting
from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.io import weights as jw
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import masks as jmasks
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.ops import masks as tmasks
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32")
POST = dict(iou_threshold=0.6, score_threshold=0.3)
FRAME_HW = (48, 64)


@pytest.mark.parametrize("out_hw", [(240, 240), (96, 96), (120, 200)],
                         ids=["up", "down", "mixed"])
def test_upsample_masks_matches_jax(out_hw):
    m = np.random.default_rng(1).uniform(0, 1, (3, 160, 160)) \
        .astype(np.float32)
    j = np.asarray(jmasks.upsample_masks(jnp.asarray(m), out_hw))
    t = tmasks.upsample_masks(torch.from_numpy(m), out_hw)
    assert t.shape == (3,) + out_hw
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0)
    tb = tmasks.upsample_masks(torch.from_numpy(m)[None].repeat(2, 1, 1, 1),
                               out_hw)
    assert tb.shape == (2, 3) + out_hw and torch.equal(tb[1], t)


def _detection_weights(cfg):
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        return jax.device_get(jtesting.detection_params(jax.random.key(0),
                                                        cfg))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def weights():
    return _detection_weights(jconfig.ModelConfig(**MODEL))


@pytest.fixture(scope="module")
def o2o_weights():
    """JAX init with o2o=True, `det` from detection_params and `det_o2o`
    seeded from it, as the JAX loaders seed a one-head artifact."""
    p = _detection_weights(jconfig.ModelConfig(**MODEL, o2o=True))
    return jw.maybe_seed_o2o(p, jconfig.ModelConfig(**MODEL, o2o=True))


def _configs(model=MODEL, **post):
    kw = dict(POST, **post)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**model),
                                   post=jconfig.PostprocessConfig(**kw)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**model),
                                   post=tconfig.PostprocessConfig(**kw)))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2,) + FRAME_HW + (3,),
                                             np.uint8)


def _both(params, frames, model=MODEL, post=None, **kw):
    jcfg, tcfg = _configs(model, **(post or {}))
    j = jax.device_get(jcompile.build_pipeline(
        jcfg, params, frame_hw=FRAME_HW, batch=2, **kw)(jnp.asarray(frames)))
    t = tcompile.build_pipeline(tcfg, params_from_jax(params, tcfg.model),
                                frame_hw=FRAME_HW, batch=2, device="cpu",
                                **kw)(frames)
    assert set(t) == set(j)
    return t, j


def _assert_slate_close(t, j, keys=("masks",)):
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


@pytest.mark.parametrize("display_hw", [(48, 64), (8, 12)],
                         ids=["up", "down"])
def test_mask_display_hw_pipeline_matches_jax(weights, frames, display_hw):
    t, j = _both(weights, frames, mask_display_hw=display_hw)
    assert tuple(t["masks"].shape) == (2, 50) + display_hw
    _assert_slate_close(t, j)


def test_mask_display_hw_needs_all_masks(weights):
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="emit_masks"):
        tcompile.build_pipeline(tcfg, params_from_jax(weights, tcfg.model),
                                mask_display_hw=(48, 64), emit_masks="none",
                                device="cpu")


def test_bf16_storage_f32_compute_matches_jax(weights, frames):
    t, j = _both(weights, frames, params_dtype="bfloat16")
    assert int(t["count"].min()) == 50
    _assert_slate_close(t, j, keys=("masks", "coefs"))


def _random_jax_params(cfg, seed=0):
    """The JAX init's structure with fan-in-scaled numpy leaves (as
    test_torch_model.py), so activations stay alive through the depth."""
    tree = jax.eval_shape(lambda k: jy.init_params(k, cfg),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if a.ndim == 4:
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            std = (1.0 / fan_in) ** 0.5 * (
                1.0 if path[-1].key == "up_w" else 1.5)
        else:
            std = 0.1
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_bf16_storage_bf16_compute_matches_jax():
    kw = dict(input_size=(64, 96), dtype="bfloat16")
    jcfg, tcfg = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    p = _random_jax_params(jcfg)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 96, 3)) \
        .astype(np.float32)
    fwd = jax.jit(jy.forward, static_argnames=("cfg", "concat_preds"))
    j = jax.device_get(fwd(jw.cast_params(p, jnp.bfloat16), jnp.asarray(x),
                           cfg=jcfg, concat_preds=False))
    model = tw.cast_params(params_from_jax(p, tcfg), "bfloat16")
    with torch.no_grad():
        t = model(torch.from_numpy(x), concat_preds=False)
    for k in sorted(j):
        a = np.asarray(j[k]).astype(np.float32)
        err = np.abs(a - t[k].float().numpy()).max() / max(
            np.abs(a).max(), 1e-6)
        assert err < 6e-2, (k, err)


class _CastCounter(TorchDispatchMode):
    """Counts dtype conversions of parameters (the weight casts)."""

    def __init__(self, params):
        super().__init__()
        self.ids = {id(p) for p in params}
        self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default and \
                isinstance(args[0], torch.nn.Parameter):
            self.casts += 1
        return func(*args, **(kwargs or {}))


def test_bf16_storage_casts_no_weight_at_run_time():
    """Compute in bf16: f32 storage casts every conv weight (and the
    Proto's transposed-conv weight) once a call; bf16 storage casts none,
    and the biases, kept in f32, are never cast."""
    cfg = tconfig.ModelConfig(input_size=(64, 64))
    f32 = ty.init_params(torch.Generator().manual_seed(0), cfg)
    bf16 = tw.cast_params(f32, "bfloat16")
    n_weights = sum(isinstance(m, (L.Conv, L.Proto)) for m in f32.modules())
    x = torch.rand(1, 64, 64, 3)
    counts = []
    for model in (f32, bf16):
        with torch.no_grad(), _CastCounter(model.parameters()) as c:
            model(x)
        counts.append(c.casts)
    assert counts == [n_weights, 0]


def test_o2o_pipeline_matches_jax(o2o_weights, frames):
    model = dict(MODEL, o2o=True)
    t, j = _both(o2o_weights, frames, model=model)
    assert int(t["count"].min()) == 50
    _assert_slate_close(t, j, keys=("masks", "coefs"))
    t, j = _both(o2o_weights, frames, model=model, emit_masks="none")
    _assert_slate_close(t, j, keys=("coefs", "protos"))


def test_o2o_pads_the_slate_when_anchors_are_fewer(o2o_weights, frames):
    """64x64 has 84 anchors: a slate of 100 pads 16 rows with -inf."""
    model = dict(MODEL, o2o=True)
    t, j = _both(o2o_weights, frames, model=model,
                 post=dict(max_detections=100))
    assert t["count"].tolist() == [84, 84]
    assert not bool(t["valid"][:, 84:].any())
    assert bool((t["indices"][:, 84:] == 0).all())
    _assert_slate_close(t, j)


def test_o2o_head_and_refusals(o2o_weights):
    cfg = tconfig.ModelConfig(**MODEL, o2o=True)
    m = params_from_jax(o2o_weights, cfg)          # strict: det_o2o carried
    assert ty.count_params(m) == jy.count_params(o2o_weights)
    plain = ty.YOLO11(tconfig.ModelConfig(**MODEL))
    assert ty.count_params(m) > ty.count_params(plain)
    with pytest.raises(ValueError, match="o2o"):
        ty.YOLO11(tconfig.ModelConfig(**MODEL, o2o=True, task="obb"))
    with pytest.raises(RuntimeError, match="det_o2o"):   # strict load
        params_from_jax(o2o_weights, tconfig.ModelConfig(**MODEL))
    # a dual-head checkpoint's det alone serves the NMS path
    one = {k: v for k, v in o2o_weights.items() if k != "det_o2o"}
    _, tcfg = _configs()
    plain_pipe = tcompile.build_pipeline(tcfg, params_from_jax(one, tcfg.model),
                                         device="cpu")
    assert "o2o_boxes_xywh" not in plain_pipe.params(
        torch.zeros(1, 64, 64, 3), concat_preds=False)
