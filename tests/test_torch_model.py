"""Port YOLO11 forward (xrseg_tpu_torch/models/yolo11.py) against
xrseg_tpu.models.yolo11.forward(concat_preds=False).

Weights: the JAX init's pytree structure (eval_shape, not run) with every
leaf drawn from a numpy seed at fan-in scale (so activations neither
vanish nor explode through the depth), carried across by io/bridge.py.
The input is non-square (64 x 96) so a swapped H/W or a scrambled anchor
axis cannot pass.

Tolerances, relative to each output's max magnitude:
- float32: 2e-5. Both sides compute in float32; conv summation orders
  differ and the differences compound over ~60 layers.
- bfloat16: 6e-2. The JAX conv rounds once (f32 accumulation, bias and
  SiLU in f32, then bf16); a torch bf16 conv also rounds its output before
  the bias, so single-rounding differences (2^-8 relative) compound
  through the depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JModelConfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

SIZE = (64, 96)
_jax_forward = jax.jit(jy.forward, static_argnames=("cfg", "concat_preds"))


def _jax_params(cfg: JModelConfig, seed: int = 0):
    tree = jax.eval_shape(lambda k: jy.init_params(k, cfg),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if a.ndim == 4:     # HWIO conv / [kH,kW,I,O] transposed conv
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            std = (1.0 / fan_in) ** 0.5 * (1.0 if name == "up_w" else 1.5)
        else:
            std = 0.1
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _configs(dtype, task="segment"):
    kw = dict(input_size=SIZE, dtype=dtype, task=task)
    return JModelConfig(**kw), ModelConfig(**kw)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(7).uniform(
        0, 1, (2,) + SIZE + (3,)).astype(np.float32)


def _compare(jcfg, tcfg, x, tol, seed=0):
    p = _jax_params(jcfg, seed)
    j = jax.device_get(_jax_forward(p, jnp.asarray(x), cfg=jcfg,
                                    concat_preds=False))
    model = params_from_jax(p, tcfg)
    with torch.no_grad():
        t = model(torch.from_numpy(x), concat_preds=False)
    assert set(t) == set(j), (set(t), set(j))
    for k in sorted(j):
        a = np.asarray(j[k]).astype(np.float32)
        b = t[k].float().numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-6)
        assert err < tol, (k, err)
    return t, j


@pytest.mark.parametrize("task", ["segment", "detect"])
def test_forward_f32_matches_jax(x, task):
    jcfg, tcfg = _configs("float32", task)
    t, _ = _compare(jcfg, tcfg, x, 2e-5)
    assert t["scores"].std() > 1e-3       # the weights make real activity


def test_forward_bf16_matches_jax(x):
    jcfg, tcfg = _configs("bfloat16")
    t, _ = _compare(jcfg, tcfg, x, 6e-2)
    assert t["cls_logits"].dtype == torch.bfloat16
    assert t["protos"].dtype == torch.float32


def test_concat_preds_layout(x):
    jcfg, tcfg = _configs("float32")
    model = params_from_jax(_jax_params(jcfg), tcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    A = tcfg.num_anchors
    assert out["preds"].shape == (2, A, 4 + 80 + 32)
    torch.testing.assert_close(out["preds"], torch.cat(
        [out["boxes_xywh"], out["scores"], out["mask_coefs"]], -1),
        rtol=0, atol=0)
    assert out["protos"].shape == (2, SIZE[0] // 4, SIZE[1] // 4, 32)


def test_make_anchors_matches_jax():
    for a, b in zip(ty.make_anchors(SIZE), jy.make_anchors(SIZE)):
        np.testing.assert_array_equal(a, b)


def test_dfl_decode_matches_jax():
    z = np.random.default_rng(3).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        ty.dfl_decode(torch.from_numpy(z), 16).numpy(),
        np.asarray(jy.dfl_decode(jnp.asarray(z), 16)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", ["n", "s", "m"])
def test_param_count_matches_jax(scale):
    """Every scale builds the same parameter shapes as the JAX init."""
    jcfg = JModelConfig(scale=scale)
    tree = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                          jax.random.key(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    model = ty.YOLO11(ModelConfig(scale=scale))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_init_params_is_seeded():
    cfg = ModelConfig(input_size=(64, 64))
    a = ty.init_params(torch.Generator().manual_seed(3), cfg)
    b = ty.init_params(torch.Generator().manual_seed(3), cfg)
    c = ty.init_params(torch.Generator().manual_seed(4), cfg)
    for (k, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), k
    assert not torch.equal(a.b0.weight, c.b0.weight)


@pytest.mark.parametrize("change", [dict(arch="yolov8"), dict(task="pose"),
                                    dict(task="classify"),
                                    dict(task="pose", o2o=True)])
def test_unported_options_refused(change):
    """These options were refused until the task family was ported. Now
    yolov8, pose and classify build and load the JAX init's structure
    strictly, and pose with the one-to-one head is a ValueError, as JAX
    raises it."""
    cfg = dataclasses.replace(ModelConfig(input_size=(64, 64)), **change)
    jcfg = dataclasses.replace(JModelConfig(input_size=(64, 64)), **change)
    if change.get("o2o"):
        with pytest.raises(ValueError) as jerr:
            jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                           jax.random.key(0))
        with pytest.raises(ValueError) as terr:
            ty.YOLO11(cfg)
        assert str(terr.value) == str(jerr.value)
        return
    model = params_from_jax(_jax_params(jcfg), cfg)     # strict load
    assert model.cfg == cfg


def test_forward_rejects_wrong_input_size():
    model = ty.YOLO11(ModelConfig(input_size=(64, 64)))
    with pytest.raises(ValueError, match="input_size"):
        model(torch.zeros(1, 32, 64, 3))


def test_raw_outputs_onnx_layout_matches_jax():
    """The reference ONNX layout of preds and protos, against JAX's on the
    same seeded arrays."""
    rng = np.random.default_rng(0)
    out = {"preds": rng.standard_normal((2, 84, 116)).astype(np.float32),
           "protos": rng.standard_normal((2, 16, 24, 32)).astype(np.float32)}
    got = ty.raw_outputs_onnx_layout(
        {k: torch.from_numpy(v) for k, v in out.items()})
    want = jy.raw_outputs_onnx_layout(
        {k: jnp.asarray(v) for k, v in out.items()})
    assert [tuple(g.shape) for g in got] == [(2, 116, 84), (2, 32, 16, 24)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
