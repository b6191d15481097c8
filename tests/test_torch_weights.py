"""The port's weight files (xrseg_tpu_torch/io/weights.py) against the JAX
package's (xrseg_tpu/io/weights.py), on the CPU.

- A file either package writes, the other reads: the flat npz keys and
  arrays are EQUAL, and the pipelines built from what each side read give
  the slate of the bridged params (labels, valid, count, indices equal;
  boxes 1e-3 px, scores 1e-5, as test_torch_pipeline).
- int8: q and scale bit-equal to JAX's quantize_int8; a pipeline on the
  dequantized npz equals JAX's pipeline on its own dequantized params
  (same tolerances; the dequantized weights are equal bit for bit).
- cast_params("bfloat16"): every weight and bias holds the value of the
  JAX cast, bit for bit; weights are stored in bf16, biases in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrseg_tpu.testing as jtesting
from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.io import weights as jw
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32")
POST = dict(iou_threshold=0.6, score_threshold=0.3)


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


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                             np.uint8)


def _configs():
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**MODEL),
                                   post=jconfig.PostprocessConfig(**POST)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL),
                                   post=tconfig.PostprocessConfig(**POST)))


def _jax_det(params, frames):
    jcfg, _ = _configs()
    return jax.device_get(jcompile.build_pipeline(
        jcfg, params, frame_hw=(48, 64), batch=2)(jnp.asarray(frames)))


def _torch_det(model, frames):
    _, tcfg = _configs()
    return tcompile.build_pipeline(tcfg, model, frame_hw=(48, 64), batch=2,
                                   device="cpu")(frames)


def _assert_slate_close(t, j):
    assert int(t["count"].min()) == 50
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(t["boxes_xywh"].numpy(), j["boxes_xywh"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"].numpy(), j["scores"], atol=1e-5,
                               rtol=0)


def _assert_flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_to_tree_inverts_the_bridge(weights):
    _, tcfg = _configs()
    tree = tw.params_to_tree(params_from_jax(weights, tcfg.model))
    _assert_flat_equal(tw.flatten_params(tree), jw.flatten_params(weights))
    # lists stay lists, as in the JAX tree
    assert isinstance(tree["det"]["cv2"], list)


def test_jax_npz_read_by_the_port(weights, frames, tmp_path):
    _, tcfg = _configs()
    path = str(tmp_path / "jax.npz")
    jw.save_npz(path, weights)
    model, cfg = tw.load_params_auto(path, tcfg.model)
    assert cfg is tcfg.model and isinstance(model, ty.YOLO11)
    _assert_slate_close(_torch_det(model, frames),
                        _jax_det(weights, frames))


def test_port_npz_read_by_jax(weights, frames, tmp_path):
    _, tcfg = _configs()
    path = str(tmp_path / "port.npz")
    tw.save_npz(path, params_from_jax(weights, tcfg.model))
    back = jw.load_npz(path)
    _assert_flat_equal(jw.flatten_params(jax.device_get(back)),
                       jw.flatten_params(weights))
    _assert_slate_close(_torch_det(params_from_jax(weights, tcfg.model),
                                   frames),
                        _jax_det(back, frames))


def test_quantize_int8_bit_equal_to_jax(weights):
    _, tcfg = _configs()
    jq = jax.device_get(jw.quantize_int8(weights))
    tq = tw.quantize_int8(params_from_jax(weights, tcfg.model))
    jf, tf = jw.flatten_params(jq), tw.flatten_params(tq)
    _assert_flat_equal(tf, jf)
    assert tf["b0/w/q"].dtype == np.int8 and tf["b0/w/scale"].ndim == 1
    assert tw.quantized_size_bytes(tq) == jw.quantized_size_bytes(jq)
    assert tw.quantized_size_bytes(tq) < 0.3 * tw.quantized_size_bytes(
        weights)
    deq_t = tw.flatten_params(tw.dequantize_int8(tq))
    deq_j = jw.flatten_params(jax.device_get(jw.dequantize_int8(jq)))
    _assert_flat_equal(deq_t, deq_j)


def test_dequantized_pipeline_matches_jax(weights, frames, tmp_path):
    """A JAX-written int8 npz dequantizes on load in the port, and the
    pipeline equals JAX's on its own dequantized params."""
    _, tcfg = _configs()
    jq = jw.quantize_int8(weights)
    path = str(tmp_path / "int8.npz")
    jw.save_npz(path, jq)
    assert "b0/w/q" in np.load(path).files
    model, _ = tw.load_params_auto(path, tcfg.model)
    _assert_slate_close(_torch_det(model, frames),
                        _jax_det(jax.device_get(jw.dequantize_int8(jq)),
                                 frames))


@pytest.mark.parametrize("name", ["w.sentis", "w.onnx", "w.pt", "w.pth",
                                  "orbax_dir"])
def test_load_params_auto_refuses_other_formats(name, tmp_path):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="item 13"):
        tw.load_params_auto(str(tmp_path / name), tcfg.model)


def test_load_npz_is_strict(weights, tmp_path):
    path = str(tmp_path / "seg.npz")
    jw.save_npz(path, weights)
    other = tconfig.ModelConfig(input_size=(64, 64), num_classes=3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tw.load_npz(path, other)
    detect = tconfig.ModelConfig(input_size=(64, 64), task="detect")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tw.load_npz(path, detect)


def test_cast_params_bf16_equals_jax_cast(weights):
    _, tcfg = _configs()
    model = params_from_jax(weights, tcfg.model)
    cast = tw.cast_params(model, "bfloat16")
    assert model.b0.weight.dtype == torch.float32        # a copy
    for m in cast.modules():
        if isinstance(m, L.Conv):
            assert m.weight.dtype == torch.bfloat16
            assert m.bias.dtype == torch.float32
        if isinstance(m, L.Proto):
            assert m.up_w.dtype == torch.bfloat16
            assert m.up_b.dtype == torch.float32
    jcast = jax.device_get(jw.cast_params(weights, jnp.bfloat16))
    want = {k: np.asarray(v, np.float32)
            for k, v in jw.flatten_params(jcast).items()}
    _assert_flat_equal(tw.flatten_params(tw.params_to_tree(cast)), want)
    assert tw.quantized_size_bytes(cast) < tw.quantized_size_bytes(model)
    back = tw.cast_params(cast, "float32")
    assert back.b0.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="params_dtype"):
        tw.cast_params(model, "float16")


def test_params_match_config_and_o2o_seed_match_jax(weights):
    jcfg = jconfig.ModelConfig(**MODEL)
    cases = [jcfg, jconfig.ModelConfig(**MODEL, o2o=True),
             jconfig.ModelConfig(**MODEL, num_classes=3),
             jconfig.ModelConfig(**MODEL, task="detect")]
    for c in cases:
        tc = tconfig.ModelConfig(**{f: getattr(c, f) for f in (
            "input_size", "dtype", "o2o", "num_classes", "task")})
        assert tw.params_match_config(weights, tc) == \
            jw.params_match_config(weights, c), c
    dual = dict(weights, det_o2o=jax.tree.map(np.zeros_like, weights["det"]))
    tseed = tw.maybe_seed_o2o(dict(dual), tconfig.ModelConfig(
        **MODEL, o2o=True))
    jseed = jax.device_get(jw.maybe_seed_o2o(dict(dual), jconfig.ModelConfig(
        **MODEL, o2o=True)))
    _assert_flat_equal(tw.flatten_params(tseed), jw.flatten_params(jseed))
    assert tw.donor_num_classes(weights) == jw.donor_num_classes(weights)
