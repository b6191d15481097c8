"""The fused XR tick as a whole (xrseg_tpu_torch/compile.py
build_xr_tick_pipeline) against the JAX package's XRTickPipeline on the
same frame, depth frame and aux vector, on weights from
xrseg_tpu.testing.detection_params carried across by io/bridge.py, on the
CPU in float32.

Compared on the packed output, part by part:
- matched flag, matched index, labels, valid, count: EQUAL;
- slate: atol 1e-3 (boxes in pixels; the tolerance test_torch_pipeline.py
  uses in float32: the conv stacks differ in summation order);
- target mask and fused points: atol 1e-4 (a sigmoid of a 32-term product
  of those outputs; positions in metres on a constant 1.5 m depth frame,
  so a box that differs by 1e-3 px cannot move a depth sample).
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
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import yolo11 as ty

MODEL = dict(input_size=(64, 64), dtype="float32")
POST = dict(pre_nms_topk=64, max_detections=10, score_threshold=1e-7)
FRAME_HW, DEPTH_HW = (48, 64), (32, 32)
D = POST["max_detections"]


def _cfgs(**kw):
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**MODEL),
                                   post=jconfig.PostprocessConfig(**POST),
                                   **kw),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL),
                                   post=tconfig.PostprocessConfig(**POST),
                                   **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        jp = jax.device_get(jtesting.detection_params(jax.random.key(3),
                                                      jcfg.model))
    finally:
        mp.undo()
    return jp, params_from_jax(jp, tcfg.model)


@pytest.fixture(scope="module")
def pipes(models):
    jp, tp = models
    jcfg, tcfg = _cfgs()
    out = {}
    for emit in (True, False):
        out[emit] = (
            jcompile.build_xr_tick_pipeline(jcfg, jp, frame_hw=FRAME_HW,
                                            depth_hw=DEPTH_HW,
                                            emit_target_mask=emit),
            tcompile.build_xr_tick_pipeline(tcfg, tp, frame_hw=FRAME_HW,
                                            depth_hw=DEPTH_HW,
                                            emit_target_mask=emit,
                                            device="cpu"))
    return out


def _inputs(seed, prev):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (1,) + FRAME_HW + (3,), np.uint8)
    depth = np.full(DEPTH_HW, 1.5, np.float16).view(np.uint16)
    quat = np.array([0.1825742, 0.3651484, 0.5477226, 0.7302967], np.float32)
    aux = tcompile.XRTickPipeline.pack_aux(
        (440.0, 440.0), (640.0, 480.0), (1280, 960), (0.1, -0.2, 0.3), quat,
        prev, (FRAME_HW[1] / 64.0, FRAME_HW[0] / 64.0))
    return frame, depth, aux


def _run_both(jpipe, tpipe, frame, depth, aux):
    j = jpipe(jnp.asarray(frame), jnp.asarray(depth), jnp.asarray(aux))
    t = tpipe(frame, depth, aux)
    return np.asarray(j["packed"]), t["packed"].numpy(), j, t


def _locked_prev(tpipe, seed):
    """(cx, cy, label, 1) of slate row 3 of the frame itself."""
    frame, depth, aux = _inputs(seed, (0.0, 0.0, -1.0, 0.0))
    h = tpipe.unpack(tpipe(frame, depth, aux)["packed"])
    assert h["count"] == D and not h["matched"]
    return (*h["boxes_xywh"][3, :2], float(h["labels"][3]), 1.0)


@pytest.mark.parametrize("emit", [True, False], ids=["mask", "no_mask"])
def test_packed_equals_jax(pipes, emit):
    jpipe, tpipe = pipes[emit]
    prev = _locked_prev(tpipe, 0)
    jp, tp, j, t = _run_both(jpipe, tpipe, *_inputs(0, prev))
    assert tp.dtype == np.float32 and tp.shape == jp.shape
    assert tp.shape == (tpipe.packed_len,) == (
        D * 7 + 1 + 2 + (16 * 16 if emit else 0) + tpipe.n_points * 5,)
    hj, ht = jpipe.unpack(jp), tpipe.unpack(tp)
    assert bool(ht["matched"]) and bool(hj["matched"])
    assert ht["matched_index"] == hj["matched_index"] == 3
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
    assert ht["count"] == hj["count"] == D
    L = tpipe.slate_len
    np.testing.assert_allclose(tp[:L], jp[:L], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ht["scores"], hj["scores"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tp[L:L + 2], jp[L:L + 2])
    np.testing.assert_allclose(tp[L + 2:], jp[L + 2:], atol=1e-4, rtol=0)
    assert ("target_mask" in ht) == emit
    pts = ht["points_packed"]
    np.testing.assert_array_equal(pts[:, 4], hj["points_packed"][:, 4])
    assert pts[:, 4].sum() > 0 and (pts[pts[:, 4] > 0.5, 3] == 1.5).all()
    for k in ("coefs", "protos"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-4,
                                   rtol=0, err_msg=k)


def test_bf16_weight_storage_equals_jax(models):
    """params_dtype="bfloat16" in float32 compute: both sides run float32 on
    the same bf16-valued weights, so the tolerances above hold."""
    jp, tp = models
    jcfg, tcfg = _cfgs()
    jpipe = jcompile.build_xr_tick_pipeline(
        jcfg, jp, frame_hw=FRAME_HW, depth_hw=DEPTH_HW,
        params_dtype="bfloat16")
    tpipe = tcompile.build_xr_tick_pipeline(
        tcfg, tp, frame_hw=FRAME_HW, depth_hw=DEPTH_HW,
        params_dtype="bfloat16", device="cpu")
    assert tpipe.params.b0.weight.dtype == torch.bfloat16
    assert tp.b0.weight.dtype == torch.float32          # the caller's stays
    prev = _locked_prev(tpipe, 0)
    jpk, tpk, _, _ = _run_both(jpipe, tpipe, *_inputs(0, prev))
    hj, ht = jpipe.unpack(jpk), tpipe.unpack(tpk)
    assert bool(ht["matched"]) and ht["matched_index"] == hj["matched_index"]
    for k in ("labels", "valid", "count"):
        np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
    L = tpipe.slate_len
    np.testing.assert_allclose(tpk[:L], jpk[:L], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tpk[L:], jpk[L:], atol=1e-4, rtol=0)


def test_unmatched_tick_zeroes_mask_and_points(pipes):
    jpipe, tpipe = pipes[True]
    jp, tp, _, _ = _run_both(jpipe, tpipe,
                             *_inputs(1, (0.0, 0.0, -1.0, 0.0)))
    h = tpipe.unpack(tp)
    assert not h["matched"] and h["matched_index"] == 0
    assert (h["target_mask"] == 0).all() and (h["points_packed"] == 0).all()
    L = tpipe.slate_len
    np.testing.assert_array_equal(tp[L:], jp[L:])
    np.testing.assert_allclose(tp[:L], jp[:L], atol=1e-3, rtol=0)


def test_pack_unpack_round_trip_and_copies(pipes):
    _, tpipe = pipes[True]
    rng = np.random.default_rng(5)
    parts = dict(focal=rng.uniform(1, 2, 2), principal=rng.uniform(1, 2, 2),
                 sensor=(1280, 960), cam_pos=rng.uniform(-1, 1, 3),
                 cam_quat=rng.uniform(-1, 1, 4), prev=(1.0, 2.0, 3.0, 1.0),
                 screen_scale=(1.5, 0.75))
    aux = tpipe.pack_aux(*parts.values())
    assert aux.dtype == np.float32 and aux.shape == (tpipe.AUX_LEN,) == (19,)
    want = np.concatenate([np.asarray(v, np.float32).ravel()
                           for v in parts.values()])
    np.testing.assert_array_equal(aux, want)
    np.testing.assert_array_equal(
        aux, jcompile.XRTickPipeline.pack_aux(*parts.values()))

    packed = rng.uniform(0, 1, tpipe.packed_len).astype(np.float32)
    packed[D * 4 + D:D * 6] = rng.integers(0, 3, D)    # labels
    packed[D * 7] = 7.0                                # count
    packed[tpipe.slate_len:tpipe.slate_len + 2] = (1.0, 4.0)
    h = tpipe.unpack(packed)
    again = np.concatenate([
        h["boxes_xywh"].ravel(), h["scores"], h["labels"].astype(np.float32),
        packed[D * 6:D * 7], [float(h["count"])],
        [float(h["matched"]), float(h["matched_index"])],
        h["target_mask"].ravel(), h["points_packed"].ravel()])
    np.testing.assert_array_equal(again, packed)
    np.testing.assert_array_equal(h["valid"], packed[D * 6:D * 7] > 0.5)
    # what unpack returns is a copy: the readback buffer is overwritten by
    # the next tick
    kept = h["points_packed"].copy()
    packed[:] = -1.0
    np.testing.assert_array_equal(h["points_packed"], kept)
    assert h["boxes_xywh"][0, 0] != -1.0


def test_readback_on_the_cpu_is_a_plain_copy(pipes):
    _, tpipe = pipes[True]
    out = tpipe(*_inputs(2, _locked_prev(tpipe, 2)))
    rb = tpipe.readback
    rb.start(out["packed"])
    assert rb.stream is None and rb.computed() and rb.copied()
    np.testing.assert_array_equal(rb.host(), out["packed"].numpy())
    with pytest.raises(ValueError, match="readback"):
        rb.start(out["packed"][:-1])


def test_build_refusals(models):
    _, tp = models
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="params_dtype"):
        tcompile.build_xr_tick_pipeline(tcfg, tp, params_dtype="int8",
                                        device="cpu")
    det = tconfig.ExecutorConfig(
        model=tconfig.ModelConfig(task="detect", **MODEL))
    with pytest.raises(ValueError, match="segment"):
        tcompile.build_xr_tick_pipeline(
            det, ty.init_params(torch.Generator().manual_seed(0), det.model),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcompile.build_xr_tick_pipeline(tcfg, tp)   # the card by default
