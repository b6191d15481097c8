"""The port's Executor and XRLoop (xrseg_tpu_torch/runtime) on the CPU
(device="cpu": no streams, the readback is a plain copy and both of its
polls are true at once), and against the JAX package's Executor on the
same frames with the same weights (io/bridge.py).

Every wait has a deadline in seconds. Compared with the JAX executor: the
tracked slate index and the number of fused points, EQUAL (the models run
in float32 and detection_params spreads the scores far beyond float32
differences; the masks differ by ~1e-5 and no sampled value sits that
close to the 0.5 gate on these seeds); depths equal (constant fp16
frame).
"""
import time

import jax
import numpy as np
import pytest
import torch

import xrseg_tpu.testing as jtesting
from xrseg_tpu import config as jconfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.perception import camera as jcamera
from xrseg_tpu.runtime import executor as jexecutor
from xrseg_tpu.runtime import frame_source as jframes
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.perception.camera import (CameraIntrinsics, Pose,
                                               quat_identity)
from xrseg_tpu_torch.perception.rgbd import PointCloudExtractor
from xrseg_tpu_torch.runtime.executor import ExecState, Executor, FrameResult
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.xr_loop import (ControllerState, XRLoop,
                                             aim_controller_at_frame_point)
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

MODEL = dict(scale="n", input_size=(64, 64), dtype="float32")
POST = dict(pre_nms_topk=64, max_detections=10, score_threshold=1e-7)
DEADLINE_S = 60.0


def _cfg(mod=tconfig, **kw):
    return mod.ExecutorConfig(model=mod.ModelConfig(**MODEL),
                              post=mod.PostprocessConfig(**POST), **kw)


def _frame(seed=0, t=0.0, hw=(64, 64), depth=True, mods=None):
    frame_cls, pose_cls, intr_cls, ident = mods or (
        FrameData, Pose, CameraIntrinsics, quat_identity)
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 255, hw + (3,), np.uint8)
    if not depth:
        return frame_cls(rgb=rgb, timestamp=t)
    return frame_cls(rgb=rgb, timestamp=t,
                     pose=pose_cls(np.zeros(3, np.float32), ident()),
                     intrinsics=intr_cls.quest3_like(),
                     depth_fp16=np.full((32, 32), 1.5,
                                        np.float16).view(np.uint16))


JAX_MODS = (jframes.FrameData, jcamera.Pose, jcamera.CameraIntrinsics,
            jcamera.quat_identity)


@pytest.fixture(scope="module")
def weights():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        jp = jax.device_get(jtesting.detection_params(
            jax.random.key(3), jconfig.ModelConfig(**MODEL)))
    finally:
        mp.undo()
    return jp, params_from_jax(jp, tconfig.ModelConfig(**MODEL))


def _executor(weights, **kw):
    ex_kw = {k: kw.pop(k) for k in ("auto_recompile", "max_cached_pipelines")
             if k in kw}
    return Executor(_cfg(**kw), params=weights[1], frame_hw=(64, 64),
                    device="cpu", **ex_kw)


def _drain(ex, states=None):
    """update() until a result, within the deadline; then CLEANUP ->
    COMPLETED. Records the states passed through."""
    deadline = time.monotonic() + DEADLINE_S
    result = None
    while result is None:
        assert time.monotonic() < deadline, f"no result, state {ex.state}"
        if states is not None and (not states or states[-1] != ex.state):
            states.append(ex.state)
        result = ex.update()
    for _ in range(2):
        if states is not None and states[-1] != ex.state:
            states.append(ex.state)
        if ex.state != ExecState.COMPLETED:
            ex.update()
    return result


def _select_first(ex, r0):
    b = r0.boxes[0]
    assert ex.select_target_from_screen_pos(
        (b.center_x + ex.screen_wh[0] / 2, b.center_y + ex.screen_wh[1] / 2))


def _drive(ex, frame_mods=None, n=4):
    """Select the first detection, then track n frames:
    [(tracked index, point count, sorted depths)]."""
    r0 = ex.run_sync(_frame(0, mods=frame_mods))
    assert r0.count > 0
    _select_first(ex, r0)
    out = []
    for i in range(1, n + 1):
        r = ex.run_sync(_frame(i, t=i / 30, mods=frame_mods))
        pc = r.point_cloud
        out.append((r.tracked.index if r.tracked is not None else -1,
                    len(pc.positions) if pc is not None else 0,
                    np.sort(pc.depths) if pc is not None else np.zeros(0)))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["classic", "fused"])
def test_state_order_and_busy_refusal(weights, fused):
    ex = _executor(weights, fused_tick=fused)
    assert ex.state == ExecState.IDLE and not ex.is_running()
    assert ex.run_inference(_frame(0))
    assert ex.state == ExecState.RUNNING and ex.is_running()
    assert ex._readback is (ex._inflight_tick_pipe if fused
                            else ex.pipeline).readback   # copy queued
    assert not ex.run_inference(_frame(1))            # busy: refused
    states = []
    r = _drain(ex, states)
    assert states == [ExecState.RUNNING, ExecState.REQUESTING_OUTPUTS,
                      ExecState.SUCCESS, ExecState.CLEANUP,
                      ExecState.COMPLETED]
    assert isinstance(r, FrameResult) and r.count == POST["max_detections"]
    assert len(r.boxes) == r.count and r.latency_s > 0
    assert ex.last_result is r and not ex.is_running()
    assert ex.run_inference(_frame(2))                # re-armed
    _drain(ex)
    s = ex.tracer.summary()
    for stage in ("load_model", "dispatch", "device_wait", "readback",
                  "process"):
        assert s[stage]["count"] >= 1, stage
    assert s["counters"]["frames_dispatched"] == 2
    with pytest.raises(RuntimeError, match="busy"):
        ex.run_inference(_frame(3))
        ex.run_sync(_frame(4))
    _drain(ex)


def test_returned_result_survives_the_next_dispatch(weights):
    ex = _executor(weights, fused_tick=True)
    r0 = ex.run_sync(_frame(0))
    _select_first(ex, r0)
    r1 = ex.run_sync(_frame(1, t=1 / 30))
    kept = (r1.point_cloud.positions.copy(),
            [(b.center_x, b.center_y) for b in r1.boxes])
    ex.run_sync(_frame(2, t=2 / 30))                  # overwrites the buffer
    np.testing.assert_array_equal(r1.point_cloud.positions, kept[0])
    assert [(b.center_x, b.center_y) for b in r1.boxes] == kept[1]


def test_wrong_frame_size_and_lru_eviction(weights):
    ex = _executor(weights)
    with pytest.raises(ValueError, match="auto_recompile"):
        ex.run_inference(FrameData(rgb=np.zeros((32, 32, 3), np.uint8)))
    assert not ex.is_running()
    assert ex.run_sync(_frame(4)) is not None         # still usable

    ex = _executor(weights, fused_tick=True, auto_recompile=True,
                   max_cached_pipelines=2)
    for hw in ((64, 64), (48, 64), (32, 48), (48, 64)):
        r = ex.run_sync(_frame(1, hw=hw))
        assert r.count > 0 and ex.frame_hw == hw
        assert ex.screen_wh == (float(hw[1]), float(hw[0]))
    assert list(ex._pipelines) == [(32, 48), (48, 64)]      # (64,64) evicted
    assert list(ex._tick_pipes) == [((32, 48), (32, 32)),
                                    ((48, 64), (32, 32))]
    assert ex.tracer.summary()["recompile"]["count"] == 5   # 2 frame + 3 tick


def test_fused_equals_classic(weights):
    classic = _executor(weights, fused_tick=False)
    fused = _executor(weights, fused_tick=True)
    got_c, got_f = _drive(classic), _drive(fused)
    for (ic, nc, dc), (i_f, nf, d_f) in zip(got_c, got_f):
        assert i_f == ic >= 0 and nf == nc > 0
        np.testing.assert_array_equal(d_f, dc)
    st = fused.tracer.summary()
    assert "mask_fetch" not in st and "depth_fusion" not in st
    assert "readback" in st and "mask_fetch" in classic.tracer.summary()
    # both tracked the same box with the same points (float32, same ops)
    np.testing.assert_allclose(fused.last_result.point_cloud.positions,
                               classic.last_result.point_cloud.positions,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("emit", ["all", "none"])
def test_tracks_like_the_jax_executor(weights, emit):
    jex = jexecutor.Executor(_cfg(jconfig, emit_masks=emit),
                             params=weights[0], frame_hw=(64, 64))
    tex = _executor(weights, emit_masks=emit)
    want, got = _drive(jex, JAX_MODS), _drive(tex)
    for (ij, nj, dj), (it, nt, dt) in zip(want, got):
        assert it == ij >= 0
        assert nt == nj > 0
        np.testing.assert_array_equal(dt, dj)
    np.testing.assert_allclose(tex.last_result.point_cloud.positions,
                               jex.last_result.point_cloud.positions,
                               atol=1e-4, rtol=0)


def test_error_path_recovers_and_failures_surface(weights, monkeypatch):
    ex = _executor(weights)
    assert ex.run_inference(_frame(7))
    deadline = time.monotonic() + DEADLINE_S
    while ex.state != ExecState.REQUESTING_OUTPUTS:
        assert time.monotonic() < deadline
        ex.update()
    ex._inflight = dict(ex._inflight, slate=None)     # missing output
    ex.update()
    assert ex.state == ExecState.ERROR
    ex.update()
    assert ex.state == ExecState.COMPLETED and not ex.is_running()
    assert ex.run_sync(_frame(8)) is not None

    def boom(out):
        raise RuntimeError("copy failed")
    monkeypatch.setattr(ex.pipeline.readback, "start", boom)
    with pytest.raises(RuntimeError, match="copy failed"):
        ex.run_inference(_frame(9))                   # not swallowed
    assert not ex.is_running()


def test_multi_tracker_and_reid_branch(weights):
    ex = _executor(weights, multi_tracking=True, reid_threshold=0.5,
                   emit_masks="none")
    r0 = ex.run_sync(_frame(0))
    r1 = ex.run_sync(_frame(0, t=1 / 30))
    r2 = ex.run_sync(_frame(0, t=2 / 30))
    assert r0.tracks == []                   # confirmed after two hits
    assert len(r1.tracks) == r1.count == POST["max_detections"]
    assert {t.track_id for t in r2.tracks} == {t.track_id for t in r1.tracks}
    ex.reset_tracking()
    assert ex.multi_tracker.tracks == []
    assert ex.run_sync(_frame(0)).tracks == []


def test_between_frame_extraction_and_detect_task(weights):
    ex = _executor(weights, emit_masks="none")
    r = ex.run_sync(_frame(5))
    b = r.boxes[0]
    sp = (b.center_x + 32, b.center_y + 32)
    pc = ex.extract_point_cloud_at_screen_pos(sp)     # no frame in flight
    assert pc is not None and len(pc.positions) > 0
    assert ex.point_buffer is pc
    assert ex.extract_point_cloud_at_screen_pos((-500.0, -500.0)) is None
    assert ex.point_buffer is None
    ex.clear_point_cloud()
    with pytest.raises(ValueError, match="detect/segment"):
        Executor(tconfig.ExecutorConfig(model=tconfig.ModelConfig(
            task="obb", **MODEL)), device="cpu")
    with pytest.raises(ValueError, match="segment"):
        Executor(tconfig.ExecutorConfig(model=tconfig.ModelConfig(
            task="detect", **MODEL), fused_tick=True), device="cpu")


def test_defaults_to_the_card_and_refuses_native(weights):
    with pytest.raises(NotImplementedError, match="item 13"):
        PointCloudExtractor(backend="native", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        PointCloudExtractor(backend="jax", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(_cfg(), params=weights[1], frame_hw=(64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        PointCloudExtractor()


@pytest.mark.parametrize("fused", [False, True], ids=["classic", "fused"])
def test_xr_loop_select_track_reset(weights, fused):
    ex = _executor(weights, fused_tick=fused)
    loop = XRLoop(ex)

    def tick_to_result(frame, ctl=None):
        deadline = time.monotonic() + DEADLINE_S
        r = loop.tick(frame, ctl)
        while r is None:
            assert time.monotonic() < deadline
            r = loop.tick(frame)
        return r

    f0 = _frame(0)
    r0 = tick_to_result(f0)
    assert r0.count > 0 and r0.tracked is None and not ex.is_running()
    b = r0.boxes[0]
    ctl = aim_controller_at_frame_point(
        f0.intrinsics, f0.pose, (b.center_x + 32, b.center_y + 32), (64, 64))
    ctl.trigger = True
    r1 = tick_to_result(_frame(1, t=1 / 30), ctl)
    assert loop.selected and loop.laser_visible and ex.is_tracking
    np.testing.assert_allclose(loop.last_laser_frame_pos,
                               (b.center_x + 32, b.center_y + 32), atol=1e-3)
    assert r1.tracked is not None and len(r1.point_cloud.positions) > 0
    r2 = tick_to_result(_frame(2, t=2 / 30))
    assert r2.tracked is not None and r2.point_cloud is not None
    # no camera image: the controller is still handled (release + B)
    assert loop.tick(FrameData(rgb=None), ControllerState(button_b=True)) \
        is None
    assert not loop.laser_visible and not ex.is_tracking
    assert ex.point_buffer is None
    assert tick_to_result(_frame(3, t=3 / 30)).tracked is None
