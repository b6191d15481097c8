"""The port's streaming runners (xrseg_tpu_torch/runtime/streaming.py) on the
CPU, and the pipelined fused tick against the JAX package's.

StreamingRunner at depth 1, 2 and 3 must give the direct pipeline's slate
for every batch, EQUAL, in FIFO order. PipelinedTickRunner at depth 1 is
the executor's sequential fused tick: tracked index and point count equal,
depths within 1e-6 (the same code on the same frames). At depth 2 its
re-lock box is one result stale; on a static scene that is invisible, so
it equals sequential again; on a moving scene it is held to the JAX
PipelinedTickRunner at depth 2 on the same frames and weights: tracked
index and point count equal, depths within 1e-5 (mirrors
tests/test_pipelined.py; the models run in float32 and detection_params
spreads the scores far beyond float32 differences).

Every frame in flight has a readback slot of its own (ReadbackSlots);
a slot whose frame has not been read raises instead of being overwritten.
"""
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
from xrseg_tpu.runtime import streaming as jstreaming
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.compile import build_pipeline, unpack_slate
from xrseg_tpu_torch.device import Readback
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.perception.camera import (CameraIntrinsics, Pose,
                                               quat_identity)
from xrseg_tpu_torch.runtime.executor import Executor
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.streaming import (PipelinedTickRunner,
                                               ReadbackSlots, StreamingRunner)

MODEL = dict(scale="n", input_size=(64, 64), dtype="float32")
POST = dict(pre_nms_topk=64, max_detections=10, score_threshold=1e-7)
JAX_MODS = (jframes.FrameData, jcamera.Pose, jcamera.CameraIntrinsics,
            jcamera.quat_identity)


def _cfg(mod=tconfig, fused=True):
    return mod.ExecutorConfig(model=mod.ModelConfig(**MODEL),
                              post=mod.PostprocessConfig(**POST),
                              fused_tick=fused)


def _frame(seed=0, t=0.0, mods=None):
    frame_cls, pose_cls, intr_cls, ident = mods or (
        FrameData, Pose, CameraIntrinsics, quat_identity)
    rng = np.random.default_rng(seed)
    depth = np.full((32, 32), 1.5, np.float16).view(np.uint16)
    return frame_cls(rgb=rng.integers(0, 255, (64, 64, 3), np.uint8),
                     timestamp=t, pose=pose_cls(np.zeros(3, np.float32),
                                                ident()),
                     intrinsics=intr_cls.quest3_like(), depth_fp16=depth)


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


# ---------------------------------------------------------------------------
# readback slots
# ---------------------------------------------------------------------------

def test_a_slot_holds_one_frame():
    rb = Readback(4, torch.device("cpu"))
    rb.start(torch.arange(4.0))
    assert rb.held
    with pytest.raises(RuntimeError, match="overwrite"):
        rb.start(torch.zeros(4))
    np.testing.assert_array_equal(rb.host(), [0, 1, 2, 3])   # consumed
    rb.start(torch.ones(4))
    rb.release()                                             # dropped
    assert not rb.held
    rb.start(torch.full((4,), 2.0))
    np.testing.assert_array_equal(rb.host(), [2, 2, 2, 2])


def test_ring_takes_slots_in_turn_and_never_overwrites():
    ring = ReadbackSlots(torch.device("cpu"), 2)
    a, b = ring.next(3), ring.next(3)
    assert a is not b and ring.next(3) is a
    a.start(torch.zeros(3))
    b.start(torch.ones(3))
    again = ring.next(3)                  # a, still unread
    with pytest.raises(RuntimeError, match="overwrite"):
        again.start(torch.full((3,), 9.0))
    # another output length has slots and a turn of its own
    other = ring.next(5)
    assert other.buffer.numel() == 5 and ring.next(5) is not other
    assert ring.next(5) is other
    np.testing.assert_array_equal(a.host(), [0, 0, 0])
    np.testing.assert_array_equal(b.host(), [1, 1, 1])
    with pytest.raises(ValueError):
        ReadbackSlots(torch.device("cpu"), 0)


# ---------------------------------------------------------------------------
# StreamingRunner
# ---------------------------------------------------------------------------

def _batches(n, B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, 64, 64, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_equals_direct_calls_in_order(weights, depth, B):
    pipe = build_pipeline(_cfg(), weights[1], batch=B, device="cpu")
    batches = _batches(6, B, seed=depth)
    want = [pipe(x)["slate"].numpy() for x in batches]
    runner = StreamingRunner(pipe, depth=depth)
    fill = 0
    got = []
    for x in batches:
        r = runner.submit(x)
        if r is None:
            fill += 1
        else:
            got.append(r)
        assert runner.inflight <= depth
    got.extend(runner.drain())
    assert fill == depth and runner.inflight == 0
    assert [r.frame_id for r in got] == list(range(len(batches)))
    for r, w in zip(got, want):
        rows = [unpack_slate(row, 10) for row in w]
        slates = [r.slate] if B == 1 else [
            {k: r.slate[k][j] for k in r.slate} for j in range(B)]
        for s, ref in zip(slates, rows):
            for k in ref:
                np.testing.assert_array_equal(s[k], ref[k], err_msg=k)
        assert r.latency_s >= 0 and "slate" in r.device_out
    s = runner.tracer.summary()
    assert s["dispatch"]["count"] == s["readback"]["count"] == len(batches)


def test_streaming_run_and_guards(weights):
    pipe = build_pipeline(_cfg(), weights[1], batch=1, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        StreamingRunner(pipe, depth=0)
    out = list(StreamingRunner(pipe, depth=2).run(iter(_batches(5, 1))))
    assert [r.frame_id for r in out] == [0, 1, 2, 3, 4]
    # the runner's slots are its own: the pipeline's readback stays free
    assert not pipe.readback.held


# ---------------------------------------------------------------------------
# PipelinedTickRunner
# ---------------------------------------------------------------------------

def _lock(ex, mods=None):
    r0 = ex.run_sync(_frame(0, mods=mods))
    assert r0.count > 0
    b = r0.boxes[0]
    assert ex.select_target_from_screen_pos(
        (b.center_x + ex.screen_wh[0] / 2, b.center_y + ex.screen_wh[1] / 2))


def _sig(r):
    pc = r.point_cloud
    return (r.tracked.index if r.tracked is not None else -1,
            len(pc.positions) if pc is not None else 0,
            np.sort(pc.depths) if pc is not None else np.zeros(0))


def _executor(weights, fused=True):
    return Executor(_cfg(fused=fused), params=weights[1], frame_hw=(64, 64),
                    device="cpu")


def _assert_sigs_equal(got, want, tol):
    assert len(got) == len(want)
    for (iw, nw, dw), (ig, ng, dg) in zip(want, got):
        assert ig == iw and ng == nw
        np.testing.assert_allclose(dg, dw, rtol=tol, atol=tol)


def _moving(n, mods=None):
    return [_frame(i, t=i / 30, mods=mods) for i in range(1, n + 1)]


def test_depth1_is_exactly_sequential(weights):
    frames = _moving(5)
    seq = _executor(weights)
    _lock(seq)
    want = [_sig(seq.run_sync(f)) for f in frames]
    ex = _executor(weights)
    _lock(ex)
    runner = PipelinedTickRunner(ex, depth=1)
    got = [_sig(r) for r in runner.run(iter(frames))]
    _assert_sigs_equal(got, want, 1e-6)
    assert all(n > 0 for _, n, _ in got)


@pytest.mark.parametrize("depth", [2, 3])
def test_deeper_static_scene_matches_sequential(weights, depth):
    frames = [_frame(1, t=i / 30) for i in range(1, 7)]
    seq = _executor(weights)
    _lock(seq)
    want = [_sig(seq.run_sync(f)) for f in frames]
    ex = _executor(weights)
    _lock(ex)
    runner = PipelinedTickRunner(ex, depth=depth)
    fill, got = 0, []
    for f in frames:
        r = runner.submit(f)
        if r is None:
            fill += 1
        else:
            got.append(_sig(r))
            # the executor was staged to the popped frame's own slot
            assert ex._readback in runner._slots._by_len[
                ex._inflight_tick_pipe.packed_len]
            assert not ex._readback.held
    got.extend(_sig(r) for r in runner.drain())
    assert fill == depth - 1 and runner.inflight == 0
    _assert_sigs_equal(got, want, 1e-6)
    st = ex.tracer.summary()
    for stage in ("dispatch", "device_wait", "readback", "process"):
        assert stage in st
    assert "mask_fetch" not in st and "depth_fusion" not in st


def test_depth2_moving_scene_matches_jax_runner(weights):
    jex = jexecutor.Executor(_cfg(jconfig), params=weights[0],
                             frame_hw=(64, 64))
    _lock(jex, JAX_MODS)
    want = [_sig(r) for r in jstreaming.PipelinedTickRunner(
        jex, depth=2).run(iter(_moving(8, JAX_MODS)))]
    ex = _executor(weights)
    _lock(ex)
    got = [_sig(r) for r in PipelinedTickRunner(ex, depth=2).run(
        iter(_moving(8)))]
    _assert_sigs_equal(got, want, 1e-5)
    assert sum(n > 0 for _, n, _ in got) >= 6


def test_runner_guards(weights):
    ex = _executor(weights)
    with pytest.raises(ValueError):
        PipelinedTickRunner(ex, depth=0)
    with pytest.raises(ValueError, match="fused_tick"):
        PipelinedTickRunner(_executor(weights, fused=False))
    runner = PipelinedTickRunner(ex, depth=2)
    with pytest.raises(ValueError, match="depth_fp16"):
        runner.submit(FrameData(rgb=np.zeros((64, 64, 3), np.uint8)))
    # a classic frame in flight blocks pipelined submits
    assert ex.run_inference(_frame(0))
    with pytest.raises(RuntimeError, match="in flight"):
        runner.submit(_frame(1))
    while ex.update() is None and ex.is_running():
        pass
    ex.update()
    assert not ex.is_running()
    assert runner.submit(_frame(2)) is None and runner.inflight == 1
    assert len(list(runner.drain())) == 1
