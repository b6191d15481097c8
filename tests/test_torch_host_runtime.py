"""The port's host runtime surface against the JAX package's, on the CPU:
video files (runtime/video.py), the V4L2 camera source over a fake device
(runtime/v4l2.py), camera permissions and the managed source
(runtime/permissions.py), leveled logging (runtime/logging.py), the
deploy checks (runtime/deploy_check.py) and the profiler
(runtime/profiling.py).

The host copies are held EQUAL to JAX's: every decoded frame (RGB, YUV
planes, timestamp, fps), every error and message, every state and request
count of the permission flows. Then the composition of the slice: a Y4M
clip through VideoFrameSource into an Executor(multi_tracking=True) with
device="cpu", each frame's boxes equal to the direct b=1 pipeline's on the
decoded frame, and the track ids persisting.
"""
import io
import json
import logging
import os
import struct

import numpy as np
import pytest
import torch

from xrseg_tpu.runtime import logging as jlog
from xrseg_tpu.runtime import permissions as jperm
from xrseg_tpu.runtime import v4l2 as jv4l2
from xrseg_tpu.runtime import video as jvideo
from xrseg_tpu.runtime.frame_source import FrameData as JFrameData
from xrseg_tpu.runtime.frame_source import FrameSource as JFrameSource
from xrseg_tpu_torch.runtime import logging as tlog
from xrseg_tpu_torch.runtime import permissions as tperm
from xrseg_tpu_torch.runtime import v4l2 as tv4l2
from xrseg_tpu_torch.runtime import video as tvideo
from xrseg_tpu_torch.runtime.frame_source import FrameData as TFrameData
from xrseg_tpu_torch.runtime.frame_source import FrameSource as TFrameSource
from xrseg_tpu_torch.testing import limit_cpu_threads
from test_video import (BLACK, RED, WHITE, _chunk, _list, planes_420,
                        write_mjpeg_avi, write_y4m)

limit_cpu_threads()


# ---------------------------------------------------------------------------
# video files
# ---------------------------------------------------------------------------

def _same_frames(t_src, j_src, n=None):
    t_it, j_it = t_src.frames(), j_src.frames()
    got = 0
    while n is None or got < n:
        a, b = next(t_it, None), next(j_it, None)
        assert (a is None) == (b is None)
        if a is None:
            break
        np.testing.assert_array_equal(a.rgb, b.rgb)
        assert a.timestamp == b.timestamp
        assert (a.yuv is None) == (b.yuv is None)
        if a.yuv is not None:
            for p, q in zip(a.yuv, b.yuv):
                np.testing.assert_array_equal(p, q)
        got += 1
    assert t_src.fps == j_src.fps
    return got


def _y4m_420(p):
    write_y4m(p, [planes_420(8, 4, c) for c in (WHITE, BLACK, RED)], 8, 4)


def _y4m_422(p):
    rng = np.random.default_rng(1)
    write_y4m(p, [(rng.integers(16, 236, (4, 8), dtype=np.uint8),
                   rng.integers(16, 241, (4, 4), dtype=np.uint8),
                   rng.integers(16, 241, (4, 4), dtype=np.uint8))] * 2,
              8, 4, cfmt="422", fps="30000:1001")


def _y4m_444(p):
    rng = np.random.default_rng(2)
    write_y4m(p, [tuple(rng.integers(16, 236, (2, 4), dtype=np.uint8)
                        for _ in range(3))], 4, 2, cfmt="444")


def _y4m_truncated(p):
    write_y4m(p, [planes_420(8, 4, WHITE)] * 2, 8, 4)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-10])


def _avi(p):
    write_mjpeg_avi(p, [np.full((16, 24, 3), c, np.uint8)
                        for c in ((200, 30, 40), (20, 180, 60))], fps=20)


def _avi_mixed(p):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 77, np.uint8)).save(buf, "JPEG",
                                                           quality=95)
    avih = struct.pack("<10I", 40000, 0, 0, 0, 1, 0, 1, 0, 8, 8)
    body = (b"AVI " + _list(b"hdrl", _chunk(b"avih", avih))
            + _list(b"movi", _chunk(b"01wb", b"\x00" * 10)
                    + _chunk(b"00dc", buf.getvalue())))
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)


CLIPS = {"y4m_420.y4m": _y4m_420, "y4m_422.y4m": _y4m_422,
         "y4m_444.y4m": _y4m_444, "trunc.y4m": _y4m_truncated,
         "clip.avi": _avi, "mixed.avi": _avi_mixed}


@pytest.mark.parametrize("name", list(CLIPS))
@pytest.mark.parametrize("loop", [False, True])
def test_video_frames_equal_jax(name, loop, tmp_path):
    p = str(tmp_path / name)
    CLIPS[name](p)
    t, j = tvideo.VideoFrameSource(p, loop=loop), \
        jvideo.VideoFrameSource(p, loop=loop)
    assert t.open() == j.open()
    n = _same_frames(t, j, n=5 if loop else None)
    assert n == (5 if loop else {"y4m_420.y4m": 3, "y4m_422.y4m": 2,
                                 "clip.avi": 2}.get(name, 1))
    t.close()
    j.close()


def test_mjpeg_writer_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (20, 34, 3), dtype=np.uint8)
              for _ in range(3)]
    paths = []
    for mod, name in ((tvideo, "t.avi"), (jvideo, "j.avi")):
        w = mod.MJPEGWriter(str(tmp_path / name), fps=12.5, quality=90)
        for f in frames:
            w.add(f)
        w.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got = list(tvideo.VideoFrameSource(str(paths[0])).frames())
    assert len(got) == 3 and got[0].rgb.shape == (20, 34, 3)


@pytest.mark.parametrize("name,data", [
    ("mono.y4m", b"YUV4MPEG2 W4 H2 F25:1 Cmono\n"),
    ("junk.avi", b"not an avi at all"),
    ("clip.mp4", b"\x00" * 16)])
def test_video_errors_equal_jax(name, data, tmp_path):
    p = str(tmp_path / name)
    open(p, "wb").write(data)
    with pytest.raises(ValueError) as te:
        tvideo.VideoFrameSource(p).open()
    with pytest.raises(ValueError) as je:
        jvideo.VideoFrameSource(p).open()
    assert str(te.value) == str(je.value)


def test_yuv_to_rgb_equals_jax():
    rng = np.random.default_rng(3)
    y, u, v = rng.integers(0, 256, (3, 6, 10), dtype=np.uint8)
    np.testing.assert_array_equal(tvideo.yuv_to_rgb(y, u, v),
                                  jvideo.yuv_to_rgb(y, u, v))
    buf = rng.integers(0, 256, 6 * 10 * 2, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(tv4l2.yuyv_to_rgb(buf, 10, 6),
                                  jv4l2.yuyv_to_rgb(buf, 10, 6))


# ---------------------------------------------------------------------------
# V4L2 over a fake device
# ---------------------------------------------------------------------------

def _fake_camera(V, formats, frames, fail_opens=0):
    class Fake(V.RawCamera):
        def __init__(self):
            self._frames, self._fail = list(frames), fail_opens
            self.log, self._i = [], 0

        def open(self):
            self.log.append("open")
            if self._fail > 0:
                self._fail -= 1
                return False
            return True

        def formats(self):
            return [V.CameraFormat(f, s) for f, s in formats]

        def set_format(self, w, h, fourcc):
            self.log.append(("set_format", w, h, fourcc))
            return (w, h)

        def start(self):
            self.log.append("start")

        def grab(self):
            f = self._frames[self._i % len(self._frames)]
            self._i += 1
            return f

        def stop(self):
            self.log.append("stop")
    return Fake()


def _jpeg(val, hw=(16, 16)):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.full(hw + (3,), val, np.uint8)).save(
        buf, format="JPEG", quality=95)
    return buf.getvalue()


def _yuyv(w, h, seed):
    return np.random.default_rng(seed).integers(
        0, 256, w * h * 2, dtype=np.uint8).tobytes()


V4L2_CASES = {
    "yuyv_largest": (lambda V: [(V.V4L2_PIX_FMT_MJPG, ((320, 240),)),
                                (V.V4L2_PIX_FMT_YUYV, ((64, 48), (32, 24)))],
                     [_yuyv(64, 48, 0), _yuyv(64, 48, 1)], None, 0, 3),
    "requested": (lambda V: [(V.V4L2_PIX_FMT_YUYV, ((64, 48), (32, 24)))],
                  [_yuyv(32, 24, 2)], (32, 24), 0, 2),
    "mjpeg": (lambda V: [(V.V4L2_PIX_FMT_MJPG, ((16, 16),))],
              [_jpeg(200), _jpeg(90)], None, 0, 2),
    "retry_ok": (lambda V: [(V.V4L2_PIX_FMT_YUYV, ((8, 4),))],
                 [_yuyv(8, 4, 3)], None, 2, 1),
    "retry_gone": (lambda V: [], [], None, 10, 0),
    "no_format": (lambda V: [(V._fourcc("H264"), ((64, 48),))], [], None,
                  0, 0),
}


@pytest.mark.parametrize("case", list(V4L2_CASES))
def test_v4l2_source_equals_jax(case):
    """Format negotiation (YUYV over MJPEG, the largest size unless one
    is requested), the bounded open retry and the frames served."""
    fmts, frames, req, fail, n = V4L2_CASES[case]
    runs = []
    for V in (tv4l2, jv4l2):
        cam = _fake_camera(V, fmts(V), frames, fail)
        src = V.V4L2CameraSource(camera=cam, max_frames=max(n, 1),
                                 open_retries=3, retry_interval_s=0.0)
        if req is not None:
            assert src.request_resolution(req)
        ok = src.open()
        got = [f.rgb for f in src.frames()] if ok else []
        runs.append((ok, src.is_ready, cam.log, got,
                     src.supported_output_sizes() if ok else None))
        src.close()
    (tok, tready, tlog_, tgot, tsizes), (jok, jready, jlog_, jgot,
                                         jsizes) = runs
    assert (tok, tready, tlog_, tsizes) == (jok, jready, jlog_, jsizes)
    assert len(tgot) == len(jgot) == n
    for a, b in zip(tgot, jgot):
        np.testing.assert_array_equal(a, b)


def test_v4l2_abi_and_missing_device_equal_jax():
    assert tv4l2._fourcc("YUYV") == jv4l2._fourcc("YUYV") == 0x56595559
    for name in dir(jv4l2):
        if name.startswith(("V4L2_", "VIDIOC_")):
            assert getattr(tv4l2, name) == getattr(jv4l2, name), name
    src = tv4l2.V4L2CameraSource(device="/dev/video99", open_retries=1,
                                 retry_interval_s=0.0)
    assert not src.open() and not src.is_ready


# ---------------------------------------------------------------------------
# permissions and the managed source
# ---------------------------------------------------------------------------

def _flaky(FS, FD, appear_after):
    class Flaky(FS):
        def __init__(self):
            self.calls = 0

        def open(self):
            self.calls += 1
            return self.calls > appear_after

        def frames(self):
            yield FD(rgb=np.zeros((4, 4, 3), np.uint8))
    return Flaky()


def _perm_flow(P, FS, FD, flow):
    """Run one scripted flow, return its observable trace."""
    grant = {p: True for p in P.CAMERA_PERMISSIONS}
    deny = {p: False for p in P.CAMERA_PERMISSIONS}
    trace = []
    if flow == "grant":
        prov = P.ScriptedProvider(responses=[grant])
        perms = P.CameraPermissions(prov)
        perms.ask()
        perms.ask()
        trace += [perms.has_camera_permission, prov.request_count]
    elif flow == "already":
        prov = P.ScriptedProvider(initial=P.CAMERA_PERMISSIONS)
        perms = P.CameraPermissions(prov)
        perms.ask()
        trace += [perms.has_camera_permission, prov.request_count]
    elif flow == "partial":
        prov = P.ScriptedProvider(responses=[{"camera": True,
                                              "headset_camera": False}])
        perms = P.CameraPermissions(prov)
        perms.ask()
        trace += [perms.has_camera_permission]
    elif flow == "deny_then_grant":
        prov = P.ScriptedProvider(responses=[deny, grant])
        perms = P.CameraPermissions(prov)
        for _ in range(2):
            perms.ask()
            trace += [perms.has_camera_permission, prov.request_count]
    elif flow == "unsupported":
        src = P.ManagedFrameSource(_flaky(FS, FD, 0), is_supported=False)
        src.enable()
        src.update()
        trace += [src.state.value]
    elif flow == "wait_then_ready":
        prov = P.ScriptedProvider(responses=[deny, grant])
        src = P.ManagedFrameSource(_flaky(FS, FD, 0),
                                   permissions=P.CameraPermissions(prov))
        src.enable()
        trace += [src.state.value]
        src.update()
        src.update()
        trace += [src.state.value, next(iter(src.frames())).rgb.shape]
    elif flow == "retry":
        for appear, budget in ((3, 10), (99, 5)):
            src = P.ManagedFrameSource(_flaky(FS, FD, appear),
                                       max_open_attempts=budget)
            src.enable()
            trace += [src.state.value, src.open_attempts]
            try:
                src.frames()
                trace.append("frames")
            except RuntimeError as e:
                trace.append(str(e))
    return trace


@pytest.mark.parametrize("flow", ["grant", "already", "partial",
                                  "deny_then_grant", "unsupported",
                                  "wait_then_ready", "retry"])
def test_permission_flows_equal_jax(flow):
    t = _perm_flow(tperm, TFrameSource, TFrameData, flow)
    j = _perm_flow(jperm, JFrameSource, JFrameData, flow)
    assert t == j and t


def test_logging_levels_equal_jax():
    outs = []
    for L in (tlog, jlog):
        stream = io.StringIO()
        logger = L._logger
        saved = (list(logger.handlers), logger.level, L._level)
        logger.handlers = []
        try:
            for level in L.DebugLevel:
                L.configure(level, stream=stream)
                for kind in ("log", "warning", "error"):
                    L.debug_message(kind, f"{level.value}:{kind}")
                L.log("l")
                L.warning("w")
                L.error("e")
        finally:
            logger.handlers, L._level = saved[0], saved[2]
            logger.setLevel(saved[1])
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] and outs[0]
    assert logging.getLogger("xrseg_tpu_torch") is tlog._logger


# ---------------------------------------------------------------------------
# deploy checks and the profiler
# ---------------------------------------------------------------------------

def test_check_environment_cpu():
    """On device="cpu" the config, camera and native checks pass and
    report what JAX's report; require_cuda fails there."""
    from xrseg_tpu.config import ExecutorConfig as JCfg
    from xrseg_tpu.runtime.deploy_check import check_environment as jcheck
    from xrseg_tpu_torch.config import ExecutorConfig
    from xrseg_tpu_torch.runtime.deploy_check import check_environment
    src = tperm.ManagedFrameSource(_flaky(TFrameSource, TFrameData, 0))
    src.enable()
    res = check_environment(ExecutorConfig(), mesh_shape=(1, 1),
                            frame_source=src, device="cpu")
    assert res.ok, res.checks
    res.raise_if_failed()
    names = [n for n, _, _ in res.checks]
    assert names == ["camera_supported", "camera_permission",
                     "camera_available", "devices_present",
                     "mesh_fits_devices", "batch_divisible",
                     "input_stride_aligned", "thresholds_sane",
                     "topk_covers_maxdet", "native_runtime"]
    by = {n: d for n, _, d in res.checks}
    assert by["native_runtime"].endswith("loaded")
    jsrc = jperm.ManagedFrameSource(_flaky(JFrameSource, JFrameData, 0))
    jsrc.enable()
    jres = jcheck(JCfg(), mesh_shape=(1, 1), frame_source=jsrc)
    jby = {n: d for n, _, d in jres.checks}
    # (mesh_fits_devices names each side's device count: the JAX tests
    # run on 8 virtual CPU devices, the port's CPU entry is one device)
    for n in ("camera_supported", "camera_permission", "camera_available",
              "batch_divisible", "input_stride_aligned", "thresholds_sane",
              "topk_covers_maxdet"):
        assert by[n] == jby[n], n

    bad = check_environment(ExecutorConfig(), require_cuda=True,
                            device="cpu")
    assert not bad.ok
    assert [n for n, p, _ in bad.checks if not p] == ["cuda_platform"]
    with pytest.raises(RuntimeError, match="cuda_platform"):
        bad.raise_if_failed()


def test_check_environment_failures():
    import dataclasses
    from xrseg_tpu_torch.config import ExecutorConfig, PostprocessConfig
    from xrseg_tpu_torch.runtime.deploy_check import check_environment
    cfg = ExecutorConfig(post=PostprocessConfig(score_threshold=1.5,
                                                pre_nms_topk=10))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, input_size=(100, 100)))
    gone = tperm.ManagedFrameSource(_flaky(TFrameSource, TFrameData, 99),
                                    max_open_attempts=2)
    gone.enable()
    res = check_environment(cfg, batch=3, mesh_shape=(2, 1),
                            frame_source=gone, device="cpu")
    failed = {n for n, p, _ in res.checks if not p}
    assert failed == {"camera_available", "mesh_fits_devices",
                      "batch_divisible", "input_stride_aligned",
                      "thresholds_sane", "topk_covers_maxdet"}
    if not torch.cuda.is_available():
        res = check_environment(device="cuda")
        assert not res.ok and res.checks[0][:2] == ("devices_present",
                                                    False)


def test_profile_fn_writes_trace(tmp_path):
    from xrseg_tpu_torch.runtime.profiling import device_trace, profile_fn
    from xrseg_tpu_torch.runtime.tracing import Tracer
    calls = []
    tracer = Tracer()
    tracer.enable(True)       # its sections are named ranges in the trace

    def fn():
        calls.append(1)
        with tracer.section("matmul"):
            return torch.ones(32, 32) @ torch.ones(32, 32)

    assert profile_fn(fn, str(tmp_path / "t"), steps=2, warmup=1) == \
        str(tmp_path / "t")
    assert len(calls) == 3
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((tmp_path / "t" / files[0]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "xrseg.matmul" in names
    # nesting is a no-op, as in the JAX package
    with device_trace(str(tmp_path / "n")):
        with device_trace(str(tmp_path / "n")):
            fn()
    assert len(os.listdir(tmp_path / "n")) == 1


# ---------------------------------------------------------------------------
# video -> Executor(multi_tracking), device="cpu"
# ---------------------------------------------------------------------------

def test_video_to_tracker_composition(tmp_path):
    """VideoFrameSource -> Executor(multi_tracking) end to end at test
    geometry (the tools/track_video.py composition): fixture weights that
    detect at every anchor; each frame's boxes equal the direct b=1
    pipeline's on the decoded frame; track ids persist."""
    from xrseg_tpu_torch.compile import unpack_slate
    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.perception.tracking import parse_boxes
    from xrseg_tpu_torch.runtime.executor import Executor
    from xrseg_tpu_torch.testing import detection_params

    w = h = 64
    rng = np.random.default_rng(0)
    y = rng.uniform(60, 200, (h, w)).astype(np.uint8)
    p = str(tmp_path / "t.y4m")
    write_y4m(p, [(y, np.full((h // 2, w // 2), 128, np.uint8),
                   np.full((h // 2, w // 2), 128, np.uint8))] * 4, w, h)
    cfg = ExecutorConfig(model=ModelConfig(input_size=(64, 64),
                                           dtype="float32"),
                         multi_tracking=True)
    params = detection_params(torch.Generator().manual_seed(0), cfg.model,
                              device="cpu")
    src = tvideo.VideoFrameSource(p)
    assert src.open()
    ex = Executor(cfg, params=params, frame_hw=(h, w), device="cpu")
    ids_per_frame = []
    for fd in src.frames():
        r = ex.run_sync(fd)
        assert r.count > 0
        direct = unpack_slate(ex.pipeline(fd.rgb[None])["slate"][0],
                              cfg.post.max_detections)
        want = parse_boxes(direct["boxes_xywh"], direct["labels"],
                           direct["scores"], direct["count"], ex.screen_wh,
                           ex.labels, max_boxes=cfg.post.max_detections,
                           model_size=(64.0, 64.0))
        assert r.boxes == want
        ids_per_frame.append({t.track_id for t in (r.tracks or [])})
    src.close()
    assert len(ids_per_frame) == 4
    confirmed = [s for s in ids_per_frame if s]
    assert confirmed, "tracker never confirmed a track"
    assert confirmed[-1] & confirmed[0]
