"""The port's tracer (xrseg_tpu_torch/runtime/tracing.py) and the spans of
the batch path and the executor, on the CPU; the device spans on a card
(marker `cuda`; they skip here).

StageTimer keeps whole-window statistics in constant memory: its
percentiles are within the histogram's error (StageTimer.REL_ERR) of the
exact order statistics over every sample, where a ring of the last 512
is not. Sections keep self time, enabled or not. Enabled, sections
record spans (name, id, parent) and name torch.profiler ranges
`xrseg.<name>`; disabled, neither. StreamingRunner exports one upload,
enqueue, readback_start, device_wait and unpack span per batch, keyed by
its frame_id, and counts queued_at_submit; the executor tags its
sections with the frame id. The file imports neither JAX nor the JAX
package, so its card cases also run on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tracing.py
"""
import inspect
import json
import math
import sys
import threading

import numpy as np
import pytest
import torch

from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.models.yolo11 import init_params
from xrseg_tpu_torch.runtime import tracing
from xrseg_tpu_torch.runtime.executor import Executor
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.streaming import StreamingRunner
from xrseg_tpu_torch.runtime.tracing import StageTimer, Tracer
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import stream_probe

limit_cpu_threads()

CFG = ExecutorConfig(model=ModelConfig(input_size=(64, 64), dtype="float32"),
                     post=PostprocessConfig(pre_nms_topk=64, max_detections=10,
                                            score_threshold=1e-7))
BATCH_SPANS = ("dispatch", "upload", "enqueue", "readback_start", "readback",
               "device_wait", "unpack")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA events time the device "
                    "spans; the CPU records none)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    return init_params(torch.Generator().manual_seed(0), CFG.model)


def _batches(n, B=1, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, 64, 64, 3), np.uint8) for _ in range(n)]


def _exact(samples, p):
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, int(round(p / 100 * (len(s) - 1)))))]


def _samples(kind, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "drift":        # the window's first part is fast, its end slow
        return list(np.linspace(1e-3, 2e-2, n) * rng.uniform(0.9, 1.1, n))
    if kind == "lognormal":
        return list(rng.lognormal(-6.0, 1.0, n))
    return list(np.where(rng.random(n) < 0.9, rng.normal(5e-3, 1e-4, n),
                         rng.normal(8e-2, 1e-3, n)))   # a 10% slow mode


# ---------------------------------------------------------------------------
# StageTimer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["drift", "lognormal", "bimodal"])
def test_stage_timer_percentiles_cover_the_whole_window(kind):
    xs = _samples(kind)
    st = StageTimer()
    for x in xs:
        st.add(x)
    assert st.count == len(xs)
    assert st.min == min(xs) and st.max == max(xs)
    assert math.isclose(st.mean, sum(xs) / len(xs), rel_tol=1e-12)
    for p in (0, 1, 5, 25, 50, 75, 95, 99, 100):
        want = _exact(xs, p)
        assert abs(st.percentile(p) - want) <= StageTimer.REL_ERR * want, p
    if kind == "drift":
        # the old 512-sample ring read the window's end, not the window
        ring = xs[-512:]
        assert abs(_exact(ring, 50) - _exact(xs, 50)) > \
            StageTimer.REL_ERR * _exact(xs, 50)


def test_stage_timer_memory_is_constant_and_reset_starts_a_window():
    st = StageTimer()
    rng = np.random.default_rng(1)
    bound = math.ceil(math.log(1e7) / math.log(StageTimer.GROWTH)) + 1
    for _ in range(4):
        for x in rng.uniform(1e-6, 10.0, 25_000):
            st.add(float(x))
        assert len(st._buckets) <= bound
    st.add(0.0)                       # a zero self time has a bucket too
    assert st.count == 100_001 and st.percentile(0) == 0.0
    st.reset()
    assert st.count == 0 and not st._buckets and st.percentile(95) == 0.0
    assert "deque" not in inspect.getsource(tracing)


def test_stage_timer_counts_every_sample_across_threads():
    st = StageTimer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [st.add(1e-3)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert st.count == 32_000
    assert math.isclose(st.total, 32.0, rel_tol=1e-9)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class _Clock:
    """A perf_counter that moves only when the test says (ms at a time)."""

    def __init__(self):
        self.ns = 10**12

    def perf_counter(self):
        return self.ns / 1e9

    def perf_counter_ns(self):
        return self.ns

    def sleep(self, ms):
        self.ns += int(ms * 1e6)


@pytest.mark.parametrize("enabled", [False, True])
def test_self_time_sums_to_the_outer_section(enabled, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    tr = Tracer()
    tr.enable(enabled)
    with tr.section("outer", 3):
        clock.sleep(10)
        with tr.section("a", 3):
            clock.sleep(20)
            with tr.section("b", 3):
                clock.sleep(5)
        with tr.section("c", 3):
            clock.sleep(7)
    s = tr.summary()
    got = {k: s[k]["mean_ms"] for k in ("outer", "a", "b", "c")}
    assert got == pytest.approx({"outer": 10, "a": 20, "b": 5, "c": 7},
                                abs=1e-9)
    if enabled:
        spans = tr.export()["spans"]
        assert sum(sp["self_ns"] for sp in spans) == \
            spans[0]["end_ns"] - spans[0]["start_ns"] == 42_000_000


def test_enabled_spans_nest_with_ids_and_parents():
    tr = Tracer()
    assert tr.export()["spans"] == []
    tr.enable(True)
    with tr.section("dispatch", 7):
        with tr.section("upload", 7):
            pass
        with tr.detail("enqueue", 7):
            pass
    with tr.section("readback", 7):
        tr.interval("device_wait", 1.0, 1.5, 7)
    spans = tr.export()["spans"]
    assert [(s["name"], s["id"], s["parent"]) for s in spans] == [
        ("dispatch", 7, None), ("upload", 7, 0), ("enqueue", 7, 0),
        ("readback", 7, None), ("device_wait", 7, 3)]
    for s in spans[:4]:
        assert s["start_ns"] <= s["end_ns"] and 0 <= s["self_ns"]
    assert spans[1]["end_ns"] <= spans[2]["start_ns"]
    assert spans[4]["self_ns"] == 500_000_000
    tr.reset()                                  # a new window, still on
    assert tr.enabled and tr.export()["spans"] == []
    tr.enable(False)
    assert tr._spans is None and tr.export()["spans"] == []


def test_disabled_detail_sections_do_not_exist():
    tr = Tracer()
    with tr.section("dispatch", 1):
        with tr.detail("upload", 1):
            pass
    assert set(tr.summary()) == {"dispatch"}
    assert tr.device_span("batch_device", 1, torch.device("cpu")) is \
        tracing._NULL


def _profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("xrseg.")]


@pytest.mark.parametrize("enabled", [True, False])
def test_profiler_holds_the_batch_path_ranges(model, enabled):
    pipe = build_pipeline(CFG, model, batch=1, device="cpu")
    runner = StreamingRunner(pipe, depth=1)
    runner.tracer.enable(enabled)
    batches = _batches(2)

    def run():
        for x in batches:
            runner.submit(x)
        list(runner.drain())

    ev = _profile(run)
    if not enabled:
        assert ev == [] and runner.tracer._spans is None
        return
    names = [n for n, _, _ in ev]
    for n in BATCH_SPANS:
        assert names.count(f"xrseg.{n}") == 2, n
    disp = sorted((s, e) for n, s, e in ev if n == "xrseg.dispatch")
    up = sorted((s, e) for n, s, e in ev if n == "xrseg.upload")
    enq = sorted((s, e) for n, s, e in ev if n == "xrseg.enqueue")
    for (ds, de), (us, ue), (es, ee) in zip(disp, up, enq):
        assert ds <= us <= ue <= es <= ee <= de


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_runner_exports_each_batch_by_frame_id(model, depth):
    pipe = build_pipeline(CFG, model, batch=2, device="cpu")
    runner = StreamingRunner(pipe, depth=depth)
    list(runner.run(iter(_batches(2, B=2))))       # untraced: no spans
    assert "upload" not in runner.tracer.summary()
    runner.tracer.reset()
    runner.tracer.enable(True)
    got = [r.frame_id for r in runner.run(iter(_batches(5, B=2, seed=1)))]
    assert got == list(range(2, 7))
    exp = runner.tracer.export()
    spans = exp["spans"]
    for name in BATCH_SPANS:
        assert [s["id"] for s in spans if s["name"] == name] == got, name
    for s in spans:
        parent = None if s["parent"] is None else spans[s["parent"]]
        want = {"upload": "dispatch", "enqueue": "dispatch",
                "readback_start": "dispatch", "device_wait": "readback",
                "unpack": "readback"}.get(s["name"])
        assert (parent and parent["name"]) == want
        assert parent is None or parent["id"] == s["id"]
    assert exp["counters"]["batches_submitted"] == 5
    # the CPU finishes each batch inside its submit: none is queued
    assert exp["counters"]["queued_at_submit"] == 0
    assert exp["device_spans"] == []
    r = stream_probe.readings(exp)
    assert r["batches"] == 5 and r["queued_batches"] == 0.0
    assert r["spans_per_batch"] == len(BATCH_SPANS)
    assert r["upload_ms"] > 0 and r["enqueue_ms"] > r["upload_ms"]


def test_executor_tags_its_sections_with_the_frame_id(model):
    ex = Executor(CFG, params=model, frame_hw=(64, 64), device="cpu")
    ex.tracer.enable(True)
    rng = np.random.default_rng(2)
    for _ in range(3):
        ex.run_sync(FrameData(rgb=rng.integers(0, 256, (64, 64, 3),
                                               np.uint8)))
        ex.update()
    spans = ex.tracer.export()["spans"]
    for name in ("dispatch", "device_wait", "readback", "process"):
        assert [s["id"] for s in spans if s["name"] == name] == [0, 1, 2]


def test_stream_probe_runs_on_the_cpu(capsys):
    assert stream_probe.main(["--device", "cpu", "--size", "64", "--scale",
                              "n", "--batch", "1", "--seconds", "0.3",
                              "--rounds", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and len(out["frames_per_s_off"]) == 1
    assert len(out["frames_per_s_on"]) == len(out["traced"]) == 1
    assert out["conv_epilogue_launches_per_batch"] == [0.0, 0.0]
    assert out["conv_epilogue_channels_last_per_batch"] == [0.0, 0.0]
    t = out["traced"][0]
    assert t["queued_batches"] == 0.0 and t["device_spans_per_batch"] == 0
    for name in BATCH_SPANS:
        assert t[f"{name}_ms"] >= 0, name


def test_span_list_is_capped_and_open_spans_have_no_times(monkeypatch):
    monkeypatch.setattr(Tracer, "MAX_SPANS", 3)
    tr = Tracer()
    tr.enable(True)
    with tr.section("outer", 0):
        for i in range(4):
            with tr.section("inner", i):
                pass
        spans = tr.export()["spans"]
        assert spans[0]["start_ns"] is None and spans[0]["end_ns"] is None
    assert [s["name"] for s in tr.export()["spans"]] == ["outer", "inner",
                                                         "inner"]
    assert tr.counters["spans_dropped"] == 2
    assert tr.summary()["inner"]["count"] == 4   # stages keep every one


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_pipeline_upload_keeps_the_form_of_the_frames(model, fmt):
    pipe = build_pipeline(CFG, model, batch=1, device="cpu",
                          input_format=fmt)
    rng = np.random.default_rng(4)
    if fmt == "rgb":
        frames = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
    else:
        frames = (rng.integers(0, 256, (1, 64, 64), np.uint8),
                  rng.integers(0, 256, (1, 32, 32), np.uint8),
                  rng.integers(0, 256, (1, 32, 32), np.uint8))
    x = pipe.upload(frames)
    planes = (x,) if fmt == "rgb" else x
    assert all(isinstance(p, torch.Tensor) for p in planes)
    again = pipe.upload(x)           # already on the device: no copy
    assert all(a is b for a, b in zip((again,) if fmt == "rgb" else again,
                                      planes))
    np.testing.assert_array_equal(pipe(x)["slate"].numpy(),
                                  pipe(frames)["slate"].numpy())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_batch_device_spans_on_the_card(card, model):
    pipe = build_pipeline(CFG, model.to(card), batch=2,
                          device=card).warmup()
    runner = StreamingRunner(pipe, depth=2)
    runner.tracer.enable(True)
    got = [r.frame_id for r in runner.run(iter(_batches(8, B=2)))]
    exp = runner.tracer.export()
    dev = exp["device_spans"]
    assert [d["id"] for d in dev] == got == list(range(8))   # FIFO
    window_ms = exp["window_ns"] / 1e6
    prev_end = 0.0
    for d in dev:
        assert d["name"] == "batch_device" and d["ms"] > 0
        assert prev_end <= d["start_ms"] < d["end_ms"] <= window_ms
        prev_end = d["end_ms"]
    c = exp["counters"]
    assert c["batches_submitted"] == 8
    assert 0 <= c["queued_at_submit"] <= 2 * 8
    assert runner.tracer.summary()["batch_device"]["count"] == 8


@pytest.mark.cuda
def test_frame_device_spans_on_the_card(card, model):
    ex = Executor(CFG, params=model.to(card), frame_hw=(64, 64),
                  device=card)
    ex.tracer.enable(True)
    rng = np.random.default_rng(3)
    for _ in range(4):
        ex.run_sync(FrameData(rgb=rng.integers(0, 256, (64, 64, 3),
                                               np.uint8)))
        ex.update()
    dev = ex.tracer.export()["device_spans"]
    assert [d["id"] for d in dev] == [0, 1, 2, 3]
    assert all(d["name"] == "frame_device" and d["ms"] > 0 for d in dev)
    assert ex.tracer.summary()["frame_device"]["count"] == 4
