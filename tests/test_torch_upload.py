"""The frames' way to the device (xrseg_tpu_torch/device.py `Upload`,
`compile.CompiledPipeline.upload`).

On the CPU: the copy equals the frames and owns its memory (the caller may
overwrite its array at once), the yuv420 form keeps its three planes, a
tensor already on the device passes through, host frames for a card take
the staging ring and nothing else does, and the staging copy takes every
host layout (read-only, mirrored, a strided tensor).

On a card (marker `cuda`; they skip here): the slates of
StreamingRunner(depth=2) over staged uploads are bit-equal to those of a
pageable `to_device` upload of the same batches (rgb, yuv420, and YOLO12
at 960x1280); overwriting a submitted array changes nothing; `upload`
returns while the compute stream is still busy; `upload_staged` counts
every staged batch and `("upload_staged", "slot_wait")` only a wait for a
slot whose copy has not landed; the profiler names the copy a pinned
one; frames of a new geometry get a ring of their own; `export_compiled`
traces from a staged dummy. The file imports neither JAX nor the JAX package, so its card cases
also run on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_upload.py
"""
import numpy as np
import pytest
import torch

from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import device as tdevice
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.device import Readback, Upload, to_device
from xrseg_tpu_torch.models.yolo11 import init_params
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.runtime.streaming import StreamingRunner
from xrseg_tpu_torch.testing import detection_params, limit_cpu_threads

limit_cpu_threads()

CPU = torch.device("cpu")
CFG = ExecutorConfig(model=ModelConfig(input_size=(64, 64), dtype="float32"),
                     post=PostprocessConfig(pre_nms_topk=64, max_detections=10,
                                            score_threshold=1e-7))


def _frames(fmt, seed, B=1, hw=(64, 64)):
    """Seeded uint8 frames in the pipeline's input form."""
    rgb = np.random.default_rng(seed).integers(0, 256, (B, *hw, 3),
                                               np.uint8)
    if fmt == "rgb":
        return rgb
    return (rgb[..., 0].copy(), rgb[:, ::2, ::2, 1].copy(),
            rgb[:, ::2, ::2, 2].copy())


def _planes(frames):
    return frames if isinstance(frames, tuple) else (frames,)


@pytest.fixture(scope="module")
def model():
    return init_params(torch.Generator().manual_seed(0), CFG.model)


@pytest.mark.parametrize("route", ["Upload", "pipeline"])
@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_upload_is_a_copy_of_the_frames(model, fmt, route):
    frames = _frames(fmt, 1)
    want = [p.copy() for p in _planes(frames)]
    if route == "Upload":
        got = Upload(CPU).put(_planes(frames))
    else:
        pipe = build_pipeline(CFG, model, batch=1, device="cpu",
                              input_format=fmt)
        got = _planes(pipe.upload(frames))
    assert len(got) == (3 if fmt == "yuv420" else 1)
    for p in _planes(frames):
        p[:] = 255 - p                   # the caller reuses its arrays
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device == CPU
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_a_tensor_on_the_device_passes_through(model, fmt):
    pipe = build_pipeline(CFG, model, batch=1, device="cpu",
                          input_format=fmt)
    x = pipe.upload(_frames(fmt, 2))
    again = pipe.upload(x)
    assert all(a is b for a, b in zip(_planes(again), _planes(x)))


class _Ring:
    """Upload's place in a card pipeline, recording what it was given."""

    def __init__(self):
        self.given = []

    def put(self, planes):
        self.given.append(planes)
        return tuple(torch.as_tensor(p) for p in planes)


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_host_frames_for_a_card_take_the_ring(model, fmt, monkeypatch):
    """A card pipeline stages numpy and CPU tensors through its Upload,
    once a batch with every plane in one put; a device tensor (here one
    on the meta device) goes to `to_device` instead."""
    copied = []
    monkeypatch.setattr(tcompile, "to_device",
                        lambda x, dev: copied.append(x) or x)
    ring = _Ring()
    pipe = tcompile.CompiledPipeline(
        cfg=CFG, params=model, input_shape=(1, 64, 64, 3),
        device=torch.device("cuda", 0), input_format=fmt, staging=ring)
    frames = _frames(fmt, 3)
    tensors = tuple(torch.from_numpy(p) for p in _planes(frames))
    for host in (frames, tensors if fmt == "yuv420" else tensors[0]):
        got = pipe.upload(host)
        assert isinstance(got, tuple) == (fmt == "yuv420")
        assert all(torch.equal(g, torch.as_tensor(p))
                   for g, p in zip(_planes(got), _planes(host)))
    assert len(ring.given) == 2 and copied == []
    assert all(len(g) == len(_planes(frames)) for g in ring.given)
    on_device = tuple(torch.empty(p.shape, dtype=torch.uint8,
                                  device="meta") for p in _planes(frames))
    pipe.upload(on_device if fmt == "yuv420" else on_device[0])
    assert len(ring.given) == 2 and len(copied) == len(on_device)


def _layouts():
    base = np.random.default_rng(5).integers(0, 256, (2, 6, 8, 3), np.uint8)
    read_only = base.copy()
    read_only.flags.writeable = False
    wide = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 6, 16, 3), np.uint8))
    return {"contiguous": base, "read_only": read_only,
            "mirrored": base[:, :, ::-1], "strided_tensor": wide[:, :, ::2],
            "list": base.tolist()}


@pytest.mark.parametrize("layout", sorted(_layouts()))
def test_staging_copies_any_host_layout(layout):
    """What `Upload.put` copies into a pinned slot (here a plain buffer):
    the frames' values, from any host layout, and the slot's dtype."""
    x = _layouts()[layout]
    want = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.uint8)
    host = tdevice._host_tensor(x)
    assert tdevice._torch_dtype(host) == (
        torch.int64 if layout == "list" else torch.uint8)
    buf = torch.empty(want.shape, dtype=tdevice._torch_dtype(host))
    tdevice._fill(buf, host)
    np.testing.assert_array_equal(buf.numpy(), want)


def test_a_cpu_pipeline_stages_nothing(model):
    launches.reset()
    pipe = build_pipeline(CFG, model, batch=1, device="cpu")
    pipe(_frames("rgb", 7))
    assert pipe.staging is None
    assert launches.read()["upload_staged"] == 0


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (copy streams, pinned memory)")
    return torch.device("cuda")


CARD_CFG = ExecutorConfig(model=ModelConfig(input_size=(256, 320)),
                          post=PostprocessConfig(iou_threshold=0.6,
                                                 score_threshold=0.23))
YOLO12_CFG = ExecutorConfig(
    model=ModelConfig(arch="yolo12", scale="n", input_size=(960, 1280)),
    post=CARD_CFG.post)
GEOMETRIES = {"rgb": (CARD_CFG, "rgb", (240, 320), 4),
              "yuv420": (CARD_CFG, "yuv420", (240, 320), 4),
              "yolo12_960x1280": (YOLO12_CFG, "rgb", (960, 1280), 2)}
SLEEP = 400_000_000              # GPU cycles: a few hundred ms of one stream


def _card_pipe(card, cfg, fmt="rgb", hw=(240, 320), B=4):
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    return build_pipeline(cfg, model, frame_hw=hw, batch=B, device=card,
                          input_format=fmt).warmup()


def _pageable(pipe, frames):
    """The slate of a pageable to_device upload, on the host."""
    x = tuple(to_device(p, pipe.device) for p in _planes(frames))
    return pipe.enqueue(x if len(x) > 1 else x[0])["slate"].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_staged_stream_is_bit_equal_to_pageable(card, geometry):
    """Four distinct seeded batches through StreamingRunner(depth=2): the
    slates equal a pageable upload's bit for bit, though every submitted
    array is overwritten right after its submit, while the copy stream and
    the compute stream are both still held back by a sleep."""
    cfg, fmt, hw, B = GEOMETRIES[geometry]
    pipe = _card_pipe(card, cfg, fmt, hw, B)
    batches = [_frames(fmt, 10 + i, B, hw) for i in range(4)]
    want = [_pageable(pipe, b) for b in batches]
    assert all((w[:, -1] > 0).all() for w in want)   # every count above 0
    runner = StreamingRunner(pipe, depth=2)
    got = []
    for b in batches:
        own = tuple(p.copy() for p in _planes(b))
        with torch.cuda.stream(pipe.staging.stream):
            torch.cuda._sleep(SLEEP)
        torch.cuda._sleep(SLEEP)
        r = runner.submit(own if fmt == "yuv420" else own[0])
        for p in own:
            p[:] = 255 - p
        if r is not None:
            got.append(r)
    got.extend(runner.drain())
    assert [r.frame_id for r in got] == [0, 1, 2, 3]
    for r in got:
        assert torch.equal(r.device_out["slate"].cpu(), want[r.frame_id])


@pytest.mark.cuda
def test_upload_returns_while_the_card_computes(card):
    """With a long forward queued, `upload` returns before the compute
    stream's work is done (a Readback's computed() read without a sync),
    waits for nothing under torch's sync debug mode "error", and the
    staged frames, once there, equal the caller's."""
    pipe = _card_pipe(card, CARD_CFG)
    frames = [_frames("rgb", 20 + i, 4, (240, 320)) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP)
    out = pipe(frames[0])                 # queued behind the sleep
    slot = Readback(out["slate"].numel(), pipe.device)
    slot.start(out["slate"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = pipe.upload(frames[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not slot.computed()
    slot.release()
    assert torch.equal(x.cpu(), torch.from_numpy(frames[1]))


@pytest.mark.cuda
def test_staged_uploads_are_counted(card):
    """`upload_staged` counts every staged batch of a depth-2 stream and
    `slot_wait` none of them; a slot whose copy is held back is waited
    for, counted once, and its next batch still lands whole."""
    pipe = _card_pipe(card, CARD_CFG)
    batches = [_frames("rgb", 30 + i, 4, (240, 320)) for i in range(8)]
    runner = StreamingRunner(pipe, depth=2)
    torch.cuda.synchronize()
    launches.reset()
    assert len(list(runner.run(iter(batches)))) == 8
    counts = launches.read()
    assert counts["upload_staged"] == 8
    assert counts["upload_staged", "slot_wait"] == 0

    launches.reset()
    with torch.cuda.stream(pipe.staging.stream):
        torch.cuda._sleep(SLEEP)
    xs = [pipe.upload(b) for b in batches[:3]]   # the third reuses slot 0
    counts = launches.read()
    assert counts["upload_staged"] == 3
    assert counts["upload_staged", "slot_wait"] == 1
    for x, b in zip(xs, batches):
        assert torch.equal(x.cpu(), torch.from_numpy(b))


@pytest.mark.cuda
def test_the_staged_copy_is_pinned(card):
    """The profiler sees the staged upload's copy as one from pinned
    memory, never as a pageable one."""
    pipe = _card_pipe(card, CARD_CFG)
    frames = _frames("rgb", 50, 4, (240, 320))
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        pipe.upload(frames)
        torch.cuda.synchronize()
    copies = [e.key for e in prof.key_averages() if "Memcpy HtoD" in e.key]
    assert copies and all("Pinned" in k for k in copies), copies


@pytest.mark.cuda
def test_a_new_geometry_gets_a_new_ring(card):
    """Frames of another geometry (here another batch) are staged in a
    ring made for them, and the first geometry's after them again."""
    pipe = _card_pipe(card, CARD_CFG)
    for B in (4, 2, 4, 2):
        frames = _frames("rgb", 60 + B, B, (240, 320))
        assert torch.equal(pipe.upload(frames).cpu(),
                           torch.from_numpy(frames))


@pytest.mark.cuda
def test_export_traces_from_a_staged_dummy(card, tmp_path):
    """export_compiled uploads its dummy through the staging ring; the
    program it writes answers yuv420 planes as the pipeline does."""
    pipe = _card_pipe(card, CARD_CFG, "yuv420", B=1)
    launches.reset()
    path = str(tmp_path / "m.xrseg")
    tcompile.export_compiled(pipe, path)
    assert launches.read()["upload_staged"] == 2   # the warm call, the dummy
    run = tcompile.load_compiled(path)
    frames = _frames("yuv420", 40, 1, (240, 320))
    assert torch.equal(run(frames)["slate"], pipe(frames)["slate"])
