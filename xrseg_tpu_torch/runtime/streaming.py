"""Streaming runners: several frames of one pipeline in flight
(counterpart of xrseg_tpu/runtime/streaming.py).

StreamingRunner keeps up to `depth` frame batches queued behind the one
being read: the host queues batch i+1.. while the card computes batch i
and copies the slate of i-1. PipelinedTickRunner does the same for the
executor's fused XR tick.

Each frame in flight needs its own host buffer: a pipeline's
`device.Readback` holds one frame, and a second start would overwrite
it. So a runner owns `ReadbackSlots`: for each output length, a slot for
every frame it can hold in flight, taken in turn. Frames are started and
consumed in FIFO order, which is the slots' order, and a slot whose frame
has not been read raises instead of being overwritten. The JAX package's
`copy_to_host_async()` is the slot's `start()`, its `is_ready()` spin a
poll of the slot's copy event.

Results come back in FIFO order via `submit()`'s return value, `drain()`
or the `run()` iterator.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

import torch

from xrseg_tpu_torch.compile import CompiledPipeline
from xrseg_tpu_torch.device import Readback
from xrseg_tpu_torch.runtime.tracing import Tracer


@dataclasses.dataclass
class StreamResult:
    frame_id: int
    slate: Dict[str, Any]           # unpacked host slate (boxes/labels/...)
    latency_s: float
    device_out: Dict[str, Any]      # device-side tensors (masks, coefs)


class ReadbackSlots:
    """`slots` Readbacks for each output length, taken in turn. A runner
    that keeps up to `slots` frames in flight and reads them in FIFO order
    takes `next(numel, dtype)` for each frame it starts; a slot whose frame
    was not read yet raises in `start` rather than lose it. Lengths differ
    only when a tick runner's executor switches geometry; the dtype is a
    pipeline's own (float32 slates, SAM's uint8 rows)."""

    def __init__(self, device, slots: int):
        if slots < 1:
            raise ValueError("readback slots: need at least one")
        self.device, self.slots = device, slots
        self._by_len: Dict[int, List[Readback]] = {}
        self._turn: Dict[int, int] = {}

    def next(self, numel: int, dtype=torch.float32) -> Readback:
        ring = self._by_len.get(numel)
        if ring is None or ring[0].buffer.dtype != dtype:
            ring = self._by_len[numel] = [Readback(numel, self.device, dtype)
                                          for _ in range(self.slots)]
            self._turn[numel] = 0
        i = self._turn.get(numel, 0)
        self._turn[numel] = (i + 1) % self.slots
        return ring[i]


class StreamingRunner:
    """Pipelined frame streaming over a compiled pipeline.

    depth=2 is classic double buffering; deeper queues more batches ahead
    of the one being read, at the cost of result lag.
    """

    def __init__(self, pipeline: CompiledPipeline, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipeline = pipeline
        self.depth = depth
        self.tracer = Tracer()
        # a batch is read once depth more are queued behind it
        self._slots = ReadbackSlots(pipeline.device, depth + 1)
        self._inflight: Deque[Tuple[int, float, Dict[str, Any], Readback]] = \
            collections.deque()
        self._next_id = 0

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def submit(self, frames) -> Optional[StreamResult]:
        """Dispatch a frame batch (the pipeline's input: frames, or its
        tuple of them, the yuv420 planes or SAM's frames and boxes);
        returns the oldest completed result once the pipeline is full, else
        None (fill phase).

        With the tracer enabled, the batch's spans carry its frame_id:
        dispatch { upload, enqueue, readback_start } here and readback
        { device_wait, unpack } when it is read; `batch_device` times its
        program on the card, and `queued_at_submit` adds the batches
        still computing on the card at entry (read from their slots'
        events, no sync) to divide by `batches_submitted`."""
        tr, fid = self.tracer, self._next_id
        if tr.enabled:
            tr.count("batches_submitted")
            tr.count("queued_at_submit",
                     sum(not slot.computed() for *_, slot in self._inflight))
        with tr.section("dispatch", fid):
            with tr.device_span("batch_device", fid, self.pipeline.device):
                # the upload (staged on a copy stream: the host waits
                # only for its own copy into the pinned slot), then the
                # program's launches on frames already there
                with tr.detail("upload", fid):
                    x = self.pipeline.upload(frames)
                with tr.detail("enqueue", fid):
                    out = self.pipeline.enqueue(x)
            with tr.detail("readback_start", fid):
                slot = self._slots.next(out["slate"].numel(),
                                        out["slate"].dtype)
                slot.start(out["slate"])
        self._inflight.append((fid, time.perf_counter(), out, slot))
        self._next_id += 1
        tr.count("frames_submitted")
        if len(self._inflight) > self.depth:
            return self._pop()
        return None

    def _pop(self) -> StreamResult:
        fid, t0, out, slot = self._inflight.popleft()
        tr = self.tracer
        with tr.section("readback", fid):
            if tr.enabled:
                with tr.section("device_wait", fid):
                    slot.wait()
                tr.device_done("batch_device", fid)
            with tr.detail("unpack", fid):
                # a copy, so the slot may take the next frame
                slate = self.pipeline.unpack_rows(
                    slot.host().reshape(out["slate"].shape), out)
        return StreamResult(frame_id=fid, slate=slate,
                            latency_s=time.perf_counter() - t0,
                            device_out=out)

    def drain(self) -> Iterator[StreamResult]:
        """Yield all remaining in-flight results."""
        while self._inflight:
            yield self._pop()

    def run(self, frames_iter) -> Iterator[StreamResult]:
        """Stream an iterator of frame batches end to end."""
        for frames in frames_iter:
            r = self.submit(frames)
            if r is not None:
                yield r
        yield from self.drain()


class PipelinedTickRunner:
    """Depth-K pipelined fused XR tick over an Executor.

    The executor's state machine keeps one frame in flight. In fused-tick
    mode the only frame-to-frame data dependency is the previous target
    box riding into the next dispatch (ops/relock.py), so frame N+1 can be
    dispatched with a box one result stale while frame N is still on the
    card. Staleness is bounded by depth-1 results, inside the tracker's
    300 px same-class gate.

    depth=1 is the executor's own sequential fused tick; depth=2 is double
    buffering. The executor stays the single owner of tracker, masker and
    point-cloud state: results pop in FIFO dispatch order and go through
    Executor._process_result, with the executor's in-flight fields (its
    `_readback` included) staged to the popped frame.
    """

    def __init__(self, executor, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if not executor.cfg.fused_tick:
            raise ValueError("PipelinedTickRunner requires an executor "
                             "built with ExecutorConfig(fused_tick=True)")
        self.ex = executor
        self.depth = depth
        # at most `depth` ticks are in flight: the depth-th pops at once
        self._slots = ReadbackSlots(executor.device, depth)
        # (frame id, device outputs, tick pipeline, frame, dispatch t0,
        # readback slot)
        self._q: Deque[Tuple[int, Dict[str, Any], Any, Any, float,
                             Readback]] = collections.deque()

    @property
    def inflight(self) -> int:
        return len(self._q)

    def submit(self, frame) -> Optional[Any]:
        """Dispatch one tracked tick; returns the oldest completed
        FrameResult once `depth` frames are in flight, else None."""
        ex = self.ex
        if ex.is_running():
            raise RuntimeError("executor has a classic frame in flight")
        if frame.depth_fp16 is None or frame.intrinsics is None \
                or frame.pose is None:
            raise ValueError("fused tick needs depth_fp16 + intrinsics + "
                             "pose")
        ex.prepare_depth_data(frame)
        ex._frame_id += 1
        fid = ex._frame_id
        with ex.tracer.section("dispatch", fid):
            dev = ex._dispatch_fused(frame, frame.rgb[None])
            pipe = ex._inflight_tick_pipe
            slot = self._slots.next(pipe.packed_len)
            slot.start(dev["packed"])
        self._q.append((fid, dev, pipe, frame, time.perf_counter(), slot))
        ex.tracer.count("frames_dispatched")
        if len(self._q) >= self.depth:
            return self._pop()
        return None

    def _pop(self):
        ex = self.ex
        fid, dev, pipe, frame, t0, slot = self._q.popleft()
        # poll-then-read mirrors the executor's stage split: device_wait is
        # the residual wait for this frame's copy, so per-frame stages
        # still sum to wall time
        t_wait = time.perf_counter()
        while not slot.copied():
            time.sleep(0)
        ex.tracer.interval("device_wait", t_wait, time.perf_counter(), fid)
        with ex.tracer.section("readback", fid):
            host = pipe.unpack(slot.host())
            ex.tracer.device_done("frame_device", fid)
        # stage the executor's in-flight fields, then reuse its own
        # ProcessInferenceResult path (tracker/masker/points/re-ID)
        ex._inflight = dev
        ex._inflight_fused = True
        ex._inflight_tick_pipe = pipe
        ex._inflight_meta = frame
        ex._dispatch_t0 = t0
        ex._readback = slot
        ex._host = host
        ex._inflight_id = fid
        with ex.tracer.section("process", fid):
            result = ex._process_result()
        ex.last_result = result
        ex.last_device_out = dev
        return result

    def drain(self) -> Iterator[Any]:
        """Yield all remaining in-flight results (FIFO)."""
        while self._q:
            yield self._pop()

    def run(self, frames_iter) -> Iterator[Any]:
        """Stream FrameData end to end through the pipelined tick."""
        for frame in frames_iter:
            r = self.submit(frame)
            if r is not None:
                yield r
        yield from self.drain()
