"""Inference executor: async dispatch + readback-polling state machine
(counterpart of xrseg_tpu/runtime/executor.py).

Rebuild of the reference's IEExecutor
(Assets/Scripts/InferenceEngine/IEExecutor.cs). The mapping:

  Unity/Sentis                          xrseg_tpu_torch
  -----------------------------------   ----------------------------------
  Worker.ScheduleIterable + 25          CUDA launches are asynchronous: the
  layers/frame time-slicing (:395-399)  pipeline call queues the frame's
                                        kernels and returns
  4x Tensor.ReadbackRequest +           device.Readback: ONE copy into a
  IsReadbackRequestDone polling         pinned buffer on a copy stream,
  (:419-456)                            two events polled with query()
  InferenceDownloadState enum (:17-25)  ExecState enum (same states)
  ProcessInferenceResult (:458-526)     process_result: parse -> track ->
                                        mask -> RGBD extract
  warmup Schedule at load (:384-385)    CompiledPipeline.warmup()

The reference reads back all four outputs in full (incl. [N,160,160]
masks). Here the small slate (boxes/labels/scores/count) comes back every
frame, and only the *tracked target's* mask row is fetched (a device-side
gather). With ExecutorConfig.fused_tick the tracked frame's slate, match,
target mask and fused points come back in that one copy.

On device="cpu" there are no streams: the copy is a plain copy and both
polls are true at once.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from xrseg_tpu_torch.compile import (CompiledPipeline, XRTickPipeline,
                                     build_xr_tick_pipeline, load_model,
                                     unpack_slate)
from xrseg_tpu_torch.config import ExecutorConfig
from xrseg_tpu_torch.device import Readback, resolve_device
from xrseg_tpu_torch.ops.masks import synthesize_one_mask
from xrseg_tpu_torch.perception.camera import LatencyCompensator, Pose
from xrseg_tpu_torch.perception.rgbd import PointCloud, PointCloudExtractor
from xrseg_tpu_torch.perception.tracking import (BoundingBox,
                                                 MultiTargetTracker,
                                                 TargetTracker, Track,
                                                 box_to_model_space,
                                                 parse_boxes)
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.tracing import Tracer
from xrseg_tpu_torch.viz.boxer import Boxer
from xrseg_tpu_torch.viz.labels import COCO_LABELS
from xrseg_tpu_torch.viz.masker import Masker


class ExecState(enum.Enum):
    """InferenceDownloadState equivalent (IEExecutor.cs:17-25)."""
    IDLE = -1
    RUNNING = 0
    REQUESTING_OUTPUTS = 1
    SUCCESS = 2
    ERROR = 3
    CLEANUP = 4
    COMPLETED = 5


@dataclasses.dataclass
class FrameResult:
    boxes: List[BoundingBox]
    tracked: Optional[BoundingBox] = None
    point_cloud: Optional[PointCloud] = None
    count: int = 0
    latency_s: float = 0.0
    tracks: Optional[List[Track]] = None   # multi_tracking extension


class Executor:
    """Single-stream inference executor with tracking + RGBD fusion."""

    def __init__(self, cfg: ExecutorConfig = ExecutorConfig(), params=None,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 screen_wh: Optional[Tuple[float, float]] = None,
                 labels=None, seed: int = 0, depth_backend: str = "torch",
                 auto_recompile: bool = False, max_cached_pipelines: int = 4,
                 device="cuda"):
        if cfg.model.task not in ("detect", "segment"):
            raise ValueError(
                f"Executor supports detect/segment (the XR product "
                f"tasks), not {cfg.model.task!r}; use compile."
                "build_pipeline for the other tasks")
        self.cfg = cfg
        self.device = resolve_device(device)    # raises without a card
        self.auto_recompile = auto_recompile
        # LRU cache of per-geometry pipelines. Each geometry costs a warm-up
        # frame and holds a pinned readback buffer, so a long-running
        # server feeding many resolutions must evict; the reference
        # re-derives per texture instead (IEExecutor.cs:369).
        self.max_cached_pipelines = max(1, int(max_cached_pipelines))
        self._pipelines: "OrderedDict[tuple, CompiledPipeline]" = OrderedDict()
        self.tracer = Tracer()
        with self.tracer.section("load_model"):
            self.pipeline: CompiledPipeline = load_model(
                cfg, params=params, seed=seed, frame_hw=frame_hw, batch=1,
                emit_masks=cfg.emit_masks, device=self.device)
        self.is_model_loaded = True
        self.frame_hw = tuple(frame_hw or cfg.model.input_size)
        self._pipelines[tuple(self.frame_hw)] = self.pipeline
        self.screen_wh = screen_wh or (float(self.frame_hw[1]),
                                       float(self.frame_hw[0]))
        self.labels = list(labels) if labels is not None else list(COCO_LABELS)
        self.boxer = Boxer(self.labels)
        self.masker = Masker(cfg.confidence_threshold,
                             mask_hw=cfg.model.mask_size)
        self.tracker = TargetTracker(cfg.tracking_gate_px,
                                     cfg.select_margin_px)
        self.multi_tracker = (
            MultiTargetTracker(motion=cfg.motion_model,
                               reid_threshold=cfg.reid_threshold,
                               high_score=cfg.track_high_score)
            if cfg.multi_tracking else None)
        self.points = PointCloudExtractor(cfg.depth, backend=depth_backend,
                                          device=self.device)
        self.latency = LatencyCompensator(cfg.depth.latency_seconds)

        # fused-tick mode (ExecutorConfig.fused_tick): the re-lock match
        # + target-mask synthesis + depth fusion run behind the frame's
        # network (compile.build_xr_tick_pipeline) and a tracked frame
        # costs ONE packed copy instead of three serialized round trips.
        # Pipelines cache per (frame_hw, depth_hw) geometry.
        if cfg.fused_tick and cfg.model.task != "segment":
            raise ValueError("fused_tick requires task='segment'")
        self._tick_pipes: "OrderedDict[tuple, XRTickPipeline]" = OrderedDict()
        self._inflight_fused = False
        self._inflight_tick_pipe: Optional[XRTickPipeline] = None
        self._readback: Optional[Readback] = None   # of the frame in flight
        # frame ids tag the tracer's sections and device spans: the last
        # dispatched frame's, and the frame in flight's (a pipelined
        # runner stages an older one)
        self._frame_id = -1
        self._inflight_id = -1

        self._state = ExecState.IDLE
        self._inflight: Optional[dict] = None
        self._inflight_meta: Optional[FrameData] = None
        self._dispatch_t0 = 0.0
        self._host: dict = {}
        self.current_frame_boxes: List[BoundingBox] = []
        self.last_result: Optional[FrameResult] = None
        # device-side outputs of the last completed frame (masks/coefs stay
        # on device; consumers gather what they need)
        self.last_device_out: Optional[dict] = None
        # depth double-buffer (PrepareDepthData, IEExecutor.cs:317-361)
        self._depth_frame: Optional[np.ndarray] = None
        self._depth_pose: Optional[Pose] = None
        self._last_ts: Optional[float] = None
        self._prev_result_ts: Optional[float] = None

    # ------------------------------------------------------------------
    # public API (mirrors IEExecutor's surface)
    # ------------------------------------------------------------------

    @property
    def state(self) -> ExecState:
        return self._state

    def is_running(self) -> bool:
        """IsRunning (IEExecutor.cs:378)."""
        return self._state not in (ExecState.IDLE, ExecState.COMPLETED)

    @property
    def is_tracking(self) -> bool:
        return self.tracker.is_tracking

    @property
    def locked_target_box(self) -> Optional[BoundingBox]:
        return self.tracker.locked_box

    @property
    def point_buffer(self) -> Optional[PointCloud]:
        return self.points.current

    def run_inference(self, frame: FrameData) -> bool:
        """Non-blocking dispatch (RunInference, IEExecutor.cs:363-376).
        Returns False if a frame is already in flight.

        The pipeline is bound per frame geometry; with auto_recompile a
        new geometry builds (and caches) a fresh pipeline; the reference
        likewise re-derives its input size per texture (IEExecutor.cs:369).
        """
        if self.is_running():
            return False
        self.prepare_depth_data(frame)
        self._frame_id += 1
        fid = self._inflight_id = self._frame_id
        with self.tracer.section("dispatch", fid):
            frames = frame.rgb[None]
            hw = tuple(frames.shape[1:3])
            if hw != tuple(self.frame_hw):
                if not self.auto_recompile:
                    raise ValueError(
                        f"frame {hw} != executor frame_hw {self.frame_hw} "
                        "(construct with auto_recompile=True to allow "
                        "mixed frame sizes)")
                if hw not in self._pipelines:
                    with self.tracer.section("recompile", fid):
                        self._pipelines[hw] = load_model(
                            self.cfg, params=self.pipeline.params,
                            frame_hw=hw, batch=1,
                            emit_masks=self.cfg.emit_masks,
                            device=self.device)
                self._pipelines.move_to_end(hw)
                while len(self._pipelines) > self.max_cached_pipelines:
                    self._pipelines.popitem(last=False)   # evict LRU geometry
                self.pipeline = self._pipelines[hw]
                self.frame_hw = hw
                self.screen_wh = (float(hw[1]), float(hw[0]))
            fused = (self.cfg.fused_tick and frame.depth_fp16 is not None
                     and frame.intrinsics is not None
                     and self._depth_pose is not None)
            if fused:
                self._inflight = self._dispatch_fused(frame, frames)
                self._readback = self._inflight_tick_pipe.readback
            else:
                # async: the call queues the frame's kernels and returns
                with self.tracer.device_span("frame_device", fid,
                                             self.device):
                    self._inflight = self.pipeline(frames)
                self._readback = self.pipeline.readback
            self._inflight_fused = fused
            # eager readback: queue the copy NOW, behind the frame's last
            # op, so it starts on the copy stream the moment compute
            # finishes (REQUESTING_OUTPUTS finds it in flight or done). A
            # failure here is a failure of the frame and is not caught.
            self._readback.start(
                self._inflight["packed" if fused else "slate"])
        self._inflight_meta = frame
        self._dispatch_t0 = time.perf_counter()
        self._state = ExecState.RUNNING
        self.tracer.count("frames_dispatched")
        return True

    def update(self) -> Optional[FrameResult]:
        """Per-tick state machine (UpdateInference, IEExecutor.cs:389-417).
        Returns a FrameResult when a frame completes, else None."""
        if self._state == ExecState.RUNNING:
            # device still computing? (the time-slice analogue: never
            # block): the event recorded behind the frame's last op
            if self._readback.computed():
                # account the dispatch->ready window as its own stage so
                # per-frame splits SUM to frame time
                self.tracer.interval("device_wait", self._dispatch_t0,
                                     time.perf_counter(), self._inflight_id)
                self._state = ExecState.REQUESTING_OUTPUTS
            return None

        if self._state == ExecState.REQUESTING_OUTPUTS:
            self._update_parallel_readbacks()
            return None

        if self._state == ExecState.SUCCESS:
            with self.tracer.section("process", self._inflight_id):
                result = self._process_result()
            self._state = ExecState.CLEANUP
            self.last_result = result
            self.last_device_out = self._inflight
            return result

        if self._state in (ExecState.ERROR, ExecState.CLEANUP):
            if self._readback is not None and self._readback.held:
                self._readback.release()      # a frame dropped unread
            self._inflight = None
            self._readback = None
            self._host = {}
            self._state = ExecState.COMPLETED
            return None

        return None

    def run_sync(self, frame: FrameData) -> FrameResult:
        """Convenience: dispatch + drain to completion (test harness path)."""
        if not self.run_inference(frame):
            raise RuntimeError("executor busy")
        while True:
            r = self.update()
            if r is not None:
                self.update()   # run CLEANUP -> COMPLETED
                return r
            if self._state == ExecState.COMPLETED:
                raise RuntimeError("inference failed (ERROR state)")

    def reset_tracking(self) -> None:
        """ResetTracking (IEExecutor.cs:703-712)."""
        self.tracker.reset()
        if self.multi_tracker is not None:
            self.multi_tracker.reset()
        self.points.clear()
        self.masker.reset()

    def clear_point_cloud(self) -> None:
        self.points.clear()

    def select_target_from_screen_pos(self, screen_pos) -> bool:
        """SelectTargetFromScreenPos (IEExecutor.cs:768-805)."""
        return self.tracker.select_target(self.current_frame_boxes,
                                          screen_pos, self.screen_wh)

    def extract_point_cloud_at_screen_pos(self, screen_pos
                                          ) -> Optional[PointCloud]:
        """ExtractPointCloudAtScreenPos (IEExecutor.cs:721-763)."""
        box = self.tracker.find_at_screen_pos(self.current_frame_boxes,
                                              screen_pos, self.screen_wh)
        if box is None:
            self.points.clear()
            return None
        return self._extract_depth_for(box)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def prepare_depth_data(self, frame: FrameData) -> None:
        """Depth double-buffer + pose latency compensation
        (PrepareDepthData, IEExecutor.cs:317-361)."""
        if frame.depth_fp16 is None or frame.pose is None:
            return
        dt = (1 / 30 if self._last_ts is None
              else max(1e-3, frame.timestamp - self._last_ts))
        self._last_ts = frame.timestamp
        self._depth_pose = self.latency.compensate(frame.pose, dt)
        self._depth_frame = frame.depth_fp16

    def _tick_pipe_for(self, hw: tuple, depth_hw: tuple):
        """Get/build the fused tick pipeline for this geometry."""
        key = (tuple(hw), tuple(depth_hw))
        pipe = self._tick_pipes.get(key)
        if pipe is None:
            with self.tracer.section("recompile", self._frame_id):
                pipe = build_xr_tick_pipeline(
                    self.cfg, self.pipeline.params, frame_hw=hw,
                    depth_hw=depth_hw,
                    emit_target_mask=self.cfg.enable_ui_rendering,
                    device=self.device).warmup()
            self._tick_pipes[key] = pipe
            while len(self._tick_pipes) > self.max_cached_pipelines:
                self._tick_pipes.popitem(last=False)
        else:
            self._tick_pipes.move_to_end(key)
        return pipe

    def _dispatch_fused(self, frame: FrameData, frames: np.ndarray):
        """One-dispatch tracked tick: the previous target box rides in as an
        input; the program re-locks, synthesizes the matched mask and
        fuses the point cloud on the device (IEExecutor.cs:485-526,561-651
        semantics, compile.XRTickPipeline)."""
        pipe = self._tick_pipe_for(tuple(frames.shape[1:3]),
                                   self._depth_frame.shape)
        lb = self.tracker.locked_box
        if self.tracker.is_tracking and lb is not None:
            cx, cy, _, _ = box_to_model_space(
                lb, self.screen_wh,
                tuple(map(float, self.cfg.model.input_size)))
            prev = (cx, cy, float(lb.label), 1.0)
        else:
            prev = (0.0, 0.0, -1.0, 0.0)
        mh, mw = (float(v) for v in self.cfg.model.input_size)
        intr = frame.intrinsics
        aux = pipe.pack_aux(intr.focal_length, intr.principal_point,
                            intr.resolution, self._depth_pose.position,
                            self._depth_pose.rotation, prev,
                            (self.screen_wh[0] / mw,
                             self.screen_wh[1] / mh))
        self._inflight_tick_pipe = pipe
        with self.tracer.device_span("frame_device", self._frame_id,
                                     self.device):
            return pipe(frames, self._depth_frame, aux)

    def _update_parallel_readbacks(self) -> None:
        """UpdateParallelReadbacks (IEExecutor.cs:419-456): the copy into
        the pinned buffer was queued at dispatch; poll its event, then
        unpack on the host. The whole small-output readback is ONE packed
        array, so one copy per frame (the reference pays 4 readbacks,
        IEExecutor.cs:446-449). Both unpack functions copy out of the
        buffer, which the next dispatch overwrites.
        """
        key = "packed" if self._inflight_fused else "slate"
        if self._inflight.get(key) is None:
            # missing output buffer
            self._state = ExecState.ERROR
            return
        if not self._readback.copied():
            return
        with self.tracer.section("readback", self._inflight_id):
            if self._inflight_fused:
                # fused tick: slate + matched flag/index + target mask +
                # fused points arrive in the ONE packed copy
                self._host = self._inflight_tick_pipe.unpack(
                    self._readback.host())
            else:
                self._host = unpack_slate(self._readback.host(),
                                          self.cfg.post.max_detections)
            self.tracer.device_done("frame_device", self._inflight_id)
        self._state = ExecState.SUCCESS

    @staticmethod
    def _has_mask_outputs(dev: Optional[dict]) -> bool:
        """Whether a pipeline output dict can yield per-target masks:
        either a materialized slate (emit_masks='all') or coefs+protos
        (emit_masks='none', on-demand synthesis)."""
        return dev is not None and (
            "masks" in dev or ("coefs" in dev and "protos" in dev))

    def _device_target_mask(self, dev: dict, slate_index: int):
        """One target's [h,w] mask as a DEVICE tensor: a slate-row gather
        (emit_masks='all') or an on-demand matvec synthesis
        (emit_masks='none': the row is computed only now, never stored
        in a [D,h,w] slate)."""
        if "masks" in dev:
            return dev["masks"][0, slate_index]
        return synthesize_one_mask(dev["coefs"][0], dev["protos"][0],
                                   slate_index)

    def _fetch_target_mask(self, slate_index: int) -> np.ndarray:
        """Device-side gather of one mask row -> small device-to-host
        copy."""
        dev = self._inflight if self._has_mask_outputs(self._inflight) \
            else self.last_device_out
        with self.tracer.section("mask_fetch", self._inflight_id):
            return self._device_target_mask(dev, slate_index).float() \
                .cpu().numpy()

    def _extract_depth_for(self, box: BoundingBox) -> Optional[PointCloud]:
        """ExtractDepthData (IEExecutor.cs:561-651).

        On the torch backend the target's mask never leaves the device: the
        slate-row gather and the fusion run there (extract_points_for_target).
        The native backend copies the mask to the host for the C++ fusion,
        as the JAX package's does."""
        if self._depth_frame is None or self._depth_pose is None:
            return None
        meta = self._inflight_meta
        intr = meta.intrinsics if meta is not None else None
        if intr is None:
            return None
        # masks live on device in the in-flight outputs, or — between
        # frames (e.g. laser-held extraction, IEPassthroughTrigger.cs:98) —
        # in the retained last completed outputs
        dev = self._inflight if self._has_mask_outputs(self._inflight) \
            else self.last_device_out
        if not self._has_mask_outputs(dev):
            return None
        raw_box = box_to_model_space(
            box, self.screen_wh,
            tuple(map(float, self.cfg.model.input_size)))
        with self.tracer.section("depth_fusion", self._inflight_id):
            if self.points.backend == "native":
                # the C++ fusion reads a host mask: one small copy
                mask = self._device_target_mask(dev, box.index).float()
                return self.points.extract(self._depth_frame,
                                           mask.cpu().numpy(), raw_box, intr,
                                           self._depth_pose)
            if "masks" in dev:
                return self.points.extract_from_slate(
                    self._depth_frame, dev["masks"][0], box.index,
                    raw_box, intr, self._depth_pose)
            # coefs-only pipeline: synthesize just this target's mask on
            # the device, then fuse (no mask slate was ever materialized)
            m = self._device_target_mask(dev, box.index)
            return self.points.extract_from_slate(
                self._depth_frame, m[None], 0,
                raw_box, intr, self._depth_pose)

    def _process_result(self) -> FrameResult:
        """ProcessInferenceResult (IEExecutor.cs:458-526)."""
        h = self._host
        count = int(h["count"])
        self.current_frame_boxes = parse_boxes(
            h["boxes_xywh"], h["labels"], h["scores"], count,
            self.screen_wh, self.labels,
            max_boxes=self.cfg.post.max_detections,
            model_size=tuple(map(float, self.cfg.model.input_size)))
        latency = time.perf_counter() - self._dispatch_t0
        result = FrameResult(boxes=self.current_frame_boxes, count=count,
                             latency_s=latency)

        # capability extension: id'd tracks for every detection, every frame
        if self.multi_tracker is not None:
            embeddings = None
            if (self.cfg.reid_threshold > 0 and count
                    and self._inflight is not None
                    and "coefs" in self._inflight):
                # mask-coef rows as free appearance descriptors ([n,32])
                embeddings = self._inflight["coefs"][0][:count].float() \
                    .cpu().numpy()
            result.tracks = self.multi_tracker.update(
                self.current_frame_boxes, embeddings=embeddings)

        # Case 1: not tracking -> box overlay only (IEExecutor.cs:470-483)
        if not self.tracker.is_tracking:
            return result

        # Case 2: tracking (IEExecutor.cs:485-526). In fused-tick mode the
        # match already happened ON DEVICE (ops/relock.py) against the
        # locked box we sent at dispatch; adopt its result and keep the
        # host tracker state in sync (it remains the parity oracle).
        if self._inflight_fused and "matched" in h:
            matched = None
            if h["matched"] and h["matched_index"] < len(
                    self.current_frame_boxes):
                matched = self.current_frame_boxes[h["matched_index"]]
                self.tracker.locked_box = matched
        else:
            matched = self.tracker.update(self.current_frame_boxes)
        has_masks = self._has_mask_outputs(self._inflight)
        # per-frame dt for the masker's SmoothDamp (the reference damps from
        # Update() every frame, IEMasker.cs:65-80)
        meta = self._inflight_meta
        ts = meta.timestamp if meta is not None else None
        dt = 1 / 30
        # only trust ts deltas that actually advance: FrameData.timestamp
        # defaults to 0.0, so a source that never stamps would otherwise
        # yield dt=1e-3 every frame (~33x slower damping than intended)
        if (ts is not None and self._prev_result_ts is not None
                and ts > self._prev_result_ts):
            dt = min(0.5, max(1e-3, ts - self._prev_result_ts))
        self._prev_result_ts = ts
        if matched is not None:
            result.tracked = matched
            if not has_masks:          # detect-only task: boxes-only tracking
                return result
            if self._inflight_fused and "points_packed" in h:
                # fused tick: mask + fused points came in the frame's one
                # readback — no further device round-trips this frame
                if self.cfg.enable_ui_rendering and "target_mask" in h:
                    self.masker.draw_single_mask(matched, h["target_mask"],
                                                 (int(self.screen_wh[0]),
                                                  int(self.screen_wh[1])),
                                                 dt)
                result.point_cloud = self.points.collect_packed(
                    h["points_packed"])
                return result
            if self.cfg.enable_ui_rendering:
                mask = self._fetch_target_mask(matched.index)
                self.masker.draw_single_mask(matched, mask,
                                             (int(self.screen_wh[0]),
                                              int(self.screen_wh[1])), dt)
            result.point_cloud = self._extract_depth_for(matched)
        else:
            # lost frame: keep the overlay but continue damping toward the
            # last target (IEMasker.cs:201-208 + per-Update SmoothDamp)
            self.masker.keep_current_mask(dt)
            result.point_cloud = self.points.current
        return result
