"""HTTP inference server: the network-facing serving surface, stdlib only
(counterpart of xrseg_tpu/runtime/server.py).

A CompiledPipeline behind a threaded HTTP server with the endpoints a
deployment needs:

  POST /infer    image bytes (JPEG/PNG, any PIL format, or a raw .npy
                 [H,W,3] uint8 array) -> JSON detections:
                 {"detections": [{"label", "class_name", "score",
                  "box_xywh" (frame px; obb: "box_xywhr" in model px),
                  "kpts"? (pose: [[x, y, visibility]...] in frame px),
                  "mask_rle"? (COCO RLE, with --serve-masks)}...],
                  "count", "latency_ms"}
                 classify: {"probs", "label", "class_name", "latency_ms"}
  GET  /healthz  {"ok": true, ...model and geometry...}
  GET  /stats    per-stage latency percentiles and request counters
  GET  /metrics  the same counters in Prometheus text format (xrseg_*)
  POST /reload   {"path": "<weights>"}: weight hot-swap (.npz, .pt/.pth,
                 .onnx or .sentis, io/weights.load_params_auto); every batch
                 bucket's module is swapped under the dispatch lock, and
                 requests in flight finish on the old weights

Design: one dispatch thread owns the card. It builds the pipeline and
runs every request, so the card sees one stream of work and concurrency
goes into the batch axis, not into racing dispatches. It is also one
thread because PyTorch keeps some CUDA state per thread (cuDNN's
execution plans among it) and builds it again on a thread's first call
of each shape: CUDA work on a thread per connection would pay that on
every request. Request
decoding and resizing run on the host, per connection thread; /reload
moves the new weights to the card under the dispatch lock.

Micro-batching (micro_batch > 1): concurrent requests are collected for
up to `batch_window_ms` and run as ONE batched pipeline call. Batch sizes
are bucketed to powers of two, one pipeline per size built at its first
use; requests pad the bucket and the padding rows are discarded. Every
bucket runs the batched NMS kernel (K1) at its size. With micro_batch=1
every request is a batch of one. A batch's slates come back in one copy
through the pipeline's pinned readback; the pose keypoints and the served
masks of the batch's survivors in one more copy each.

Multi-device serving (mesh_shape, CLI --mesh data=N[,model=M]): the
pipeline is parallel/batch.build_serving_pipeline over a (data, model)
mesh; buckets start at the data axis and double, so each stays divisible
by it, a request pads its bucket, and each data shard runs K1 on its own
rows. On device="cpu" the mesh repeats the CPU device; on CUDA it takes
data*model distinct cards. /reload re-places the new weights on the mesh
(ShardedPipeline.reshard), /healthz reports the mesh.

Overload: pending work is bounded (max_pending); excess requests get an
immediate 503 with Retry-After instead of waiting in the queue. Bodies
larger than max_request_mb get a 413 before they are read.

CLI: python -m xrseg_tpu_torch.runtime.server --port 8000 \\
        [--weights w.npz] [--arch yolo11|yolov8] [--scale n] \\
        [--task segment|detect|obb|pose|classify] [--frame-hw 480 640] \\
        [--micro-batch 8 --batch-window-ms 3] [--device cuda|cpu] \\
        [--mesh data=2[,model=2] --tp-min-channels 256]
"""
from __future__ import annotations

import dataclasses
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.compile import build_pipeline, load_model, unpack_slate
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.io.weights import cast_params, load_params_auto
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.models.yolo11 import count_params
from xrseg_tpu_torch.parallel import mesh as mesh_lib
from xrseg_tpu_torch.parallel.batch import build_serving_pipeline
from xrseg_tpu_torch.ops.preprocess import boxes_to_frame_space
from xrseg_tpu_torch.runtime.tracing import Tracer
from xrseg_tpu_torch.viz.labels import COCO_LABELS


def rle_encode(mask: np.ndarray) -> dict:
    """Binary mask -> COCO uncompressed RLE ({counts, size}): column-major
    scan, counts alternating runs starting with the zero run (the
    pycocotools convention)."""
    flat = np.asarray(mask, bool).flatten(order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:      # counts must start with the 0-run
        counts = [0] + counts
    return {"counts": counts, "size": [int(mask.shape[0]),
                                       int(mask.shape[1])]}


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


class ServerOverloaded(RuntimeError):
    """Raised when the server sheds a request instead of queueing it:
    bounded pending work, failing fast with 503 + Retry-After."""


class InferenceServer:
    """Build once, serve many. start() serves from a daemon thread (tests);
    serve_forever() blocks (CLI)."""

    def __init__(self, cfg: ExecutorConfig, params=None,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 host: str = "127.0.0.1", port: int = 8000,
                 labels=None, seed: int = 0,
                 micro_batch: int = 1, batch_window_ms: float = 3.0,
                 params_dtype: Optional[str] = None,
                 serve_masks: bool = False,
                 mask_res: str = "proto",
                 mesh_shape: Optional[Dict[str, int]] = None,
                 tp_min_channels: int = 100000,
                 max_request_mb: float = 64.0,
                 max_pending: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = None
        self._data_axis = 1
        self.tp_min_channels = int(tp_min_channels)
        if mesh_shape:
            self.mesh = self._make_mesh(mesh_shape)
            self._data_axis = self.mesh.shape["data"]
        self.frame_hw = tuple(frame_hw or cfg.model.input_size)
        self.labels = list(labels) if labels is not None else list(COCO_LABELS)
        self.tracer = Tracer()
        # obb serves model-space xywhr: anisotropic frame scaling would
        # distort the angles
        self._task = cfg.model.task
        self._box_dim = 5 if self._task == "obb" else 4

        # serve_masks resolution: "proto" = input/4; "display" = the
        # server's frame geometry, resized on the device (mask_display_hw)
        if mask_res not in ("proto", "display"):
            raise ValueError(f"mask_res {mask_res!r}: 'proto'|'display'")
        self.mask_res = mask_res
        self._mask_display_hw = (self.frame_hw if serve_masks
                                 and mask_res == "display" else None)
        self.params_dtype = params_dtype
        self._lock = threading.Lock()         # the device
        self.max_request_bytes = int(max_request_mb * 1e6)
        # counters are bumped from concurrent handler threads; += is not
        # atomic, so they have a lock of their own
        self._counter_lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._t_start = time.time()
        # each detection's full-image sigmoid mask (uncropped), thresholded
        # at 0.5, as COCO uncompressed RLE
        self.serve_masks = bool(serve_masks and cfg.model.task == "segment")

        # -- micro-batching: buckets are powers of two, so round the cap
        # DOWN (micro_batch=6 must not dispatch a batch of 8)
        mb = max(1, int(micro_batch))
        self.micro_batch = 1 << (mb.bit_length() - 1)
        self.batch_window_ms = float(batch_window_ms)
        self._pipelines: Dict[int, object] = {}      # under self._lock
        self._batch_hist: Dict[int, int] = {}
        self._closing = False
        # default: 8 full micro-batches of headroom
        self.max_pending = (int(max_pending) if max_pending
                            else max(8, self.micro_batch * 8))
        self._shed = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_pending)
        # the dispatch thread builds and warms the b=1 pipeline, then
        # serves; a failed build is raised here
        ready = threading.Event()
        failed = []
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            args=(params, seed, ready, failed), daemon=True)
        self._dispatcher.start()
        ready.wait()
        if failed:
            self._dispatcher.join()
            raise failed[0]

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):   # quiet; the tracer has it
                pass

            def _reply(self, code: int, obj,
                       content_type: str = "application/json",
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> None:
                body = (obj.encode() if isinstance(obj, str)
                        else json.dumps(obj).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.health())
                elif self.path == "/stats":
                    self._reply(200, server.stats())
                elif self.path == "/metrics":
                    self._reply(200, server.metrics_text(),
                                content_type="text/plain; version=0.0.4")
                else:
                    self._reply(404, {"error": "unknown path"})

            # drop wedged or slow connections instead of pinning a handler
            # thread forever
            timeout = 120

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if n > server.max_request_bytes:
                    with server._counter_lock:
                        server._errors += 1
                    self._reply(413, {"error":
                                      f"request body {n} bytes exceeds "
                                      f"cap {server.max_request_bytes}"})
                    self.close_connection = True
                    return
                data = self.rfile.read(n)
                if self.path == "/infer":
                    try:
                        self._reply(200, server.infer_bytes(data))
                    except ServerOverloaded as e:   # shed, don't queue
                        self._reply(503, {"error": str(e)},
                                    extra_headers={"Retry-After": "1"})
                        self.close_connection = True
                    except Exception as e:   # bad image, wrong shape, ...
                        with server._counter_lock:
                            server._errors += 1
                        self._reply(400, {"error": str(e)})
                elif self.path == "/reload":
                    try:
                        self._reply(200, server.reload_weights(
                            json.loads(data or b"{}")))
                    except Exception as e:
                        self._reply(400, {"error": str(e)})
                else:
                    self._reply(404, {"error": "unknown path"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._serving = False    # shutdown() waits for a serve loop to end

    # ------------------------------------------------------------------

    def _make_mesh(self, mesh_shape: Dict[str, int]) -> mesh_lib.Mesh:
        """The serving mesh: data a power of two (buckets are powers of two
        and must stay divisible by it); data*model devices, the CPU
        repeated on device="cpu", distinct cards on CUDA."""
        d = int(mesh_shape.get("data", 1))
        m = int(mesh_shape.get("model", 1))
        if d < 1 or (d & (d - 1)):
            raise ValueError(
                f"mesh data axis {d} must be a power of two (batch "
                "buckets are powers of two and must stay divisible)")
        if m < 1:
            raise ValueError(f"mesh model axis {m} must be at least 1")
        return mesh_lib.device_mesh((d, m), self.device)

    def _decode(self, data: bytes) -> np.ndarray:
        """Image bytes -> [H,W,3] uint8 at the server's frame geometry."""
        if data[:6] == b"\x93NUMPY":
            arr = np.load(io.BytesIO(data))
            if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
                raise ValueError(f"npy must be [H,W,3] uint8, got "
                                 f"{arr.dtype} {arr.shape}")
        else:
            from PIL import Image
            arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                             np.uint8)
        if arr.shape[:2] != self.frame_hw:
            from PIL import Image
            arr = np.asarray(Image.fromarray(arr).resize(
                (self.frame_hw[1], self.frame_hw[0]), Image.BILINEAR),
                np.uint8)
        return arr

    def infer_bytes(self, data: bytes) -> dict:
        with self.tracer.section("decode"):
            frame = self._decode(data)
        t0 = time.perf_counter()
        host = self._infer_batched(frame)
        latency_ms = (time.perf_counter() - t0) * 1e3
        with self._counter_lock:
            self._requests += 1
        return self._format(host, latency_ms)

    def _run(self, pipe, frames: np.ndarray, n: int) -> List[dict]:
        """One pipeline call (device lock held) -> the host results of its
        first n images. The slates come back in one copy through the
        pipeline's pinned readback; the pose keypoints and the served
        masks of the batch's survivors in one more copy each, never one a
        request."""
        det = pipe(frames)
        pipe.readback.start(det["slate"])
        slates = pipe.readback.host().reshape(det["slate"].shape)
        if self._task == "classify":
            # the slate IS the prob row; copied, as the buffer is reused
            return [{"probs": np.array(slates[j])} for j in range(n)]
        out = [unpack_slate(slates[j], self.cfg.post.max_detections,
                            box_dim=self._box_dim) for j in range(n)]
        top = max(h["count"] for h in out)
        extras = ["kpts"] if "kpts" in det else []
        if self.serve_masks and "masks" in det:
            extras.append("masks")
        for k in extras:
            rows = det[k][:n, :top].float().cpu().numpy()
            for j, host in enumerate(out):
                host[k] = rows[j, :host["count"]]
        return out

    def _format(self, host: dict, latency_ms: float) -> dict:
        if self._task == "classify":
            probs = host["probs"]
            lab = int(probs.argmax())
            return {"probs": [round(float(p), 5) for p in probs],
                    "label": lab,
                    "class_name": (self.labels[lab]
                                   if 0 <= lab < len(self.labels)
                                   else str(lab)),
                    "latency_ms": round(latency_ms, 2)}
        n = int(host["count"])
        if self._task == "obb":
            boxes = np.asarray(host["boxes_xywhr"][:n])  # model space
        else:
            boxes = boxes_to_frame_space(host["boxes_xywh"][:n],
                                         self.frame_hw,
                                         self.cfg.model.input_size,
                                         "stretch")
        # keypoints scale exactly under the stretch (pointwise)
        ky = self.frame_hw[0] / self.cfg.model.input_size[0]
        kx = self.frame_hw[1] / self.cfg.model.input_size[1]
        dets = []
        for i in range(n):
            lab = int(host["labels"][i])
            d = {
                "label": lab,
                "class_name": (self.labels[lab]
                               if 0 <= lab < len(self.labels) else str(lab)),
                "score": round(float(host["scores"][i]), 4),
            }
            if self._task == "obb":
                d["box_xywhr"] = [round(float(v), 4) for v in boxes[i]]
            else:
                d["box_xywh"] = [round(float(v), 2) for v in boxes[i]]
            if "masks" in host and i < len(host["masks"]):
                d["mask_rle"] = rle_encode(host["masks"][i] > 0.5)
            if "kpts" in host and i < len(host["kpts"]):
                k = host["kpts"][i].copy()
                k[:, 0] *= kx
                k[:, 1] *= ky
                d["kpts"] = [[round(float(x), 2), round(float(y), 2),
                              round(float(v), 3)] for x, y, v in k]
            dets.append(d)
        return {"detections": dets, "count": n,
                "latency_ms": round(latency_ms, 2)}

    # -- micro-batching -------------------------------------------------

    class _Pending:
        __slots__ = ("frame", "event", "result", "error")

        def __init__(self, frame):
            self.frame = frame
            self.event = threading.Event()
            self.result = None
            self.error: Optional[Exception] = None

    def _infer_batched(self, frame: np.ndarray) -> dict:
        item = self._Pending(frame)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._counter_lock:
                self._shed += 1
            raise ServerOverloaded(
                f"batch queue full ({self.max_pending} pending)")
        if not item.event.wait(timeout=300.0):
            raise RuntimeError("inference timed out in the batch queue")
        if item.error is not None:
            raise item.error
        return item.result

    def _pipeline_for(self, b: int):
        """The bucket pipeline of batch b, built and warmed up at its
        first use (on the dispatch thread, device lock held)."""
        if b not in self._pipelines:
            with self.tracer.section(f"compile_b{b}"):
                self._pipelines[b] = self._build(b, self.pipeline.params)
        return self._pipelines[b]

    def _build(self, b: int, params):
        """A warmed-up pipeline of batch b over `params`: the serving
        module on the device, or over the mesh the host weights (placed on
        the first build) or the rows every bucket shares."""
        if self.mesh is None:
            return build_pipeline(
                self.cfg, params, frame_hw=self.frame_hw,
                batch=b, mask_display_hw=self._mask_display_hw,
                device=self.device).warmup()
        return build_serving_pipeline(
            self.cfg, params, self.mesh, batch=b,
            frame_hw=self.frame_hw, tp_min_channels=self.tp_min_channels,
            mask_display_hw=self._mask_display_hw).warmup()

    def _dispatch_loop(self, params, seed, ready, failed) -> None:
        """Build the first bucket's pipeline, then: collect requests for
        up to batch_window_ms, run ONE batched pipeline call, fan the
        results back out."""
        try:
            with self.tracer.section("load_model"):
                if self.mesh is None:
                    self.pipeline = load_model(
                        self.cfg, params=params, seed=seed,
                        frame_hw=self.frame_hw, batch=1,
                        params_dtype=self.params_dtype,
                        mask_display_hw=self._mask_display_hw,
                        device=self.device)
                else:
                    if params is None:
                        params = yolo11.init_params(
                            torch.Generator().manual_seed(seed),
                            self.cfg.model)
                    if self.params_dtype is not None:
                        params = cast_params(params, self.params_dtype)
                    self.pipeline = self._build(self._data_axis, params)
            self._pipelines[self._data_axis] = self.pipeline
        except Exception as e:        # raised again by the constructor
            failed.append(e)
            return
        finally:
            ready.set()
        while not self._closing:
            try:
                items = [self._q.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.perf_counter() + self.batch_window_ms / 1e3
            while len(items) < self.micro_batch:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=rem))
                except queue.Empty:
                    break
            b = self._data_axis       # buckets stay data-axis divisible
            while b < len(items):
                b *= 2
            try:
                frames = np.stack(
                    [it.frame for it in items]
                    + [np.zeros_like(items[0].frame)] * (b - len(items)))
                with self._lock, self.tracer.section("infer"):
                    results = self._run(self._pipeline_for(b), frames,
                                        len(items))
                self._batch_hist[len(items)] = (
                    self._batch_hist.get(len(items), 0) + 1)
                for it, host in zip(items, results):
                    it.result = host
                    it.event.set()
            except Exception as e:       # surface to every waiting request
                for it in items:
                    it.error = e
                    it.event.set()

    def reload_weights(self, req: dict) -> dict:
        """Weight hot-swap: POST /reload {"path": "..."}.

        The file is read and checked on the host; a checkpoint whose
        structure or shapes differ from the serving model is refused. The
        new module is cast to the serving storage dtype, moved to the
        device and swapped into every bucket under the dispatch lock;
        requests in flight finish on the old weights."""
        path = req.get("path")
        if not path:
            raise ValueError('body must be {"path": "<weights>"}')
        try:
            new, _ = load_params_auto(path, self.cfg.model)
        except (KeyError, RuntimeError) as e:
            raise ValueError("weights do not match the serving model "
                             f"({self.cfg.model.scale}/"
                             f"{self.cfg.model.task}): {e}") from e
        if self.params_dtype is not None:
            new = cast_params(new, self.params_dtype)
        n_params = count_params(new)
        with self._lock:
            if self.mesh is None:
                placed = new.to(self.device).eval()
            else:                         # re-place on the mesh
                placed = self.pipeline.reshard(new)
            for b, pipe in list(self._pipelines.items()):
                self._pipelines[b] = dataclasses.replace(pipe, params=placed)
            self.pipeline = self._pipelines[self._data_axis]
        return {"ok": True, "path": path, "n_params": n_params}

    def metrics_text(self) -> str:
        """Prometheus text exposition of the /stats counters."""
        s = self.stats()
        lines = [
            "# TYPE xrseg_requests_total counter",
            f"xrseg_requests_total {s['requests']}",
            "# TYPE xrseg_errors_total counter",
            f"xrseg_errors_total {s['errors']}",
            "# TYPE xrseg_shed_total counter",
            f"xrseg_shed_total {s['shed']}",
            "# TYPE xrseg_queue_depth gauge",
            f"xrseg_queue_depth {s['queue_depth']}",
            "# TYPE xrseg_uptime_seconds gauge",
            f"xrseg_uptime_seconds {s['uptime_s']}",
        ]
        for stage, v in s.get("stages", {}).items():
            for q in ("p50_ms", "p95_ms"):
                if q in v:
                    lines.append(
                        f'xrseg_stage_latency_ms{{stage="{stage}",'
                        f'quantile="{q[:-3]}"}} {v[q]}')
        for k, v in s.get("batch_hist", {}).items():
            lines.append(f'xrseg_batches_total{{size="{k}"}} {v}')
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        out = {"ok": True, "scale": self.cfg.model.scale,
               "task": self.cfg.model.task,
               "frame_hw": list(self.frame_hw),
               "input_size": list(self.cfg.model.input_size)}
        if self.mesh is not None:
            out["mesh"] = self.mesh.shape
        return out

    def stats(self) -> dict:
        out = {"requests": self._requests, "errors": self._errors,
               "shed": self._shed, "max_pending": self.max_pending,
               "queue_depth": self._q.qsize(),
               "uptime_s": round(time.time() - self._t_start, 1),
               "stages": self.tracer.summary()}
        if self.micro_batch > 1:
            out["micro_batch"] = self.micro_batch
            out["batch_hist"] = {str(k): v for k, v
                                 in sorted(self._batch_hist.items())}
        return out

    # ------------------------------------------------------------------

    def start(self) -> "InferenceServer":
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            self._serving = False

    def close(self) -> None:
        self._closing = True
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._dispatcher.join(timeout=5)
        # fail queued requests fast instead of letting their handler
        # threads wait out the 300 s timeout
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            it.error = RuntimeError("server closing")
            it.event.set()


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--weights", help=".npz (either package's), .pt/.pth "
                    "(ultralytics state dict), .onnx or .sentis "
                    "weights")
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--task", default="segment",
                    choices=["segment", "detect", "obb", "pose",
                             "classify"])
    ap.add_argument("--classes", type=int, default=80)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=None)
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--score", type=float, default=0.23)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--micro-batch", type=int, default=1,
                    help="max dynamic batch size (1 = off); rounded DOWN "
                         "to a power of two (one pipeline per bucket)")
    ap.add_argument("--batch-window-ms", type=float, default=3.0,
                    help="how long to wait collecting a batch")
    ap.add_argument("--params-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="weight storage precision, cast once at build")
    ap.add_argument("--serve-masks", action="store_true",
                    help="include per-detection COCO-RLE masks in /infer "
                         "responses")
    ap.add_argument("--mask-res", default="proto",
                    choices=["proto", "display"],
                    help="served mask resolution: 'proto' (input/4) or "
                         "'display' (frame geometry, resized on the "
                         "device)")
    ap.add_argument("--max-request-mb", type=float, default=64.0,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--mesh", default=None,
                    help="multi-device serving mesh, e.g. 'data=4' or "
                         "'data=4,model=2' (data must be a power of two)")
    ap.add_argument("--tp-min-channels", type=int, default=100000,
                    help="shard conv output channels >= this over the "
                         "mesh model axis (TP; default effectively off)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="overload shedding: max requests pending before "
                         "503 + Retry-After (default 8*micro_batch)")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        mesh_shape = {}
        for part in args.mesh.split(","):
            k, _, v = part.partition("=")
            if k.strip() not in ("data", "model") or not v.strip().isdigit():
                ap.error(f"--mesh: bad spec {part!r} (want data=N[,model=M])")
            mesh_shape[k.strip()] = int(v)

    mcfg = ModelConfig(arch=args.arch, scale=args.scale, task=args.task,
                       num_classes=args.classes)
    params = None
    if args.weights:
        params, mcfg = load_params_auto(args.weights, mcfg)
    cfg = ExecutorConfig(model=mcfg)
    cfg = dataclasses.replace(cfg, post=dataclasses.replace(
        cfg.post, iou_threshold=args.iou, score_threshold=args.score))
    srv = InferenceServer(cfg, params=params,
                          frame_hw=(tuple(args.frame_hw) if args.frame_hw
                                    else None),
                          host=args.host, port=args.port,
                          micro_batch=args.micro_batch,
                          batch_window_ms=args.batch_window_ms,
                          params_dtype=args.params_dtype,
                          serve_masks=args.serve_masks,
                          mask_res=args.mask_res,
                          mesh_shape=mesh_shape,
                          tp_min_channels=args.tp_min_channels,
                          max_request_mb=args.max_request_mb,
                          max_pending=args.max_pending,
                          device=args.device)
    mesh_note = f"; mesh {srv.mesh.shape}" if srv.mesh is not None else ""
    print(f"serving on http://{args.host}:{srv.port} ({srv.device}"
          f"{mesh_note}; POST /infer, GET /healthz, GET /stats)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
