"""HTTP serving load test: throughput and latency under concurrency (the
port's tools/loadtest.py).

Starts an in-process InferenceServer (or targets --url), fires N
concurrent client threads each posting M frames, and reports fps and
latency percentiles. The point: quantify dynamic micro-batching:
concurrent batch-1 requests against a micro_batch>1 server coalesce into
batched launches (one dispatch and one K1 launch per BATCH instead of
per request).

    python -m xrseg_tpu_torch.tools.loadtest [--clients 16] \\
        [--per-client 20] [--micro-batch 8] [--frame-hw 640 640] \\
        [--scale n] [--weights w.npz] [--device cuda]
    python -m xrseg_tpu_torch.tools.loadtest --url http://host:port
        # load an existing server (another process) instead

Prints one JSON line per configuration.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Optional, Sequence

import numpy as np


def run_load(url: str, clients: int, per_client: int, frame_hw) -> dict:
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (*frame_hw, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, img)
    payload = buf.getvalue()

    lat: list = []
    lat_lock = threading.Lock()
    errors = [0]

    def client():
        for _ in range(per_client):
            t0 = time.perf_counter()
            req = urllib.request.Request(f"{url}/infer", data=payload,
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    json.loads(r.read())
            except Exception:
                errors[0] += 1
                continue
            with lat_lock:
                lat.append(time.perf_counter() - t0)

    # warmup: concurrent bursts so every power-of-2 batch bucket the load
    # will hit has run before measurement
    def one_post():
        urllib.request.urlopen(urllib.request.Request(
            f"{url}/infer", data=payload, method="POST"), timeout=600)

    for burst in {1, 2, clients}:
        ts = [threading.Thread(target=one_post) for _ in range(burst)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    lat.clear()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    n = len(lat)
    return {
        "clients": clients,
        "requests": n,
        "errors": errors[0],
        "fps": round(n / elapsed, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1) if n else None,
        "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 1) if n else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--per-client", type=int, default=20)
    ap.add_argument("--micro-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=(640, 640))
    ap.add_argument("--scale", default="n")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--params-dtype", default=None)
    ap.add_argument("--url", default=None,
                    help="target an existing server instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.url:
        out = run_load(args.url, args.clients, args.per_client,
                       tuple(args.frame_hw))
        print(json.dumps(out))
        return 0

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.runtime.server import InferenceServer

    mcfg = ModelConfig(scale=args.scale)
    params = None
    if args.weights:
        from xrseg_tpu_torch.io.weights import load_params_auto
        params, mcfg = load_params_auto(args.weights, mcfg)
    # each client has one request in flight at most, so a cap of one
    # per client sheds none: the load measures the server, not its
    # shedding (the default cap, 8 micro-batches, is 8 requests at
    # micro-batch 1 and would turn 16 clients' posts into 503s)
    srv = InferenceServer(ExecutorConfig(model=mcfg), params=params,
                          frame_hw=tuple(args.frame_hw), port=0,
                          micro_batch=args.micro_batch,
                          batch_window_ms=args.batch_window_ms,
                          params_dtype=args.params_dtype,
                          max_pending=args.clients,
                          device=args.device).start()
    try:
        out = run_load(f"http://127.0.0.1:{srv.port}", args.clients,
                       args.per_client, tuple(args.frame_hw))
        out["micro_batch"] = args.micro_batch
        out["batch_hist"] = {k: v for k, v
                             in sorted(srv._batch_hist.items())}
        print(json.dumps(out))
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
