"""Device-level profiling: torch.profiler traces (counterpart of
xrseg_tpu/runtime/profiling.py).

Two layers, as in the JAX package:

  - runtime/tracing.Tracer: host-side per-stage p50/p95 timers (always
    on, ~free) — what /stats and the executor report. Enabled
    (`Tracer.enable(True)`), its sections are also named ranges
    ("xrseg.<name>") in these traces.
  - THIS module: torch.profiler traces of the host ops and, on a card,
    every CUDA kernel with its device time — for deep perf work. Each
    trace is a Chrome trace JSON (open it in chrome://tracing or
    Perfetto).

Usage:
    from xrseg_tpu_torch.runtime.profiling import device_trace, profile_fn

    with device_trace("trace_dir"):
        pipe(frames)                       # any device work

    profile_fn(lambda: pipe(frames), "trace_dir", steps=3)
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace (CPU ops, and CUDA kernels when a
    card is present) into `logdir` as `trace-<pid>-<ns>.json`.

    torch.profiler does not nest; as in the JAX package, an inner scope
    inside an active one is a no-op."""
    os.makedirs(logdir, exist_ok=True)
    if getattr(device_trace, "_active", False):
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    device_trace._active = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        device_trace._active = False


def _sync(out) -> None:
    """Wait for the device work behind `out` (the block_until_ready of the
    JAX package): synchronise every card when one is present."""
    del out
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_fn(fn: Callable[[], object], logdir: str, steps: int = 3,
               warmup: int = 1) -> str:
    """Run `fn` under a device trace (after `warmup` untraced calls, so
    kernel builds and first-call allocations stay out of the timeline).
    Returns `logdir`."""
    for _ in range(warmup):
        _sync(fn())
    with device_trace(logdir):
        for _ in range(steps):
            _sync(fn())
    return logdir

