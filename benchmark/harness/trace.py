"""The traced window: torch.profiler over a block of the run, reduced to
what the per-layer metrics read.

The window is the host-clock span of a `bench.window` annotation. Device
events (kernels, copies, memsets) are clipped to it. Busy time is the
union of their intervals, not their sum, so overlapping copy-stream and
compute-stream work counts once. Idle gaps are the window's stretches
with nothing on the device; each of the longest is labelled by what the
host was doing at its midpoint: the benchmark's own span (`bench.*`
annotations) and the outermost aten op on any thread.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
LABELLED_GAPS = 400


def span(name: str, on: bool):
    """A `bench.<name>` annotation while tracing; nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"bench.{name}")


class Trace:
    """with Trace() as t: ...; then t.summary (a dict, see reduce)."""

    def __init__(self):
        self.summary: Optional[Dict] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = reduce(_events(self._prof))
        return False


def _events(prof) -> List[Tuple[str, str, int, int, int, bool]]:
    """(kind "cpu"|"dev", name, start_ns, end_ns, thread, annotation)."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            s = int(e.start_ns())
            out.append(("dev" if dev else "cpu", e.name(), s,
                        s + int(e.duration_ns()), int(e.start_thread_id()),
                        bool(e.is_user_annotation())))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append(("dev" if dev else "cpu", e.name,
                    int(e.time_range.start * 1000),
                    int(e.time_range.end * 1000), int(e.thread),
                    e.name.startswith("bench.")))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(events) -> Dict:
    win = [(s, e) for k, n, s, e, _, _ in events
           if k == "cpu" and n == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no bench.window annotation")
    ws, we = win[0]
    dev = [(max(s, ws), min(e, we), n) for k, n, s, e, _, ann in events
           if k == "dev" and not ann and not n.startswith("bench.")
           and e > ws and s < we]
    busy = _union([(s, e) for s, e, _ in dev if e > s])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, int] = collections.defaultdict(int)
    h2d = 0
    for s, e, n in dev:
        by_name[n] += e - s
        if "HtoD" in n:
            h2d += e - s
    gaps = []
    prev = ws
    for s, e in busy + [(we, we)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    labels = _labeller(events, ws, we)
    by_label: Dict[str, int] = collections.defaultdict(int)
    for length, s, e in gaps[:LABELLED_GAPS]:
        by_label[labels((s + e) // 2)] += length
    rest = sum(g[0] for g in gaps[LABELLED_GAPS:])
    if rest:
        by_label[f"shorter gaps than the {LABELLED_GAPS} longest"] += rest
    return {
        "window_s": (we - ws) / 1e9,
        "busy_s": busy_ns / 1e9,
        "launches": sum(1 for s, _, _ in dev if s >= ws),
        "h2d_s": h2d / 1e9,
        "device_ops": sorted(([_short(n), t / 1e9]
                              for n, t in by_name.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": sorted(([k, t / 1e9] for k, t in by_label.items()),
                            key=lambda r: -r[1])[:10],
        "spans": _span_times(events, ws, we),
    }


def _short(name: str, n: int = 160) -> str:
    """A kernel's (often very long, templated) name, cut for the record."""
    return name if len(name) <= n else name[:n - 3] + "..."


def _span_times(events, ws, we) -> Dict[str, List[Tuple[int, int]]]:
    out: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    for k, n, s, e, _, _ in events:
        if k == "cpu" and n.startswith("bench.") and n != WINDOW \
                and s >= ws and s < we:
            out[n[len("bench."):]].append((s, e))
    return dict(out)


def _labeller(events, ws, we):
    """t -> "<bench span> / <outermost aten op>" at host time t."""
    spans = sorted((s, e, n[len("bench."):]) for k, n, s, e, _, _ in events
                   if k == "cpu" and n.startswith("bench.") and n != WINDOW)
    ops = sorted((s, e, n) for k, n, s, e, _, ann in events
                 if k == "cpu" and not ann and n.startswith("aten::")
                 and e > ws and s < we)
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]

    def covering(starts, items, t, reach, outer):
        """The longest (outer) or shortest item covering t."""
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 1 - reach), -1):
            s, e, n = items[j]
            if e >= t and (best is None
                           or (e - s > best[1] - best[0]) == outer):
                best = (s, e, n)
        return best[2] if best else None

    def label(t: int) -> str:
        sp = covering(span_starts, spans, t, 64, False) or "no bench span"
        op = covering(op_starts, ops, t, 4000, True) or "no aten op"
        return f"{sp} / {op}"

    return label
