"""The program's own profiler ranges on the device, in a traced window.

A `record_function` range that the program opens on the host (`xrseg.*`)
shows up in a CUDA trace a second time, on the device: a user annotation
from the first to the last kernel that the host range launched. For each
named range this reduction gives the device's busy time inside the
union of those device intervals (the kernels' busy intervals, as
`trace.reduce` takes them, clipped to the window) and how many device
intervals there were. `trace.reduce` itself counts such annotations as
no work; this reads them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark.harness import trace


class Trace(trace.Trace):
    """trace.Trace whose summary also holds "ranges": name -> {"device_s",
    "count"} for each of `names` (see reduce_ranges)."""

    def __init__(self, names: Sequence[str]):
        super().__init__()
        self.names = tuple(names)

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if exc[0] is None:
            self.summary["ranges"] = reduce_ranges(
                trace._events(self._prof), self.names)
        return out


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce_ranges(events, names: Sequence[str]) -> Dict[str, Dict]:
    """events as trace._events gives them -> for each name, the device
    busy seconds inside its device-side intervals in the window, and
    their count (0 and 0 where the trace holds none)."""
    win = [(s, e) for k, n, s, e, _, _ in events
           if k == "cpu" and n == trace.WINDOW]
    if not win:
        raise RuntimeError("the trace holds no bench.window annotation")
    ws, we = win[0]

    def clipped(keep):
        return [(max(s, ws), min(e, we)) for k, n, s, e, _, ann in events
                if k == "dev" and keep(n, ann) and e > ws and s < we]

    busy = trace._union(clipped(
        lambda n, ann: not ann and not n.startswith(("bench.", "xrseg."))))
    out = {}
    for name in names:
        spans = clipped(lambda n, ann: n == name)
        out[name] = {"device_s": _overlap(busy, trace._union(spans)) / 1e9,
                     "count": len(spans)}
    return out
