"""The process-wide count of the hand-written kernels' launches (K1-K7)
and of the fused attention calls, each under its wrapper's name
(`nms_select_batched_cuda`, ..., `conv_epilogue_cuda`,
`area_attention_cuda`). K1 also counts by batch size, (name, B); K7 its
launches on a channels-last output, (name, "channels_last").

`read()` returns a Counter of every count so far (a key never counted
reads 0); `reset()` zeroes them all, details included. Nothing counts on
the CPU, where the wrappers run their plain versions.
"""
from __future__ import annotations

import collections
import threading
from typing import Hashable, Optional

_COUNTS: "collections.Counter" = collections.Counter()
_LOCK = threading.Lock()        # a server's threads may launch at once


def count(name: str, detail: Optional[Hashable] = None) -> None:
    """One launch of `name`, and one of (name, detail) with a detail."""
    with _LOCK:
        _COUNTS[name] += 1
        if detail is not None:
            _COUNTS[name, detail] += 1


def read() -> "collections.Counter":
    """A copy of every count so far."""
    with _LOCK:
        return collections.Counter(_COUNTS)


def reset() -> None:
    """Zero every count, details included."""
    with _LOCK:
        _COUNTS.clear()
