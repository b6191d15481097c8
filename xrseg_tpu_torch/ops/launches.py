"""The process-wide count of the hand-written kernels' launches (K1-K7),
of the fused attention calls, of the frames' staged copies and of the
box prompts SAM decodes, each under its wrapper's name
(`nms_select_batched_cuda`, ..., `conv_epilogue_cuda`,
`area_attention_cuda`, `relpos_attention_cuda`, `upload_staged`,
`sam_prompts`). K1 also counts by batch size, (name, B); K7 its launches
on a channels-last output, (name, "channels_last"); the rel-pos attention
its windowed and global calls, (name, "window") and (name, "global");
`device.Upload` each staged batch that had to wait for its slot's earlier
copy to land, ("upload_staged", "slot_wait").

`read()` returns a Counter of every count so far (a key never counted
reads 0); `reset()` zeroes them all, details included. Nothing counts on
the CPU, where the wrappers run their plain versions and frames are copied
with `device.to_device`.
"""
from __future__ import annotations

import collections
import threading
from typing import Hashable, Optional

_COUNTS: "collections.Counter" = collections.Counter()
_LOCK = threading.Lock()        # a server's threads may launch at once


def count(name: str, detail: Optional[Hashable] = None, n: int = 1
          ) -> None:
    """`n` launches (or items) of `name`, and as many of (name, detail)
    with a detail."""
    with _LOCK:
        _COUNTS[name] += n
        if detail is not None:
            _COUNTS[name, detail] += n


def read() -> "collections.Counter":
    """A copy of every count so far."""
    with _LOCK:
        return collections.Counter(_COUNTS)


def reset() -> None:
    """Zero every count, details included."""
    with _LOCK:
        _COUNTS.clear()
