"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without
a card they raise instead of carrying on quietly on the CPU.

`Readback` is the one device-to-host copy of a frame: a pinned host buffer
filled on a copy stream of its own, with two events a caller can poll.
A Readback holds one frame at a time; a runner that keeps several frames
of one pipeline in flight takes one per frame
(`runtime/streaming.ReadbackSlots`).
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A tensor moves to `dev`; anything else (numpy, lists) is copied
    there, so read-only host arrays are never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.tensor(np.asarray(x), device=dev)


class Readback:
    """One flat float32 output's way to the host without blocking it.

    On a card it owns a pinned host buffer of `numel` floats and a copy
    stream. `start(out)` is called once the frame's last op is queued: the
    copy stream waits for the compute stream's work so far, then copies
    `out` into the buffer. `computed()` and `copied()` poll the two events
    and never block; `wait()` blocks until the copy has landed. `host()` is
    a view of the buffer that the next `start` overwrites, so a caller
    copies what it keeps.

    A slot holds one frame: from `start` until `host()` (or `release()`,
    for a frame that is dropped) the copy is held, and a second `start`
    raises instead of overwriting it.

    On the CPU there is no stream: `start` copies at once and both polls
    are true.
    """

    def __init__(self, numel: int, dev: torch.device):
        self.held = False        # a started copy that host() has not taken
        on_card = dev.type == "cuda"
        if on_card and dev.index is None:      # "cuda" -> the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.buffer = torch.empty(numel, dtype=torch.float32,
                                  pin_memory=on_card)
        self.stream = torch.cuda.Stream(dev) if on_card else None
        self._computed = torch.cuda.Event() if on_card else None
        self._copied = torch.cuda.Event() if on_card else None

    def start(self, out: torch.Tensor) -> None:
        flat = out.detach().reshape(-1)
        if flat.shape != self.buffer.shape or flat.dtype != torch.float32 \
                or flat.device != self.device:
            raise ValueError(
                f"readback of {tuple(out.shape)} {out.dtype} on {out.device} "
                f"into a buffer of {self.buffer.numel()} float32 for "
                f"{self.device}")
        if self.held:
            raise RuntimeError(
                "readback slot still holds a frame that host() has not "
                "taken; a second start() would overwrite it")
        self.held = True
        if self.stream is None:
            self.buffer.copy_(flat)
            return
        self._computed.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(self._computed)
        with torch.cuda.stream(self.stream):
            self.buffer.copy_(flat, non_blocking=True)
            self._copied.record(self.stream)
        # the allocator must not hand `out`'s memory to the compute stream
        # while the copy stream still reads it
        flat.record_stream(self.stream)

    def computed(self) -> bool:
        return self.stream is None or self._computed.query()

    def copied(self) -> bool:
        return self.stream is None or self._copied.query()

    def wait(self) -> None:
        if self.stream is not None:
            self._copied.synchronize()

    def host(self) -> np.ndarray:
        """Wait for the copy and hand it over: the slot is free again, and
        the view returned is overwritten by the next `start`."""
        self.wait()
        self.held = False
        return self.buffer.numpy()

    def release(self) -> None:
        """Free the slot without reading it (the frame was dropped)."""
        self.wait()
        self.held = False

