"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without
a card they raise instead of carrying on quietly on the CPU.

The two directions of a frame's copy, each a pinned host buffer and a copy
stream of its own, so that the compute stream never carries a copy:

- `Upload` is the one host-to-device copy of a frame batch: a ring of
  pinned staging slots, copied on its stream; the compute stream waits on
  the slot's event, and the host waits on the card only for a slot whose
  copy two batches back has not landed yet.
- `Readback` is the one device-to-host copy of a frame: a pinned host
  buffer filled on its stream once the compute stream's work is done,
  with two events a caller can poll. A Readback holds one frame at a
  time; a runner that keeps several frames of one pipeline in flight
  takes one per frame (`runtime/streaming.ReadbackSlots`).

`to_device` is the pageable copy of everything else (the CPU, weights,
targets).
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
    there, so read-only host arrays are never aliased. A numpy view with a
    negative stride (a mirrored frame, `img[:, ::-1]`) is made contiguous
    first: torch refuses negative strides."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.tensor(np.asarray(x, order="C"), device=dev)


def on_host(x) -> bool:
    """Whether `x` lies in host memory: numpy, lists and CPU tensors."""
    return not isinstance(x, torch.Tensor) or x.device.type == "cpu"


class Upload:
    """A frame batch's way to the card without the compute stream carrying
    the copy or the host waiting for the card: `Readback`'s twin.

    On a card it owns a copy stream and a ring of SLOTS staging slots,
    each pinned host buffers for every plane and one event, made for one
    input geometry (the planes' shapes and dtypes) at its first `put` (a
    pipeline's warmup) and made anew when the geometry changes.
    `put(planes)` takes the ring's next slot (waiting for its last copy to
    land, if it has not: the wait is counted), copies the planes into it
    on the host, so the caller may reuse its arrays at once, then copies
    the slot to new device tensors on the copy stream.
    The current (compute) stream waits on the slot's event before it
    reads them; the copy stream never waits on the compute stream, so a
    batch's copy runs beside the forwards queued before it. Every batch
    is staged afresh: nothing is keyed on the caller's arrays.

    On the CPU there is no stream: `put` copies with `to_device`.
    """

    SLOTS = 2

    def __init__(self, dev: torch.device):
        on_card = dev.type == "cuda"
        if on_card and dev.index is None:      # "cuda" -> the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.stream = torch.cuda.Stream(dev) if on_card else None
        self._geometry = None
        self._ring = []            # SLOTS x (pinned planes, event)
        self._turn = 0

    def put(self, planes) -> tuple:
        """The planes (numpy or CPU tensors) as device tensors the
        current stream may read, in their order."""
        if self.stream is None:
            return tuple(to_device(p, self.device) for p in planes)
        from xrseg_tpu_torch.ops import launches   # ops imports this module
        host = [_host_tensor(p) for p in planes]
        staged, landed = self._slot(host)
        waited = not landed.query()
        if waited:
            landed.synchronize()
        for buf, h in zip(staged, host):
            _fill(buf, h)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = tuple(torch.empty(b.shape, dtype=b.dtype,
                                    device=self.device)
                        .copy_(b, non_blocking=True) for b in staged)
            landed.record(self.stream)
        compute.wait_event(landed)
        for t in out:
            # the allocator must not hand the block back to the copy
            # stream while the compute stream still reads it
            t.record_stream(compute)
        launches.count("upload_staged", "slot_wait" if waited else None)
        return out

    def _slot(self, host):
        geometry = tuple((tuple(h.shape), _torch_dtype(h)) for h in host)
        if geometry != self._geometry:
            # a dropped slot's pinned memory is not reused before its copy
            # lands: the host allocator holds it until the copy's event
            self._geometry, self._turn = geometry, 0
            self._ring = [
                (tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                       for shape, dtype in geometry), torch.cuda.Event())
                for _ in range(self.SLOTS)]
        slot = self._ring[self._turn]
        self._turn = (self._turn + 1) % self.SLOTS
        return slot


def _host_tensor(x):
    """A CPU tensor, or a numpy array that torch cannot view without a
    copy (read-only, or with a negative stride: a mirrored frame)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.flags.writeable and all(s >= 0 for s in a.strides):
        return torch.from_numpy(a)
    return a


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


def _fill(buf: torch.Tensor, src) -> None:
    """Copy `src` into the pinned `buf` of its shape and dtype."""
    if isinstance(src, torch.Tensor):
        buf.copy_(src)
    else:
        np.copyto(buf.numpy(), src, casting="no")


class Readback:
    """One flat output's way to the host without blocking it.

    On a card it owns a pinned host buffer of `numel` elements of `dtype`
    (float32 unless asked: a slate; SAM's packed rows are bytes) and a
    copy stream. `start(out)` is called once the frame's last op is
    queued: the copy stream waits for the compute stream's work so far,
    then copies `out` into the buffer. `computed()` and `copied()` poll the
    two events and never block; `wait()` blocks until the copy has landed.
    `host()` is a view of the buffer that the next `start` overwrites, so
    a caller copies what it keeps.

    A slot holds one frame: from `start` until `host()` (or `release()`,
    for a frame that is dropped) the copy is held, and a second `start`
    raises instead of overwriting it.

    On the CPU there is no stream: `start` copies at once and both polls
    are true.
    """

    def __init__(self, numel: int, dev: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.held = False        # a started copy that host() has not taken
        on_card = dev.type == "cuda"
        if on_card and dev.index is None:      # "cuda" -> the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.buffer = torch.empty(numel, dtype=dtype, pin_memory=on_card)
        self.stream = torch.cuda.Stream(dev) if on_card else None
        self._computed = torch.cuda.Event() if on_card else None
        self._copied = torch.cuda.Event() if on_card else None

    def start(self, out: torch.Tensor) -> None:
        flat = out.detach().reshape(-1)
        if flat.shape != self.buffer.shape or flat.dtype != \
                self.buffer.dtype or flat.device != self.device:
            raise ValueError(
                f"readback of {tuple(out.shape)} {out.dtype} on {out.device} "
                f"into a buffer of {self.buffer.numel()} {self.buffer.dtype} "
                f"for {self.device}")
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

