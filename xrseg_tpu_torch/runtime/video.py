"""Video-file FrameSource: Y4M (YUV4MPEG2) and MJPEG-AVI, stdlib-only.

The reference consumes a live passthrough camera
(WebCamTextureManager.cs); for offline runs — replaying captured XR
clips through the demo / eval / MOT pipelines — this module serves
video files through the same FrameSource protocol
(runtime/frame_source.py) without any codec dependency:

  - `.y4m` — the uncompressed interchange format every ffmpeg can
    write (`ffmpeg -i clip.mp4 clip.y4m`); C420/C422/C444 subsampling,
    BT.601 limited-range YUV -> RGB (the format's convention).
  - `.avi` with MJPEG frames (`ffmpeg -i clip.mp4 -c:v mjpeg out.avi`):
    the RIFF container is walked directly; each '??dc' chunk is a JPEG
    decoded via PIL (already a dependency for the image-decode paths).

Frames stream (one at a time — arbitrarily long clips never fully
load); `realtime=True` paces playback to the container frame rate, and
the native YUV planes ride along in FrameData.yuv for pipelines that
want them (the reference's camera delivers YUV too).
"""
from __future__ import annotations

import os
import struct
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from xrseg_tpu_torch.runtime.frame_source import FrameData, FrameSource


# ---------------------------------------------------------------------------
# YUV -> RGB (BT.601 limited range, the Y4M convention)
# ---------------------------------------------------------------------------

def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar YUV (full-res planes, uint8, limited range) -> RGB uint8."""
    yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    uf = (u.astype(np.float32) - 128.0) * (255.0 / 224.0)
    vf = (v.astype(np.float32) - 128.0) * (255.0 / 224.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], -1), 0.0, 255.0).astype(np.uint8)


def _upsample_chroma(c: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor chroma upsample to the luma grid."""
    H, W = hw
    ry, rx = H // c.shape[0], W // c.shape[1]
    return np.repeat(np.repeat(c, ry, axis=0), rx, axis=1)


# ---------------------------------------------------------------------------
# Y4M
# ---------------------------------------------------------------------------

_Y4M_PLANES = {          # colorspace tag prefix -> (chroma h-div, v-div)
    "420": (2, 2),       # 420, 420jpeg, 420mpeg2, 420paldv
    "422": (2, 1),
    "444": (1, 1),
}


class _Y4MReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self._read_line()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 file")
        self.width = self.height = 0
        self.fps = 30.0
        self.subsample = (2, 2)
        for tok in header.split()[1:]:
            tag, val = chr(tok[0]), tok[1:].decode("ascii")
            if tag == "W":
                self.width = int(val)
            elif tag == "H":
                self.height = int(val)
            elif tag == "F":
                num, den = val.split(":")
                self.fps = float(num) / float(den)
            elif tag == "C":
                for prefix, div in _Y4M_PLANES.items():
                    if val.startswith(prefix):
                        self.subsample = div
                        break
                else:
                    raise ValueError(f"unsupported Y4M colorspace C{val}")
        if not self.width or not self.height:
            raise ValueError("Y4M header missing W/H")

    def _read_line(self) -> bytes:
        out = bytearray()
        while True:
            b = self.f.read(1)
            if not b or b == b"\n":
                return bytes(out)
            out += b

    def read_frame(self) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
        line = self._read_line()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad Y4M frame marker: {line[:16]!r}")
        W, H = self.width, self.height
        dx, dy = self.subsample
        cw, ch = W // dx, H // dy
        n = W * H + 2 * cw * ch
        raw = self.f.read(n)
        if len(raw) < n:
            return None                      # truncated tail
        y = np.frombuffer(raw, np.uint8, W * H).reshape(H, W)
        u = np.frombuffer(raw, np.uint8, cw * ch, W * H).reshape(ch, cw)
        v = np.frombuffer(raw, np.uint8, cw * ch,
                          W * H + cw * ch).reshape(ch, cw)
        return y, u, v

    def rewind(self) -> None:
        self.f.seek(0)
        self._read_line()                    # skip the stream header

    def close(self) -> None:
        self.f.close()


# ---------------------------------------------------------------------------
# MJPEG-AVI (RIFF walk)
# ---------------------------------------------------------------------------

class _AVIReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        hdr = self.f.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF/AVI file")
        self.fps = 30.0
        self.width = self.height = 0
        self._movi_start = None
        self._movi_end = None
        # walk top-level chunks to find hdrl (headers) and movi (frames)
        while True:
            head = self.f.read(8)
            if len(head) < 8:
                break
            fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
            start = self.f.tell()
            if fourcc == b"LIST":
                list_type = self.f.read(4)
                if list_type == b"hdrl":
                    self._parse_hdrl(start + size)
                elif list_type == b"movi":
                    self._movi_start = self.f.tell()
                    self._movi_end = start + size
                    break                    # frames stream from here
                else:
                    self.f.seek(start + size + (size & 1))
                    continue
                self.f.seek(start + size + (size & 1))
            else:
                self.f.seek(start + size + (size & 1))
        if self._movi_start is None:
            raise ValueError(f"{path}: no movi LIST found")
        self._pos = self._movi_start

    def _parse_hdrl(self, end: int) -> None:
        while self.f.tell() < end:
            head = self.f.read(8)
            if len(head) < 8:
                return
            fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
            start = self.f.tell()
            if fourcc == b"avih":
                data = self.f.read(min(size, 40))
                usec = struct.unpack_from("<I", data, 0)[0]
                if usec:
                    self.fps = 1e6 / usec
                if len(data) >= 40:
                    self.width = struct.unpack_from("<I", data, 32)[0]
                    self.height = struct.unpack_from("<I", data, 36)[0]
            elif fourcc == b"LIST":
                self.f.read(4)               # strl — recurse through it
                self._parse_hdrl(start + size)
            self.f.seek(start + size + (size & 1))

    def read_frame(self) -> Optional[np.ndarray]:
        """Next video chunk ('??dc'/'??db') decoded to RGB, or None."""
        import io as _io

        from PIL import Image
        while self._pos < self._movi_end:
            self.f.seek(self._pos)
            head = self.f.read(8)
            if len(head) < 8:
                return None
            fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
            self._pos = self.f.tell() + size + (size & 1)
            if fourcc[2:4] in (b"dc", b"db"):
                data = self.f.read(size)
                try:
                    img = Image.open(_io.BytesIO(data)).convert("RGB")
                except Exception as e:
                    raise ValueError(
                        "undecodable video chunk (only MJPEG AVIs are "
                        f"supported; re-encode with ffmpeg -c:v mjpeg): {e}")
                return np.asarray(img, np.uint8)
            if fourcc == b"LIST":            # rec. grouping: descend
                self._pos = self.f.tell() + 4
        return None

    def rewind(self) -> None:
        self._pos = self._movi_start

    def close(self) -> None:
        self.f.close()


# ---------------------------------------------------------------------------
# MJPEG-AVI writer (the reader's inverse: overlay clips out)
# ---------------------------------------------------------------------------

class MJPEGWriter:
    """Streaming MJPEG-AVI writer: frames append one at a time (nothing
    buffers), RIFF/LIST sizes and the frame count are patched on close.
    Output plays in any player/ffmpeg and round-trips through
    VideoFrameSource (pinned in tests)."""

    def __init__(self, path: str, fps: float = 25.0, quality: int = 90):
        self.f = open(path, "wb")
        self.fps = fps
        self.quality = quality
        self.n = 0
        self._wh: Optional[Tuple[int, int]] = None
        # placeholders; all sizes patched in close()
        self.f.write(b"RIFF" + b"\x00" * 4 + b"AVI ")
        self._hdrl_at = self.f.tell()
        avih = struct.pack("<10I", int(1e6 / fps), 0, 0, 0, 0, 0, 1, 0,
                           0, 0)
        self.f.write(b"LIST" + struct.pack("<I", 4 + 8 + len(avih))
                     + b"hdrl" + b"avih" + struct.pack("<I", len(avih))
                     + avih)
        self._movi_at = self.f.tell()
        self.f.write(b"LIST" + b"\x00" * 4 + b"movi")

    def add(self, rgb) -> None:
        import io as _io

        import numpy as np
        from PIL import Image

        rgb = np.asarray(rgb, np.uint8)
        if self._wh is None:
            self._wh = (rgb.shape[1], rgb.shape[0])
        buf = _io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=self.quality)
        data = buf.getvalue()
        self.f.write(b"00dc" + struct.pack("<I", len(data)) + data)
        if len(data) & 1:
            self.f.write(b"\x00")
        self.n += 1

    def close(self) -> None:
        end = self.f.tell()
        self.f.seek(4)
        self.f.write(struct.pack("<I", end - 8))            # RIFF size
        self.f.seek(self._movi_at + 4)
        self.f.write(struct.pack("<I", end - self._movi_at - 8))
        # avih: frame count at +16, width/height at +32/+36 (after the
        # 8-byte LIST header, 4-byte 'hdrl', 8-byte 'avih' chunk header)
        base = self._hdrl_at + 8 + 4 + 8
        self.f.seek(base + 16)
        self.f.write(struct.pack("<I", self.n))
        if self._wh:
            self.f.seek(base + 32)
            self.f.write(struct.pack("<II", *self._wh))
        self.f.close()


# ---------------------------------------------------------------------------
# FrameSource
# ---------------------------------------------------------------------------

class VideoFrameSource(FrameSource):
    """Serve a .y4m or MJPEG .avi clip as camera frames.

    loop=True restarts at EOF (endless soak runs); realtime=True paces
    frames to the container frame rate (otherwise as fast as consumed).
    """

    def __init__(self, path: str, loop: bool = False,
                 realtime: bool = False):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.loop = loop
        self.realtime = realtime
        self._reader = None

    def open(self) -> bool:
        ext = os.path.splitext(self.path)[1].lower()
        if ext == ".y4m":
            self._reader = _Y4MReader(self.path)
        elif ext == ".avi":
            self._reader = _AVIReader(self.path)
        else:
            raise ValueError(
                f"unsupported video container {ext!r} (supported: .y4m, "
                ".avi with MJPEG; convert with ffmpeg)")
        return True

    @property
    def is_ready(self) -> bool:
        return self._reader is not None

    @property
    def fps(self) -> float:
        return self._reader.fps if self._reader else 0.0

    def frames(self) -> Iterator[FrameData]:
        if self._reader is None:
            self.open()
        r = self._reader
        r.rewind()      # each frames() call restarts the clip (the
        n = 0           # FileFrameSource contract callers rely on)
        t0 = time.monotonic()
        while True:
            out = r.read_frame()
            if out is None:
                if not self.loop or n == 0:
                    return
                r.rewind()
                continue
            if isinstance(out, tuple):       # y4m planes
                y, u, v = out
                rgb = yuv_to_rgb(y, _upsample_chroma(u, y.shape),
                                 _upsample_chroma(v, y.shape))
                yuv = (y, u, v)
            else:
                rgb, yuv = out, None
            ts = n / r.fps if r.fps else float(n)
            if self.realtime:
                lag = (t0 + ts) - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
            yield FrameData(rgb=rgb, timestamp=ts, yuv=yuv)
            n += 1

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
