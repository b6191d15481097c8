"""Live camera ingestion: V4L2 (Video4Linux2) frame source.

The reference's live camera is Android Camera2 reached over JNI
(Assets/Scripts/PassthroughCamera/PassthroughCameraUtils.cs:211-216,
282-334) wrapped by WebCamTextureManager (WebCamTextureManager.cs:85-134:
permission wait, resolution pick, camera-not-found retry). On a Linux GPU
host the same role is played by V4L2. This module is stdlib-only
(fcntl ioctls + mmap + struct — no pybind/cffi needed for a char device):

  RawCamera         — minimal capture interface (open/formats/set_format/
                      start/grab/stop). Lets the source logic be tested
                      with a fake when no /dev/video* exists (exactly how
                      the reference is tested headset-free, SURVEY §4).
  V4L2RawCamera     — the real thing: QUERYCAP / ENUM_FMT / ENUM_FRAMESIZES
                      / S_FMT / REQBUFS(MMAP) / QBUF / STREAMON / DQBUF.
  V4L2CameraSource  — FrameSource over a RawCamera: format negotiation
                      (YUYV preferred, MJPEG fallback), host-side pixel
                      conversion, bounded open-retry (the reference's
                      camera-not-found loop, WebCamTextureManager.cs:101-133).
  yuyv_to_rgb       — vectorized numpy YUYV->RGB (BT.601 full-range), the
                      host-side sibling of the device YUV420 kernel
                      (ops/yuv.py).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from xrseg_tpu_torch.runtime.frame_source import FrameData, FrameSource
from xrseg_tpu_torch.runtime.logging import warning as _warn

# ---------------------------------------------------------------------------
# V4L2 ABI constants (from linux/videodev2.h; stable kernel ABI)
# ---------------------------------------------------------------------------

def _fourcc(a: str) -> int:
    return (ord(a[0]) | (ord(a[1]) << 8) | (ord(a[2]) << 16)
            | (ord(a[3]) << 24))


V4L2_PIX_FMT_YUYV = _fourcc("YUYV")
V4L2_PIX_FMT_MJPG = _fourcc("MJPG")
V4L2_PIX_FMT_RGB24 = _fourcc("RGB3")

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_NONE = 1
V4L2_FRMSIZE_TYPE_DISCRETE = 1
V4L2_CAP_VIDEO_CAPTURE = 0x00000001
V4L2_CAP_STREAMING = 0x04000000

# _IOWR('V', nr, size) encodings for x86-64/arm64 (dir<<30|size<<16|'V'<<8|nr)
def _iowr(nr: int, size: int) -> int:
    return (3 << 30) | (size << 16) | (ord("V") << 8) | nr


def _iow(nr: int, size: int) -> int:
    return (1 << 30) | (size << 16) | (ord("V") << 8) | nr


_SZ_CAPABILITY = 104
_SZ_FMTDESC = 64
_SZ_FRMSIZEENUM = 44
_SZ_FORMAT = 208
_SZ_REQUESTBUFFERS = 20
_SZ_BUFFER = 88
_SZ_INT = 4

VIDIOC_QUERYCAP = _iowr(0, _SZ_CAPABILITY)
VIDIOC_ENUM_FMT = _iowr(2, _SZ_FMTDESC)
VIDIOC_S_FMT = _iowr(5, _SZ_FORMAT)
VIDIOC_REQBUFS = _iowr(8, _SZ_REQUESTBUFFERS)
VIDIOC_QUERYBUF = _iowr(9, _SZ_BUFFER)
VIDIOC_QBUF = _iowr(15, _SZ_BUFFER)
VIDIOC_DQBUF = _iowr(17, _SZ_BUFFER)
VIDIOC_STREAMON = _iow(18, _SZ_INT)
VIDIOC_STREAMOFF = _iow(19, _SZ_INT)
VIDIOC_ENUM_FRAMESIZES = _iowr(74, _SZ_FRMSIZEENUM)


# ---------------------------------------------------------------------------
# RawCamera interface + real V4L2 implementation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CameraFormat:
    fourcc: int
    sizes: Tuple[Tuple[int, int], ...]     # (w, h) discrete sizes


class RawCamera:
    """Minimal capture interface (see module docstring)."""

    def open(self) -> bool:
        raise NotImplementedError

    def formats(self) -> List[CameraFormat]:
        raise NotImplementedError

    def set_format(self, w: int, h: int, fourcc: int) -> Tuple[int, int]:
        """Returns the (w, h) the device actually granted."""
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def grab(self) -> bytes:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class V4L2RawCamera(RawCamera):
    """ioctl/mmap V4L2 capture (memory-mapped streaming I/O)."""

    def __init__(self, device: str = "/dev/video0", n_buffers: int = 4):
        self.device = device
        self.n_buffers = n_buffers
        self.fd: Optional[int] = None
        self._maps: list = []

    def _ioctl(self, req: int, buf) -> bytes:
        import fcntl
        return fcntl.ioctl(self.fd, req, buf)

    def open(self) -> bool:
        if not os.path.exists(self.device):
            return False
        try:
            self.fd = os.open(self.device, os.O_RDWR | os.O_NONBLOCK)
        except OSError:
            return False
        try:
            caps = bytearray(_SZ_CAPABILITY)
            self._ioctl(VIDIOC_QUERYCAP, caps)
            capabilities = struct.unpack_from("<I", caps, 84)[0]
            if not (capabilities & V4L2_CAP_VIDEO_CAPTURE
                    and capabilities & V4L2_CAP_STREAMING):
                self.stop()
                return False
        except OSError:
            self.stop()
            return False
        return True

    def formats(self) -> List[CameraFormat]:
        out = []
        i = 0
        while True:
            d = bytearray(_SZ_FMTDESC)
            struct.pack_into("<II", d, 0, i, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            try:
                self._ioctl(VIDIOC_ENUM_FMT, d)
            except OSError:
                break
            fourcc = struct.unpack_from("<I", d, 44)[0]
            sizes = []
            j = 0
            while True:
                f = bytearray(_SZ_FRMSIZEENUM)
                struct.pack_into("<II", f, 0, j, fourcc)
                try:
                    self._ioctl(VIDIOC_ENUM_FRAMESIZES, f)
                except OSError:
                    break
                ftype = struct.unpack_from("<I", f, 8)[0]
                if ftype == V4L2_FRMSIZE_TYPE_DISCRETE:
                    w, h = struct.unpack_from("<II", f, 12)
                    sizes.append((w, h))
                else:                      # stepwise: report min and max
                    mnw, mxw, _, mnh, mxh, _ = struct.unpack_from("<6I", f, 12)
                    sizes += [(mnw, mnh), (mxw, mxh)]
                    break
                j += 1
            out.append(CameraFormat(fourcc, tuple(sizes)))
            i += 1
        return out

    def set_format(self, w: int, h: int, fourcc: int) -> Tuple[int, int]:
        f = bytearray(_SZ_FORMAT)
        struct.pack_into("<I", f, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        # v4l2_pix_format at offset 8: width,height,pixelformat,field
        struct.pack_into("<IIII", f, 8, w, h, fourcc, V4L2_FIELD_NONE)
        self._ioctl(VIDIOC_S_FMT, f)
        gw, gh = struct.unpack_from("<II", f, 8)
        return gw, gh

    # struct v4l2_buffer offsets on LP64 (index 0, type 4, bytesused 8,
    # flags 12, field 16, [pad] timestamp 24..40, timecode 40..56,
    # sequence 56, memory 60, union m 64, length 72) — total 88 bytes.
    _OFF_INDEX, _OFF_TYPE, _OFF_BYTESUSED = 0, 4, 8
    _OFF_MEMORY, _OFF_M, _OFF_LENGTH = 60, 64, 72

    def _make_buf(self, index: int = 0) -> bytearray:
        b = bytearray(_SZ_BUFFER)
        struct.pack_into("<I", b, self._OFF_INDEX, index)
        struct.pack_into("<I", b, self._OFF_TYPE,
                         V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<I", b, self._OFF_MEMORY, V4L2_MEMORY_MMAP)
        return b

    def start(self) -> None:
        import mmap as mmap_mod
        req = bytearray(_SZ_REQUESTBUFFERS)
        struct.pack_into("<III", req, 0, self.n_buffers,
                         V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP)
        self._ioctl(VIDIOC_REQBUFS, req)
        count = struct.unpack_from("<I", req, 0)[0]
        self._maps = []
        for i in range(count):
            b = self._make_buf(i)
            self._ioctl(VIDIOC_QUERYBUF, b)
            length = struct.unpack_from("<I", b, self._OFF_LENGTH)[0]
            offset = struct.unpack_from("<I", b, self._OFF_M)[0]
            self._maps.append(mmap_mod.mmap(
                self.fd, length, mmap_mod.MAP_SHARED,
                mmap_mod.PROT_READ, offset=offset))
            self._ioctl(VIDIOC_QBUF, b)
        on = struct.pack("<i", V4L2_BUF_TYPE_VIDEO_CAPTURE)
        self._ioctl(VIDIOC_STREAMON, on)

    def grab(self, timeout_s: float = 2.0) -> bytes:
        import select
        r, _, _ = select.select([self.fd], [], [], timeout_s)
        if not r:
            raise TimeoutError(f"no frame from {self.device} "
                               f"in {timeout_s:.1f}s")
        b = self._make_buf()
        self._ioctl(VIDIOC_DQBUF, b)
        idx = struct.unpack_from("<I", b, self._OFF_INDEX)[0]
        used = struct.unpack_from("<I", b, self._OFF_BYTESUSED)[0]
        data = bytes(self._maps[idx][:used])
        self._ioctl(VIDIOC_QBUF, b)
        return data

    def stop(self) -> None:
        if self.fd is not None:
            try:
                off = struct.pack("<i", V4L2_BUF_TYPE_VIDEO_CAPTURE)
                self._ioctl(VIDIOC_STREAMOFF, off)
            except OSError:
                pass
            for m in self._maps:
                m.close()
            self._maps = []
            os.close(self.fd)
            self.fd = None


# ---------------------------------------------------------------------------
# Pixel conversion
# ---------------------------------------------------------------------------

def yuyv_to_rgb(buf: bytes, w: int, h: int) -> np.ndarray:
    """Packed YUYV (YUV 4:2:2) -> [h,w,3] uint8 RGB, BT.601 full range.

    Same colorimetry as the device YUV420 kernel (ops/yuv.py), host-side
    numpy: each 4-byte group is Y0 U Y1 V for two horizontal pixels.
    """
    a = np.frombuffer(buf, np.uint8, count=w * h * 2).reshape(h, w // 2, 4)
    y = a[..., (0, 2)].reshape(h, w).astype(np.float32)
    u = np.repeat(a[..., 1], 2, axis=1).astype(np.float32) - 128.0
    v = np.repeat(a[..., 3], 2, axis=1).astype(np.float32) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# FrameSource
# ---------------------------------------------------------------------------

class V4L2CameraSource(FrameSource):
    """Live camera FrameSource over a RawCamera.

    Mirrors WebCamTextureManager's behavior on the GPU host:
      - bounded camera-not-found retry in open()
        (WebCamTextureManager.cs:101-133 retries every frame; here
        `open_retries` x `retry_interval_s`),
      - resolution pick: requested size if granted, else the largest the
        device offers ("highest if unset", WebCamTextureManager.cs:110-118),
      - format negotiation: YUYV preferred (cheap vectorized convert),
        MJPEG fallback (PIL decode), RGB24 passthrough.
    """

    _PREFERRED = (V4L2_PIX_FMT_YUYV, V4L2_PIX_FMT_RGB24, V4L2_PIX_FMT_MJPG)

    def __init__(self, device: str = "/dev/video0",
                 camera: Optional[RawCamera] = None,
                 fps_limit: Optional[float] = None,
                 open_retries: int = 5, retry_interval_s: float = 0.2,
                 max_frames: Optional[int] = None):
        self.camera = camera if camera is not None else V4L2RawCamera(device)
        self.device = device
        self.fps_limit = fps_limit
        self.open_retries = open_retries
        self.retry_interval_s = retry_interval_s
        self.max_frames = max_frames
        self._requested: Optional[Tuple[int, int]] = None
        self._wh: Optional[Tuple[int, int]] = None
        self._fourcc: Optional[int] = None
        self._opened = False

    # -- FrameSource protocol ------------------------------------------

    def supported_output_sizes(self) -> list:
        if not self._opened:
            return []
        sizes = []
        for f in self.camera.formats():
            sizes += list(f.sizes)
        return sorted(set(sizes))

    def request_resolution(self, wh: Tuple[int, int]) -> bool:
        self._requested = (int(wh[0]), int(wh[1]))
        return True

    @property
    def is_ready(self) -> bool:
        return self._opened

    def open(self) -> bool:
        for attempt in range(self.open_retries):
            if self.camera.open():
                break
            _warn(f"camera {self.device} not found "
                  f"(attempt {attempt + 1}/{self.open_retries})")
            time.sleep(self.retry_interval_s)
        else:
            return False
        fmts = {f.fourcc: f for f in self.camera.formats()}
        fourcc = next((fc for fc in self._PREFERRED if fc in fmts), None)
        if fourcc is None:
            self.camera.stop()
            return False
        if self._requested is not None:
            w, h = self._requested
        else:
            sizes = fmts[fourcc].sizes
            w, h = max(sizes, key=lambda s: s[0] * s[1]) if sizes \
                else (640, 480)
        try:
            self._wh = tuple(self.camera.set_format(w, h, fourcc))
            self._fourcc = fourcc
            self.camera.start()
        except OSError as e:              # device refused format/streaming
            _warn(f"camera {self.device} setup failed: {e}")
            self.camera.stop()
            return False
        self._opened = True
        return True

    @property
    def frame_hw(self) -> Optional[Tuple[int, int]]:
        """Granted frame geometry (H, W) after open() — the device may
        grant a different size than requested; size consumers from this."""
        return (self._wh[1], self._wh[0]) if self._wh else None

    def _to_rgb(self, raw: bytes) -> np.ndarray:
        w, h = self._wh
        if self._fourcc == V4L2_PIX_FMT_YUYV:
            return yuyv_to_rgb(raw, w, h)
        if self._fourcc == V4L2_PIX_FMT_RGB24:
            return np.frombuffer(raw, np.uint8,
                                 count=w * h * 3).reshape(h, w, 3).copy()
        # MJPEG
        import io as _io

        from PIL import Image
        return np.asarray(Image.open(_io.BytesIO(raw)).convert("RGB"),
                          np.uint8)

    def frames(self) -> Iterator[FrameData]:
        assert self._opened, "open() first"
        served = 0
        last = 0.0
        while self.max_frames is None or served < self.max_frames:
            if self.fps_limit:
                wait = last + 1.0 / self.fps_limit - time.time()
                if wait > 0:
                    time.sleep(wait)
            raw = self.camera.grab()
            last = time.time()
            yield FrameData(rgb=self._to_rgb(raw), timestamp=last)
            served += 1

    def close(self) -> None:
        if self._opened:
            self.camera.stop()
            self._opened = False
