"""ctypes binding of the C++ host runtime in native/ (counterpart of
xrseg_tpu/io/native.py): the RGBD depth fusion, the 2-tap resize, the HSV
jitter and the SPSC frame ring.

The port builds its own copy of the library: g++ compiles
native/src/*.cpp with native/Makefile's flags

  g++ -O3 -fPIC -std=c++17 -Wall -Wextra <sources> -shared -pthread
      -o build/kernels/libxrseg_native-<hash>.so

at first use, into build/kernels/ beside the CUDA kernels (listed in
.gitignore), under a hash of the sources and the flags, so an edited source
is never served by a stale library. It never writes native/build/, which
belongs to the JAX package's binding. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from xrseg_tpu_torch._build import BUILD_DIR

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _sources():
    srcs = sorted(NATIVE_SRC.glob("*.cpp"))
    if not srcs:
        raise RuntimeError(f"no C++ sources under {NATIVE_SRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libxrseg_native-{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Build the library if this hash has none yet; return its path."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, _sources()),
                           *LD_FLAGS, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/src (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed, its signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    fp, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    ci, cf = ctypes.c_int, ctypes.c_float

    lib.xrseg_depth_fusion.restype = ci
    lib.xrseg_depth_fusion.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ci, ci, fp, ci, ci, ci, cf, cf, cf,
        cf, cf, cf, cf, fp, fp, fp, fp, fp, fp, fp,
        ctypes.POINTER(ctypes.c_int32), ci]

    lib.xrseg_ring_create.restype = ctypes.c_void_p
    lib.xrseg_ring_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
    lib.xrseg_ring_destroy.restype = None
    lib.xrseg_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("xrseg_ring_push", "xrseg_ring_pop", "xrseg_ring_pop_latest"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.xrseg_ring_size.restype = ctypes.c_int64
    lib.xrseg_ring_size.argtypes = [ctypes.c_void_p]
    lib.xrseg_ring_dropped.restype = ctypes.c_int64
    lib.xrseg_ring_dropped.argtypes = [ctypes.c_void_p]

    lib.xrseg_hsv_jitter.restype = ci
    lib.xrseg_hsv_jitter.argtypes = [u8p, u8p, ctypes.c_int64, cf, cf, cf,
                                     ci]
    lib.xrseg_resize2tap_u8.restype = ci
    lib.xrseg_resize2tap_u8.argtypes = [u8p, ci, ci, u8p, ci, ci, ci]
    _lib = lib
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rgb_u8(img) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape}")
    return img


def resize2tap_native(img: np.ndarray, hw, n_threads: int = 0) -> np.ndarray:
    """C++ 2-tap bilinear resize of uint8 [H,W,3]: half-pixel-centre
    sampling, as the device preprocess (ops/preprocess) and
    cv2.INTER_LINEAR."""
    lib = load_library()
    img = _rgb_u8(img)
    dh, dw = int(hw[0]), int(hw[1])
    out = np.empty((dh, dw, 3), np.uint8)
    rc = lib.xrseg_resize2tap_u8(_u8p(img), img.shape[0], img.shape[1],
                                 _u8p(out), dh, dw, int(n_threads))
    if rc != 0:
        raise RuntimeError(f"xrseg_resize2tap_u8 failed: rc={rc}")
    return out


def hsv_jitter_native(img: np.ndarray, gh: float, gs: float, gv: float,
                      n_threads: int = 0) -> np.ndarray:
    """Single-pass C++ HSV gain transform of uint8 RGB [H,W,3]
    (native/src/augment.cpp)."""
    lib = load_library()
    img = _rgb_u8(img)
    out = np.empty_like(img)
    rc = lib.xrseg_hsv_jitter(_u8p(img), _u8p(out),
                              img.shape[0] * img.shape[1], float(gh),
                              float(gs), float(gv), int(n_threads))
    if rc != 0:
        raise RuntimeError(f"xrseg_hsv_jitter failed: rc={rc}")
    return out


def depth_fusion_native(depth_fp16: np.ndarray, mask: np.ndarray,
                        box_xywh_640, cam_pos, cam_quat, focal, principal,
                        sensor_res, confidence_threshold=0.5, min_depth=0.1,
                        max_depth=3.0, sampling_step=4, num_threads=0):
    """The C++ DepthExtractionJob (native/src/depth_fusion.cpp) on host
    arrays. Returns (positions [N,3], depths [N], valid [N] bool)."""
    lib = load_library()
    depth_fp16 = np.ascontiguousarray(depth_fp16, np.uint16)
    mask = np.ascontiguousarray(mask, np.float32)
    mh, mw = mask.shape
    dh, dw = depth_fp16.shape
    n = (mh // sampling_step) * (mw // sampling_step)
    positions = np.zeros((n, 3), np.float32)
    depths = np.zeros(n, np.float32)
    valid = np.zeros(n, np.int32)
    cam = [np.ascontiguousarray(a, np.float32) for a in
           (cam_pos, cam_quat, focal, principal, sensor_res)]
    bx, by, bw, bh = (float(v) for v in box_xywh_640)
    lib.xrseg_depth_fusion(          # returns the count of valid points
        depth_fp16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), dw, dh,
        _fptr(mask), mw, mh, sampling_step, confidence_threshold, min_depth,
        max_depth, bx, by, bw, bh, *map(_fptr, cam), _fptr(positions),
        _fptr(depths), valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads)
    return positions, depths, valid.astype(bool)


class FrameRing:
    """SPSC frame ring (native/src/frame_ring.cpp) for streaming ingestion:
    push drops the oldest frame when full (counted in `dropped`)."""

    def __init__(self, capacity: int, slot_bytes: int):
        self._ptr = None
        self._lib = load_library()
        self._ptr = self._lib.xrseg_ring_create(capacity, slot_bytes)
        if not self._ptr:
            raise RuntimeError("frame ring allocation failed")

    def push(self, frame: np.ndarray) -> None:
        buf = np.ascontiguousarray(frame).view(np.uint8).reshape(-1)
        if self._lib.xrseg_ring_push(self._ptr, _u8p(buf), buf.nbytes) != 0:
            raise ValueError("frame larger than ring slot")

    def _pop(self, fn, shape, dtype):
        out = np.empty(int(np.prod(shape)) * np.dtype(dtype).itemsize,
                       np.uint8)
        rc = fn(self._ptr, _u8p(out), out.nbytes)
        if rc == 1:
            return out.view(dtype).reshape(shape)
        if rc == 0:
            return None
        raise ValueError("pop size exceeds slot size")

    def pop(self, shape, dtype=np.uint8):
        """The oldest frame, or None when empty."""
        return self._pop(self._lib.xrseg_ring_pop, shape, dtype)

    def pop_latest(self, shape, dtype=np.uint8):
        """The newest frame (the older ones are dropped), or None."""
        return self._pop(self._lib.xrseg_ring_pop_latest, shape, dtype)

    def __len__(self) -> int:
        return int(self._lib.xrseg_ring_size(self._ptr))

    @property
    def dropped(self) -> int:
        return int(self._lib.xrseg_ring_dropped(self._ptr))

    def close(self) -> None:
        if self._ptr:
            self._lib.xrseg_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
