"""Frame sources: the L1 camera layer, headset-free.

The reference's camera layer is WebCamTextureManager + Android Camera2
(Assets/Scripts/PassthroughCamera/WebCamTextureManager.cs) feeding RGB
textures, plus the Meta EnvironmentDepthManager feeding fp16 depth frames
(IEExecutor.cs:317-361). Here the same contract is a FrameSource protocol:

  FrameData: rgb [H,W,3] uint8, optional yuv planes, optional depth_fp16
  [Dh,Dw] uint16, camera pose, intrinsics, timestamp.

Implementations:
  - FileFrameSource: images from disk re-served at an interval — the
    TestScene harness (TestScene.unity:595-603: one named image every 5 s).
  - SyntheticCameraSource: procedurally animated scene with a synthetic
    depth map and an orbiting head pose — the XRScene stand-in that lets
    tracking + RGBD fusion run end-to-end without hardware.

A `permissions` gate mirrors PassthroughCameraPermissions: sources expose
`is_ready` and a retry-friendly `open()` (WebCamTextureManager.cs:101-133's
camera-not-found retry loop).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from xrseg_tpu_torch.perception.camera import (CameraIntrinsics, Pose,
                                         quat_from_axis_angle)


@dataclasses.dataclass
class FrameData:
    rgb: np.ndarray                        # [H,W,3] uint8
    timestamp: float = 0.0
    pose: Optional[Pose] = None            # camera pose in world
    intrinsics: Optional[CameraIntrinsics] = None
    depth_fp16: Optional[np.ndarray] = None   # [Dh,Dw] uint16 raw fp16 bits
    yuv: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


class FrameSource:
    """Protocol: open() -> bool, frames() iterator, close()."""

    def open(self) -> bool:
        return True

    @property
    def is_ready(self) -> bool:
        return True

    def supported_output_sizes(self) -> list:
        """(w, h) resolutions this source can deliver (the reference's
        GetOutputSizes, PassthroughCameraUtils.cs:81-84); the default single
        entry mirrors 'highest if unset' (WebCamTextureManager.cs:110-118)."""
        return []

    def request_resolution(self, wh: Tuple[int, int]) -> bool:
        """Ask for a specific output size before open(); False if unsupported."""
        return False

    def frames(self) -> Iterator[FrameData]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileFrameSource(FrameSource):
    """Serve image files from a directory (TestScene harness equivalent).

    `image_name` selects one image to loop (ref `_imageName: bus-irregular`);
    None cycles through all images. `interval_s` mirrors the test scene's
    inference cadence (ref `_inferenceInterval: 5`), 0 = as fast as possible.
    """

    def __init__(self, directory: str, image_name: Optional[str] = None,
                 interval_s: float = 0.0, loop: bool = True,
                 max_frames: Optional[int] = None):
        self.directory = directory
        self.image_name = image_name
        self.interval_s = interval_s
        self.loop = loop
        self.max_frames = max_frames
        self._paths: list[str] = []

    def open(self) -> bool:
        pats = ("*.jpg", "*.jpeg", "*.png", "*.bmp")
        paths = []
        for p in pats:
            paths += glob.glob(os.path.join(self.directory, p))
        if self.image_name:
            paths = [p for p in paths
                     if os.path.splitext(os.path.basename(p))[0] == self.image_name]
        self._paths = sorted(paths)
        return bool(self._paths)

    @property
    def is_ready(self) -> bool:
        return bool(self._paths)

    def frames(self) -> Iterator[FrameData]:
        from PIL import Image
        served = 0
        while True:
            for path in self._paths:
                if self.max_frames is not None and served >= self.max_frames:
                    return
                img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
                yield FrameData(rgb=img, timestamp=time.time())
                served += 1
                if self.interval_s > 0:
                    time.sleep(self.interval_s)
            if not self.loop:
                return


class SyntheticCameraSource(FrameSource):
    """Procedural passthrough-camera stand-in with depth + pose.

    Renders moving solid rectangles over a gradient background, emits a
    synthetic fp16 depth frame (objects nearer than background) and an
    orbiting camera pose — enough signal to exercise preprocessing,
    detection plumbing, tracking geometry, and RGBD fusion end to end.
    """

    def __init__(self, frame_hw: Tuple[int, int] = (960, 1280),
                 depth_hw: Tuple[int, int] = (256, 256),
                 n_objects: int = 3, fps: float = 30.0, seed: int = 0,
                 max_frames: Optional[int] = None, realtime: bool = False,
                 background_rgb: Optional[np.ndarray] = None,
                 background_depth_m: float = 1.5):
        """background_rgb: optional [H,W,3] image used as the static scene
        (with synthetic depth `background_depth_m`) instead of procedural
        rectangles — lets a real detector exercise the full XR loop
        (detect -> select -> track -> RGBD) deterministically."""
        self.frame_hw = frame_hw
        self.depth_hw = depth_hw
        self.n_objects = n_objects
        self.fps = fps
        self.seed = seed
        self.max_frames = max_frames
        self.realtime = realtime   # sleep to deliver frames at `fps`
        self.background_rgb = background_rgb
        self.background_depth_m = background_depth_m
        self.intrinsics = CameraIntrinsics.quest3_like()

    # Quest-3-like passthrough camera mode list (ref: YUV_420_888 sizes,
    # PassthroughCameraUtils.cs:287-311; highest picked when unset,
    # WebCamTextureManager.cs:110-118)
    _MODES = [(320, 240), (640, 480), (800, 600), (1280, 960)]

    def supported_output_sizes(self) -> list:
        return list(self._MODES)

    def request_resolution(self, wh) -> bool:
        if tuple(wh) not in self._MODES:
            return False
        self.frame_hw = (wh[1], wh[0])
        return True

    def frames(self) -> Iterator[FrameData]:
        rng = np.random.default_rng(self.seed)
        H, W = self.frame_hw
        dh, dw = self.depth_hw
        centers = rng.uniform(0.25, 0.75, (self.n_objects, 2))
        vels = rng.uniform(-0.05, 0.05, (self.n_objects, 2))
        sizes = rng.uniform(0.08, 0.2, (self.n_objects, 2))
        colors = rng.integers(64, 255, (self.n_objects, 3))
        depths = rng.uniform(0.5, 2.5, self.n_objects)

        t = 0
        if self.background_rgb is not None:
            from PIL import Image
            bg = np.asarray(Image.fromarray(
                np.asarray(self.background_rgb, np.uint8)).resize((W, H)),
                np.uint8)
        else:
            yy = np.linspace(0, 80, H, dtype=np.float32)[:, None]
            xx = np.linspace(0, 80, W, dtype=np.float32)[None, :]
            bg = np.stack([yy + xx, 40 + 0 * yy + xx, 80 + yy - xx], -1)
            bg = np.clip(bg, 0, 255).astype(np.uint8)

        while self.max_frames is None or t < self.max_frames:
            frame = bg.copy()
            if self.background_rgb is not None:
                depth = np.full((dh, dw), self.background_depth_m, np.float32)
            else:
                depth = np.full((dh, dw), 3.5, np.float32)   # beyond range
                centers_t = (centers + vels * t) % 1.0
                for i in range(self.n_objects):
                    cy, cx = centers_t[i]
                    hh, hw_ = sizes[i]
                    y1, y2 = int((cy - hh / 2) * H), int((cy + hh / 2) * H)
                    x1, x2 = int((cx - hw_ / 2) * W), int((cx + hw_ / 2) * W)
                    frame[max(0, y1):max(0, y2), max(0, x1):max(0, x2)] = colors[i]
                    dy1, dy2 = int((cy - hh / 2) * dh), int((cy + hh / 2) * dh)
                    dx1, dx2 = int((cx - hw_ / 2) * dw), int((cx + hw_ / 2) * dw)
                    depth[max(0, dy1):max(0, dy2), max(0, dx1):max(0, dx2)] = depths[i]

            # orbiting head pose
            ang = 0.02 * t
            pose = Pose(np.array([0.1 * np.sin(ang), 1.6, 0.1 * np.cos(ang)],
                                 np.float32),
                        quat_from_axis_angle([0, 1, 0], 0.05 * np.sin(ang)))
            depth_fp16 = np.asarray(depth, np.float16).view(np.uint16)
            yield FrameData(rgb=frame, timestamp=t / self.fps, pose=pose,
                            intrinsics=self.intrinsics, depth_fp16=depth_fp16)
            if self.realtime:
                time.sleep(1.0 / self.fps)
            t += 1
