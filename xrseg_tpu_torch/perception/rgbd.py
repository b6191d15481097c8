"""RGBD point-cloud extraction orchestration (counterpart of
xrseg_tpu/perception/rgbd.py).

Ties together: latency-compensated depth pose (perception.camera), the
fusion ops (ops.depth_fusion), the max-points cap + depth-gradient
coloring + double-buffered fallback of the reference's CollectJobResults
(IEExecutor.cs:653-682).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from xrseg_tpu_torch.config import DepthConfig
from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.ops import depth_fusion as df
from xrseg_tpu_torch.perception.camera import CameraIntrinsics, Pose
from xrseg_tpu_torch.viz.pointcloud import DepthGradient


@dataclasses.dataclass
class PointCloud:
    positions: np.ndarray   # [N,3] world
    colors: np.ndarray      # [N,3] uint8
    depths: np.ndarray      # [N] meters


class PointCloudExtractor:
    """Per-target point extraction with the reference's buffering semantics:
    a successful extraction replaces the buffer and refreshes the backup; an
    empty one falls back to the backup (IEExecutor.cs:671-681)."""

    def __init__(self, cfg: DepthConfig = DepthConfig(),
                 backend: str = "torch", num_threads: int = 0,
                 device="cuda"):
        if backend == "native":
            raise NotImplementedError(
                "the native (C++) depth-fusion backend is not ported yet "
                "(ROADMAP queue 1 item 13)")
        if backend != "torch":
            raise ValueError(f"unknown depth-fusion backend {backend!r}")
        self.cfg = cfg
        self.backend = backend
        self.num_threads = num_threads
        self.device = resolve_device(device)
        self.gradient = DepthGradient()
        self._current: Optional[PointCloud] = None
        self._backup: Optional[PointCloud] = None

    @property
    def current(self) -> Optional[PointCloud]:
        return self._current

    def clear(self) -> None:
        """ClearPointCloud (IEExecutor.cs:714-718)."""
        self._current = None
        self._backup = None

    def _camera(self, box_xywh_640, intrinsics: CameraIntrinsics,
                depth_pose: Pose):
        """box, focal, principal, sensor, position, rotation as f32 tensors
        on the device, from ONE upload."""
        flat = np.concatenate([
            np.asarray(a, np.float32).ravel() for a in (
                box_xywh_640, intrinsics.focal_length,
                intrinsics.principal_point, intrinsics.resolution,
                depth_pose.position, depth_pose.rotation)])
        return torch.tensor(flat, device=self.device).split(
            [4, 2, 2, 2, 3, 4])

    def _kw(self) -> dict:
        c = self.cfg
        return dict(confidence_threshold=c.confidence_threshold,
                    min_depth=c.min_depth_m, max_depth=c.max_depth_m,
                    sampling_step=c.sampling_step)

    def extract(self, depth_fp16: np.ndarray, mask_160: np.ndarray,
                box_xywh_640, intrinsics: CameraIntrinsics,
                depth_pose: Pose) -> PointCloud:
        """ExtractDepthData + CollectJobResults equivalent, from a host
        mask."""
        mask = torch.tensor(np.ascontiguousarray(mask_160, np.float32),
                            device=self.device)
        out = df.extract_points(
            df.depth_bits(depth_fp16, self.device), mask,
            *self._camera(box_xywh_640, intrinsics, depth_pose),
            mask_hw=tuple(mask_160.shape), **self._kw())
        return self.collect_packed(out["packed"].cpu().numpy())

    def extract_from_slate(self, depth_fp16: np.ndarray, masks_device,
                           target_index: int, box_xywh_640,
                           intrinsics: CameraIntrinsics,
                           depth_pose: Pose) -> PointCloud:
        """Device-fused path: the tracked target's mask stays on the device;
        the gather and the fusion run there and only the (tiny) point set
        comes back (vs the reference's full-mask CPU copy,
        IEExecutor.cs:615-621)."""
        out = df.extract_points_for_target(
            masks_device, target_index,
            df.depth_bits(depth_fp16, self.device),
            *self._camera(box_xywh_640, intrinsics, depth_pose), **self._kw())
        return self.collect_packed(out["packed"].cpu().numpy())  # ONE copy

    def collect_packed(self, packed: np.ndarray) -> PointCloud:
        """`packed` [N,5] = xyz | depth | valid, from the fused tick's single
        readback (compile.build_xr_tick_pipeline) or from one of the
        extract calls above. Only the cap/color/backup-buffer semantics
        remain host-side."""
        return self._collect(packed[:, :3], packed[:, 3],
                             packed[:, 4] > 0.5)

    def _collect(self, pos, dep, valid) -> PointCloud:
        """CollectJobResults semantics (IEExecutor.cs:653-682)."""
        c = self.cfg
        idx = np.nonzero(valid)[0][:c.max_points]   # cap (IEExecutor.cs:658)
        cloud = PointCloud(
            positions=pos[idx],
            colors=self.gradient.color_by_depth(dep[idx]),
            depths=dep[idx],
        )
        if len(idx) > 0:
            self._current = cloud
            self._backup = cloud
        elif self._backup is not None:
            self._current = self._backup
            cloud = self._backup
        return cloud
