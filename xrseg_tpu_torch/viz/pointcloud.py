"""Point-cloud output: gradient coloring, local-space transform, PLY export.

The reference renders its RGBD points as a dynamic MeshTopology.Points mesh
(IEPointcloud_Render.cs) colored by a depth gradient (IEExecutor.cs:663-664,
default red->blue over 0.2-2.2 m, :246-252). Rendering is out of TPU scope;
the framework's output surface is the colored point array + a standard PLY
writer, plus the same drift-free world->local conversion the renderer does
(IEPointcloud_Render.cs:72-78).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.perception.camera import Pose, quat_rotate, quat_conjugate


class DepthGradient:
    """Linear color gradient over normalized depth (Unity Gradient default
    keys red@0 -> blue@1, IEExecutor.cs:246-252; evaluation at :663-664:
    t = clamp01((depth - 0.2) / 2.0))."""

    def __init__(self, stops: Optional[Sequence[Tuple[float, Tuple[int, int, int]]]] = None):
        self.stops = sorted(stops or [(0.0, (255, 0, 0)), (1.0, (0, 0, 255))])

    def evaluate(self, t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, np.float32), 0.0, 1.0)
        keys = np.array([s[0] for s in self.stops], np.float32)
        cols = np.array([s[1] for s in self.stops], np.float32)
        idx = np.clip(np.searchsorted(keys, t, side="right") - 1, 0,
                      len(keys) - 2)
        k0, k1 = keys[idx], keys[idx + 1]
        w = np.where(k1 > k0, (t - k0) / np.maximum(k1 - k0, 1e-9), 0.0)
        c = cols[idx] * (1 - w)[..., None] + cols[idx + 1] * w[..., None]
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    def color_by_depth(self, depths_m: np.ndarray) -> np.ndarray:
        """IEExecutor.CollectJobResults color mapping (IEExecutor.cs:663-664)."""
        return self.evaluate((np.asarray(depths_m) - 0.2) / 2.0)


def world_to_local(points_world: np.ndarray, renderer_pose: Pose) -> np.ndarray:
    """Drift-free conversion: fixed world points -> renderer-local coords
    (InverseTransformPoint, IEPointcloud_Render.cs:72-78)."""
    rel = np.asarray(points_world, np.float32) - renderer_pose.position
    return quat_rotate(quat_conjugate(renderer_pose.rotation), rel)


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
              ) -> None:
    """ASCII PLY writer for [N,3] float points + optional [N,3] uint8 colors."""
    points = np.asarray(points, np.float32)
    n = len(points)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            for p, c in zip(points, np.asarray(colors, np.uint8)):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
