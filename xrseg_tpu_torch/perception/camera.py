"""Camera model: intrinsics, poses, quaternion math, latency compensation.

Honest stand-in for the reference's PassthroughCameraUtils JNI bridge
(Assets/Scripts/PassthroughCamera/PassthroughCameraUtils.cs):
  - PassthroughCameraIntrinsics {focal, principal, resolution, skew}
    (PassthroughCameraUtils.cs:353-371)
  - world camera pose = head_pose ∘ head_from_camera extrinsic with a 180°
    X-axis flip (PassthroughCameraUtils.cs:130-160)
  - screen point -> ray via the pinhole model
    (PassthroughCameraUtils.cs:171-199)
  - depth-latency pose compensation: lerp/slerp toward the previous pose by
    latency/dt (IEExecutor.cs:332-349, DEPTH_LATENCY_SECONDS=0.033)

Quaternions are [x, y, z, w] (Unity order). All functions are numpy,
host-side: poses are tiny and arrive from the platform layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# quaternion math ([x,y,z,w])
# ---------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_normalize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return q / np.linalg.norm(q)


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float32)


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = np.asarray(a, np.float32)
    bx, by, bz, bw = np.asarray(b, np.float32)
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], np.float32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) [.,3] by quaternion q (math.mul equivalent,
    IEExecutor.cs:150)."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    u = q[:3]
    w = q[3]
    single = v.ndim == 1
    vv = v[None] if single else v
    t = 2.0 * np.cross(u, vv)
    out = vv + w * t + np.cross(u, t)
    return out[0] if single else out


def quat_from_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle_rad / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s,
                     np.cos(angle_rad / 2)], np.float32)


def quat_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Unity Quaternion.Slerp (shortest arc)."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    dot = float(np.dot(a, b))
    if dot < 0.0:
        b, dot = -b, -dot
    if dot > 0.9995:
        return quat_normalize(a + t * (b - a))
    theta = np.arccos(np.clip(dot, -1, 1))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b


# ---------------------------------------------------------------------------
# pose / intrinsics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pose:
    position: np.ndarray    # [3]
    rotation: np.ndarray    # quaternion [x,y,z,w]

    @staticmethod
    def identity() -> "Pose":
        return Pose(np.zeros(3, np.float32), quat_identity())

    def compose(self, local: "Pose") -> "Pose":
        """this ∘ local (worldFromHead * headFromCamera,
        PassthroughCameraUtils.cs:156)."""
        return Pose(self.position + quat_rotate(self.rotation, local.position),
                    quat_multiply(self.rotation, local.rotation))

    def transform_point(self, p: np.ndarray) -> np.ndarray:
        return self.position + quat_rotate(self.rotation, p)


@dataclasses.dataclass
class CameraIntrinsics:
    """PassthroughCameraIntrinsics equivalent
    (PassthroughCameraUtils.cs:353-371)."""
    focal_length: Tuple[float, float]       # (fx, fy) pixels
    principal_point: Tuple[float, float]    # (cx, cy) pixels
    resolution: Tuple[int, int]             # (w, h) pixels
    skew: float = 0.0

    @staticmethod
    def quest3_like() -> "CameraIntrinsics":
        """Plausible Quest-3 passthrough camera values for simulation."""
        return CameraIntrinsics((440.0, 440.0), (640.0, 480.0), (1280, 960))


def screen_point_to_ray_in_camera(intr: CameraIntrinsics,
                                  screen_point: Tuple[float, float]
                                  ) -> np.ndarray:
    """Pinhole back-projection (PassthroughCameraUtils.cs:188-199).
    Returns the (unnormalized) direction with z=1."""
    fx, fy = intr.focal_length
    cx, cy = intr.principal_point
    return np.array([(screen_point[0] - cx) / fx,
                     (screen_point[1] - cy) / fy, 1.0], np.float32)


def screen_point_to_ray_in_world(intr: CameraIntrinsics, cam_pose: Pose,
                                 screen_point: Tuple[float, float]
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(origin, direction) in world (PassthroughCameraUtils.cs:171-177)."""
    d = screen_point_to_ray_in_camera(intr, screen_point)
    return cam_pose.position, quat_rotate(cam_pose.rotation, d)


def world_point_to_screen(intr: CameraIntrinsics, cam_pose: Pose,
                          world_point: np.ndarray) -> Optional[Tuple[float, float]]:
    """Project a world point to camera pixel coords (the Camera.
    WorldToScreenPoint step of the laser pointer, IEPassthroughTrigger.cs:128-134).
    Returns None if the point is behind the camera."""
    rel = np.asarray(world_point, np.float32) - cam_pose.position
    p_cam = quat_rotate(quat_conjugate(cam_pose.rotation), rel)
    if p_cam[2] <= 1e-6:
        return None
    fx, fy = intr.focal_length
    cx, cy = intr.principal_point
    return (float(fx * p_cam[0] / p_cam[2] + cx),
            float(fy * p_cam[1] / p_cam[2] + cy))


def laser_screen_position(intr: CameraIntrinsics, cam_pose: Pose,
                          controller_pos: np.ndarray,
                          controller_forward: np.ndarray,
                          plane_distance: float = 2.0
                          ) -> Optional[Tuple[float, float]]:
    """The reference's laser-pointer hit test: project the point
    `plane_distance` meters along the controller ray onto the screen
    (IEPassthroughTrigger.cs:128-134)."""
    target = (np.asarray(controller_pos, np.float32)
              + np.asarray(controller_forward, np.float32) * plane_distance)
    return world_point_to_screen(intr, cam_pose, target)


def camera_pose_from_head(head_pose: Pose, head_from_camera: Pose) -> Pose:
    """GetCameraPoseInWorld composition incl. the 180° X flip
    (PassthroughCameraUtils.cs:154-158)."""
    world_from_camera = head_pose.compose(head_from_camera)
    flip = quat_from_axis_angle([1, 0, 0], np.pi)
    return Pose(world_from_camera.position,
                quat_multiply(world_from_camera.rotation, flip))


class LatencyCompensator:
    """Depth-frame pose latency compensation (IEExecutor.cs:317-349).

    The depth sensor lags the head pose by ~33 ms; the compensated pose is
    lerp/slerp(current, previous, clamp01(latency / dt)).
    """

    def __init__(self, latency_seconds: float = 0.033):
        self.latency = latency_seconds
        self._prev: Pose | None = None

    def reset(self) -> None:
        self._prev = None

    def compensate(self, current: Pose, dt: float) -> Pose:
        if self._prev is None:
            out = Pose(np.array(current.position, np.float32),
                       np.array(current.rotation, np.float32))
        else:
            t = float(np.clip(self.latency / max(dt, 1e-6), 0.0, 1.0))
            pos = current.position + (self._prev.position
                                      - current.position) * t
            rot = quat_slerp(current.rotation, self._prev.rotation, t)
            out = Pose(pos.astype(np.float32), rot.astype(np.float32))
        self._prev = Pose(np.array(current.position, np.float32),
                          np.array(current.rotation, np.float32))
        return out
