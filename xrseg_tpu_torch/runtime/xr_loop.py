"""XR application loop: feed-when-idle + controller-event protocol (L7).

Library-level rebuild of the reference's IEPassthroughTrigger
(Assets/Scripts/InferenceEngine/IEPassthroughTrigger.cs):

  Update() per display tick (:58-73)       XRLoop.tick(frame, controller)
  HandleControllerInput (:75-113)          _handle_controller
    B button down -> ResetTracking (:80)     controller.button_b edge
    trigger held  -> laser + point cloud     controller.trigger edge/level
      ExtractPointCloudAtScreenPos (:98)
    trigger down  -> SelectTargetFromScreenPos (:101-104)
  ShowLaser / laser line (:115-126)        laser_visible + laser_segment
  GetLaserScreenPosition (:128-134)        2 m plane point -> screen pixels
  feed-when-idle (:67-72): RunInference    executor.run_inference when idle

The loop is renderer-agnostic: callers pass per-tick FrameData + an
optional ControllerState snapshot; results come back as the executor's
FrameResult. Coordinates: controller pose and laser math live in camera
*sensor* pixels (the reference's Camera.main space); selections are issued
to the executor in *frame* pixels — the same sensor->frame scaling the
reference implicitly gets from rendering the webcam texture full-screen.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from xrseg_tpu_torch.perception.camera import (CameraIntrinsics, Pose,
                                         laser_screen_position,
                                         screen_point_to_ray_in_world)
from xrseg_tpu_torch.runtime.frame_source import FrameData


@dataclasses.dataclass
class ControllerState:
    """Right-controller snapshot for one tick (OVRInput equivalents).

    position/forward are world-space (the reference reads
    _rightController.position/.forward, IEPassthroughTrigger.cs:122-131).
    trigger / button_b are *level* states; the loop derives the GetDown
    edges itself (OVRInput.GetDown, :80,88).
    """
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 1], np.float32))
    trigger: bool = False
    button_b: bool = False


def aim_controller_at_frame_point(intr: CameraIntrinsics, cam_pose: Pose,
                                  frame_point: Tuple[float, float],
                                  frame_wh: Tuple[float, float]
                                  ) -> ControllerState:
    """Build a controller aimed so its laser hits `frame_point` (frame
    pixels, top-left origin). Test/demo helper: the inverse of the laser
    projection — place the controller at the camera and point it along the
    back-projected ray."""
    sx = intr.resolution[0] / float(frame_wh[0])
    sy = intr.resolution[1] / float(frame_wh[1])
    cam_px = (frame_point[0] * sx, frame_point[1] * sy)
    origin, fwd = screen_point_to_ray_in_world(intr, cam_pose, cam_px)
    fwd = fwd / np.linalg.norm(fwd)
    return ControllerState(position=origin.astype(np.float32),
                           forward=fwd.astype(np.float32))


class XRLoop:
    """Drives an Executor from per-tick frames + controller events."""

    def __init__(self, executor, intrinsics: Optional[CameraIntrinsics] = None,
                 laser_length: float = 10.0, laser_plane_distance: float = 2.0):
        self.executor = executor
        self.intrinsics = intrinsics
        self.laser_length = laser_length          # ref _laserLength (:16)
        self.plane_distance = laser_plane_distance  # 2 m plane (:131)
        self._trigger_was_held = False            # ref _isTriggerHeld (:19)
        self._b_was_down = False
        self.laser_visible = False
        self.laser_segment: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_laser_frame_pos: Optional[Tuple[float, float]] = None
        self.selected = False                     # select ever succeeded

    # ------------------------------------------------------------------

    def tick(self, frame: FrameData,
             controller: Optional[ControllerState] = None):
        """One display tick (Update, IEPassthroughTrigger.cs:58-73).

        Controller input is handled regardless of camera availability
        (:60-61); inference is fed only when the executor is idle (:67-72).
        Returns the FrameResult if one completed this tick, else None.
        """
        if controller is not None:
            self._handle_controller(frame, controller)

        if frame.rgb is None:                      # no webcam data (:64-65)
            return None
        if not self.executor.is_running():
            self.executor.run_inference(frame)
        result = self.executor.update()
        # advance CLEANUP -> COMPLETED within the same tick so the next
        # tick can feed again (the reference's state machine likewise
        # finishes cleanup before re-triggering, IEExecutor.cs:410-415)
        if result is not None:
            self.executor.update()
        return result

    # ------------------------------------------------------------------

    def _handle_controller(self, frame: FrameData,
                           ctl: ControllerState) -> None:
        """HandleControllerInput (IEPassthroughTrigger.cs:75-113)."""
        # B button: reset tracking (:80-84)
        if ctl.button_b and not self._b_was_down:
            self.executor.reset_tracking()
        self._b_was_down = ctl.button_b

        trigger_down = ctl.trigger and not self._trigger_was_held

        if ctl.trigger:
            self._trigger_was_held = True
            self._show_laser(True, ctl)
            sp = self._laser_frame_position(frame, ctl)
            self.last_laser_frame_pos = sp
            if sp is not None:
                # trigger held: extract the point cloud at the laser (:98)
                self.executor.extract_point_cloud_at_screen_pos(sp)
                if trigger_down:                   # lock target (:101-104)
                    self.selected = (
                        self.executor.select_target_from_screen_pos(sp)
                        or self.selected)
        elif self._trigger_was_held:
            # trigger released: hide laser, keep the point cloud (:106-112)
            self._trigger_was_held = False
            self._show_laser(False, ctl)

    def _show_laser(self, show: bool, ctl: ControllerState) -> None:
        """ShowLaser (IEPassthroughTrigger.cs:115-126)."""
        self.laser_visible = show
        self.laser_segment = (
            (ctl.position, ctl.position + ctl.forward * self.laser_length)
            if show else None)

    def _laser_frame_position(self, frame: FrameData, ctl: ControllerState
                              ) -> Optional[Tuple[float, float]]:
        """GetLaserScreenPosition (IEPassthroughTrigger.cs:128-134): the
        point 2 m along the controller ray, projected to camera pixels,
        scaled to executor frame pixels."""
        intr = self.intrinsics or frame.intrinsics
        pose = frame.pose
        if intr is None or pose is None:
            return None
        cam_px = laser_screen_position(intr, pose, ctl.position, ctl.forward,
                                       self.plane_distance)
        if cam_px is None:
            return None
        fw, fh = self.executor.screen_wh
        sx = intr.resolution[0] / float(fw)
        sy = intr.resolution[1] / float(fh)
        return (cam_px[0] / sx, cam_px[1] / sy)
