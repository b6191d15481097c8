"""Camera permission + availability gating (L1).

Rebuild of the reference's permission machinery:

  PassthroughCameraPermissions (Assets/Scripts/PassthroughCamera/
  PassthroughCameraPermissions.cs):
    - two permissions requested in ONE batch (:24-28,59-60)
    - tri-state grant flag (bool? HasCameraPermission, :30)
    - ask-once flag (s_askedOnce, :31,39-43)
    - denial resets the ask-once flag so a later enable re-asks (:83-88)

  WebCamTextureManager (WebCamTextureManager.cs):
    - unsupported device disables the manager outright (:40-47)
    - enable waits for permission instead of failing (:49-56)
    - per-tick Update() promotes "waiting" -> "initializing" once the
      grant lands (:73-82)
    - camera-not-found retry loop around WebCamTexture creation
      (:101-133; the reference retries every frame forever — here the
      attempts are bounded and surfaced)

The platform's permission dialog is abstracted as PermissionProvider so
tests script grant/deny/dont-ask-again flows without an OS.
"""
from __future__ import annotations

import enum
from typing import Callable, Iterable, Optional, Sequence

from xrseg_tpu_torch.runtime.frame_source import FrameSource
from xrseg_tpu_torch.runtime import logging as xlog

# the reference's permission batch (PassthroughCameraPermissions.cs:24-28)
CAMERA_PERMISSIONS = ("camera", "headset_camera")


class PermissionProvider:
    """Platform permission API stand-in (UnityEngine.Android.Permission).

    request() resolves asynchronously in real platforms; callbacks fire per
    permission, mirroring PermissionCallbacks (:53-56).
    """

    def has_permission(self, name: str) -> bool:
        raise NotImplementedError

    def request(self, names: Sequence[str],
                on_granted: Callable[[str], None],
                on_denied: Callable[[str], None]) -> None:
        raise NotImplementedError


class GrantAllProvider(PermissionProvider):
    """Headset-free default: everything is granted (file/synthetic sources)."""

    def has_permission(self, name: str) -> bool:
        return True

    def request(self, names, on_granted, on_denied) -> None:
        for n in names:
            on_granted(n)


class ScriptedProvider(PermissionProvider):
    """Test provider: a queue of per-request {name: granted} responses."""

    def __init__(self, initial: Optional[Iterable[str]] = None,
                 responses: Optional[list] = None):
        self._granted = set(initial or ())
        self._responses = list(responses or [])
        self.request_count = 0

    def has_permission(self, name: str) -> bool:
        return name in self._granted

    def request(self, names, on_granted, on_denied) -> None:
        self.request_count += 1
        answers = self._responses.pop(0) if self._responses else {}
        for n in names:
            if answers.get(n, False):
                self._granted.add(n)
                on_granted(n)
            else:
                on_denied(n)


class CameraPermissions:
    """PassthroughCameraPermissions equivalent."""

    def __init__(self, provider: Optional[PermissionProvider] = None,
                 permissions: Sequence[str] = CAMERA_PERMISSIONS,
                 extra_startup_permissions: Sequence[str] = ()):
        self.provider = provider or GrantAllProvider()
        self.permissions = tuple(permissions)
        self.extra = tuple(extra_startup_permissions)
        # bool? HasCameraPermission (:30): None until determined
        self.has_camera_permission: Optional[bool] = None
        self._asked_once = False

    def _all_granted(self) -> bool:
        """IsAllCameraPermissionsGranted (:90)."""
        return all(self.provider.has_permission(p) for p in self.permissions)

    def ask(self) -> None:
        """AskCameraPermissions (:37-62): no-op if already asked; one
        batched request for camera + startup permissions."""
        if self._asked_once:
            return
        self._asked_once = True
        if self._all_granted():
            self.has_camera_permission = True
            xlog.log("all camera permissions granted")
            return
        xlog.log("requesting camera permissions")
        self.provider.request(self.permissions + self.extra,
                              self._on_granted, self._on_denied)

    def _on_granted(self, name: str) -> None:
        """PermissionCallbacksPermissionGranted (:68-77): the flag flips
        only once every camera permission is in."""
        xlog.log(f"permission {name} granted")
        if self._all_granted():
            self.has_camera_permission = True

    def _on_denied(self, name: str) -> None:
        """PermissionCallbacksPermissionDenied (:83-88): record the denial
        AND reset ask-once so the next ask() retries the dialog."""
        xlog.warning(f"permission {name} denied")
        self.has_camera_permission = False
        self._asked_once = False


class ManagedSourceState(enum.Enum):
    DISABLED = "disabled"                 # unsupported device (:40-47)
    WAITING_PERMISSION = "waiting"        # enable without grant (:49-56)
    INITIALIZING = "initializing"         # open-retry loop (:101-133)
    READY = "ready"
    FAILED = "failed"                     # bounded retries exhausted


class ManagedFrameSource:
    """WebCamTextureManager equivalent: gates a FrameSource behind device
    support, permission grant, and a bounded camera-not-found retry loop.
    """

    def __init__(self, source: FrameSource,
                 permissions: Optional[CameraPermissions] = None,
                 is_supported: bool = True, max_open_attempts: int = 10):
        self.source = source
        self.permissions = permissions or CameraPermissions()
        self.is_supported = is_supported
        self.max_open_attempts = max(1, int(max_open_attempts))
        self.state = ManagedSourceState.DISABLED
        self.open_attempts = 0
        # Awake: ask permissions immediately (WebCamTextureManager.cs:28-35)
        self.permissions.ask()

    @property
    def is_ready(self) -> bool:
        return self.state == ManagedSourceState.READY

    def enable(self) -> None:
        """OnEnable (:38-58)."""
        if not self.is_supported:
            xlog.log("passthrough camera not supported; disabling")
            self.state = ManagedSourceState.DISABLED
            return
        if self.permissions.has_camera_permission is not True:
            xlog.error("camera permissions not granted yet; waiting")
            self.state = ManagedSourceState.WAITING_PERMISSION
            return
        self.state = ManagedSourceState.INITIALIZING
        self._try_open()

    def update(self) -> None:
        """Per-tick Update (:73-82): promote waiting -> initializing once
        the grant lands; keep retrying a camera that is not found."""
        if self.state == ManagedSourceState.WAITING_PERMISSION:
            if self.permissions.has_camera_permission is not True:
                # a denial resets ask-once; re-ask so the dialog reappears
                # (PassthroughCameraPermissions.cs:87 + Awake-time ask)
                if self.permissions.has_camera_permission is False:
                    self.permissions.ask()
                return
            self.state = ManagedSourceState.INITIALIZING
        if self.state == ManagedSourceState.INITIALIZING:
            self._try_open()

    def disable(self) -> None:
        """OnDisable (:60-70): stop and release the camera."""
        self.source.close()
        if self.state in (ManagedSourceState.READY,
                          ManagedSourceState.INITIALIZING):
            self.state = ManagedSourceState.WAITING_PERMISSION \
                if self.permissions.has_camera_permission is not True \
                else ManagedSourceState.INITIALIZING
        self.open_attempts = 0

    def frames(self):
        if self.state != ManagedSourceState.READY:
            raise RuntimeError(f"frame source not ready ({self.state.value})")
        return self.source.frames()

    def _try_open(self) -> None:
        """InitializeWebCamTexture retry body (:101-133), bounded."""
        while self.open_attempts < self.max_open_attempts:
            self.open_attempts += 1
            if self.source.open():
                self.state = ManagedSourceState.READY
                xlog.log(f"camera opened after {self.open_attempts} "
                             "attempt(s)")
                return
            xlog.error("requested camera is not present; retrying")
        self.state = ManagedSourceState.FAILED
        xlog.error(f"camera not found after {self.max_open_attempts} "
                       "attempts")
