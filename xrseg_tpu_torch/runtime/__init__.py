"""The port's runtime (counterpart of xrseg_tpu/runtime): the Executor and
the XR loop around it, camera permissions, frame sources and tracing."""
from xrseg_tpu_torch.runtime import frame_source, tracing  # noqa: F401
from xrseg_tpu_torch.runtime.executor import (ExecState,  # noqa: F401
                                              Executor, FrameResult)
from xrseg_tpu_torch.runtime.xr_loop import (  # noqa: F401
    ControllerState, XRLoop, aim_controller_at_frame_point)
from xrseg_tpu_torch.runtime.permissions import (  # noqa: F401
    CameraPermissions, ManagedFrameSource, ManagedSourceState,
    PermissionProvider)
