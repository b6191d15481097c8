"""The port's perception (counterpart of xrseg_tpu/perception)."""
from xrseg_tpu_torch.perception import camera, tracking  # noqa: F401
