"""The port's drawing helpers (counterpart of xrseg_tpu/viz)."""
from xrseg_tpu_torch.viz import boxer, labels, masker, pointcloud  # noqa: F401
