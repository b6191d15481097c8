"""The port's model I/O (counterpart of xrseg_tpu/io)."""
from xrseg_tpu_torch.io import weights  # noqa: F401
