"""The port's array ops and kernel wrappers (counterpart of xrseg_tpu/ops).
Importing them builds no kernel: each wrapper builds its library on its
first launch."""
from xrseg_tpu_torch.ops import (masks, nms, postprocess,  # noqa: F401
                                 preprocess, wbf, yuv)
