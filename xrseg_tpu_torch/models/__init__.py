"""The port's networks (counterpart of xrseg_tpu/models). The JAX
package's free `forward(params, x, cfg)` is the module's own
`YOLO11.forward` here."""
from xrseg_tpu_torch.models import layers, yolo11  # noqa: F401
from xrseg_tpu_torch.models.yolo11 import (  # noqa: F401
    YOLO11, init_params, make_anchors, model_info)
