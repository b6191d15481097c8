"""The port's training (counterpart of xrseg_tpu/train): data, losses, the
train step and the Trainer; distill, pseudo and active are imported on
demand (`from xrseg_tpu_torch.train import distill`)."""
from xrseg_tpu_torch.train import data, losses, train_step, trainer  # noqa: F401
