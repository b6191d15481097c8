"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without
a card they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A tensor moves to `dev`; anything else (numpy, lists) is copied
    there, so read-only host arrays are never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.tensor(np.asarray(x), device=dev)
