"""Donor weights of the A/B tools (ab_o2o, ab_letterbox, ab_active,
ab_distill). The JAX tools default --weights to the reference project's
deployed .sentis at a fixed path; the port finds it under the project
root that XRSEG_REFERENCE names, as tools/xr_probe.py does with the same
REF_SENTIS."""
from __future__ import annotations

import os
from typing import Optional

REF_SENTIS = "Assets/Resources/Model/yolo11n-seg-sentis.sentis"


def donor_path(weights: Optional[str]) -> Optional[str]:
    """--weights as given; when it is not given, the reference's .sentis
    under $XRSEG_REFERENCE, or None without that variable."""
    if weights is not None:
        return weights
    ref = os.environ.get("XRSEG_REFERENCE", "")
    return os.path.join(ref, REF_SENTIS) if ref else None


def optional_donor(weights: Optional[str]) -> Optional[str]:
    """The donor file of a tool that falls back to random init: None for
    'none', for no path, and for a path that does not exist (the JAX
    tools' os.path.exists check)."""
    path = donor_path(weights)
    if path and path.lower() != "none" and os.path.exists(path):
        return path
    return None


def required_donor(weights: Optional[str], tool: str) -> str:
    """The donor file of a tool that has no random-init route: raises
    FileNotFoundError, naming --weights, when there is none."""
    path = donor_path(weights)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"{tool} grafts a donor and has no random-init route: no "
            f"weights at {path!r}; pass --weights <.sentis|.npz|.pt|.onnx> "
            f"or set XRSEG_REFERENCE to the reference project's root (its "
            f"{REF_SENTIS})")
    return path


def rounded(row: dict) -> dict:
    """An eval row as the JAX tools print it: floats to 4 places."""
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in row.items()}
