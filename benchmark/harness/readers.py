"""Arithmetic that several metric readers share."""
from __future__ import annotations


def idle_pct(run):
    """100 * (1 - busy / window) of the traced window, or None."""
    tr = run.get("trace")
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
