"""Frames whose results reached the caller inside the window, per second
of the window."""


def read(run):
    if run.get("frames") is None or not run.get("window_s"):
        return None
    return run["frames"] / run["window_s"]
