"""Kernel launches, copies and memsets in the traced window, per frame
completed in it."""


def read(run):
    tr, n = run.get("trace"), run.get("trace_frames")
    if not tr or not n or not tr["launches"]:
        return None
    return tr["launches"] / n
