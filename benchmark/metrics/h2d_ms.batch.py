"""Host-to-device copy time per batch (ms) in the traced window: the
frames' uploads."""


def read(run):
    tr, n = run.get("trace"), run.get("trace_steps")
    if not tr or not n or not tr["h2d_s"]:
        return None
    return tr["h2d_s"] / n * 1e3
