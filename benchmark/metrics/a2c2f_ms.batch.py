"""Device busy time a batch (ms) inside the program's `xrseg.a2c2f`
ranges in the traced window: the attention-bearing A2C2f blocks (their
convs, attention and residuals; harness/ranges.py). None where the trace
holds no such range."""


def read(run):
    tr, n = run.get("trace"), run.get("trace_steps")
    rng = ((tr or {}).get("ranges") or {}).get("xrseg.a2c2f")
    if not n or not rng or not rng["device_s"]:
        return None
    return rng["device_s"] / n * 1e3
