"""Device busy time a batch (ms) inside the program's `xrseg.sam_decoder`
ranges in the traced window: SAM's prompt encoder, mask decoder and the
masks' resize to the frame (harness/ranges.py). None where the trace
holds no such range."""


def read(run):
    tr, n = run.get("trace"), run.get("trace_steps")
    rng = ((tr or {}).get("ranges") or {}).get("xrseg.sam_decoder")
    if not n or not rng or not rng["device_s"]:
        return None
    return rng["device_s"] / n * 1e3
