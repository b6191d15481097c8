"""Mean duration (ms) of the window's dispatching XRLoop.tick calls (those
in which the executor was idle before the call): the host's enqueue of
the fused tick's frame program plus the loop's own work."""
from benchmark.harness.stats import mean


def read(run):
    d = run.get("spans", {}).get("dispatch_tick_s")
    return mean(d) * 1e3 if d else None
