"""95th percentile of the window's XR tick latencies (ms)."""
from benchmark.harness.stats import percentile


def read(run):
    lat = run.get("tick_latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
