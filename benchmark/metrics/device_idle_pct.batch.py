"""Share (%) of the traced window with no kernel, copy or memset running
on the device: one minus the union of the device's busy intervals over
the window's length."""
from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
