"""The whole step's share (%) of the card's bf16 dense peak: the
benchmark's own FLOP count per frame (the forward's convs and matmuls
and the mask synthesis, from the configuration's shapes) times the
frames completed in the window, over 989 TFLOP/s times the window."""
from benchmark.harness.counts import PEAK_FLOPS


def read(run):
    f, n, w = run.get("flops_per_frame"), run.get("frames"), \
        run.get("window_s")
    if not f or not n or not w:
        return None
    return 100.0 * f * n / (PEAK_FLOPS * w)
