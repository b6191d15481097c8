"""The FLOP and byte count from shapes equals FlopCounterMode over the
reference forward, and YOLO11n-seg counts 9.80 GFLOPs at 640x640."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import common, counts
from benchmark.reference import yolo


@pytest.mark.parametrize("name", ["yolo11n-seg", "yolo11x-seg"])
def test_count_equals_flop_counter(name):
    cfg = common.load_json("configs", name)
    sd = {n: torch.empty(s, device="meta")
          for n, s, _ in yolo.param_specs(cfg)}
    fc = FlopCounterMode(display=False)
    with fc:
        yolo.forward(yolo.Ops(sd), cfg,
                     torch.empty((2, 640, 640, 3), device="meta"))
    assert yolo.count_forward(cfg, 2).flops == fc.get_total_flops()


def test_n_counts_9_80_gflops():
    cfg = common.load_json("configs", "yolo11n-seg")
    assert round(yolo.count_forward(cfg).flops / 1e9, 2) == 9.80


def test_least_time_bounds():
    cfg = common.load_json("configs", "yolo11x-seg")
    c = counts.pipeline_counts(cfg, 32)
    # at least the FLOPs over the peak, and under a second
    assert c["flops"] / counts.PEAK_FLOPS <= c["least_s"] < 1.0
    c1 = counts.pipeline_counts(cfg, 1)
    assert abs(c["least_s"] - 32 * c1["least_s"]) < 0.05 * c["least_s"]
