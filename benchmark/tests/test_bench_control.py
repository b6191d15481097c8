"""The control of each cell's correctness check comes out not correct:
the reference in fp8 (the precision below the configurations' bf16), in
the program's place, fails one of the cell's limits. Runs on the card
(marked `cuda`; it skips without one, deciding inside the test):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_control.py
"""
import copy

import pytest

from benchmark.harness import common, control

CELLS = ["yolo11n-seg.xr_tick", "yolo11x-seg.batch32"]
# fewer answers than a run compares, so that the test stays short
SMALLER = {"check_frames": 8, "control_frames": 12, "batch": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 977])
def test_control_is_not_correct(cell_name, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, cfg = common.cell_config(cell_name)
    cell = copy.deepcopy(cell)
    for k, v in SMALLER.items():
        if k in cell["params"]:
            cell["params"][k] = v
    nums = control.readings(cell, cfg, seed, "cuda",
                            control.QUANT_BELOW[cfg["dtype"]])
    correct, rows = control.judge(cell, nums)
    assert not correct, f"the control passed every limit: {rows}"
