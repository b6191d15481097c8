"""The control of the correctness check: the reference itself, computed
in the nearest precision below the configuration's (fp8 e4m3 operands
for a bfloat16 configuration), put in the program's place. Each driver's
`control` makes its answers at the cell's own sizes and hands them to
the driver's own `_check`; `judge` holds the numbers to the cell's
limits with the run's own `_judge`. It has to read correct=False; `bf16`
(operands rounded to bfloat16) is a witness that should read as the
program does.

    python benchmark/tools/control.py --workload <cell> --seeds 1 2 3
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

from benchmark.harness import common
from benchmark.harness.weights import make_weights

QUANT_BELOW = {"bfloat16": "fp8", "float16": "fp8", "float32": "bf16"}


def readings(cell: dict, cfg: dict, seed: int, device, quant: str
             ) -> Dict[str, float]:
    """The cell's compared numbers, the answers made by the reference in
    `quant` on the inputs of `seed`, judged by the driver's _check."""
    from benchmark import run as bench_run
    ctx = bench_run.Context(cell=cell, cfg=cfg, seed=int(seed), seconds=0.0,
                            trace=False, device=device, t_start=time.time(),
                            read_device=lambda _: {})
    sd = make_weights(cfg, seed, device)
    driver = common.load_module("drivers", cell["driver"])
    return driver.control(ctx, sd, quant)


def judge(cell: dict, numbers: Dict[str, float]) -> Tuple[bool, list]:
    """(correct, [(name, value, limit)]) as a run judges its numbers."""
    from benchmark import run as bench_run
    return bench_run._judge(numbers, cell["limits"])
