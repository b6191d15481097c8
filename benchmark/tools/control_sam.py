"""Read the control of a SAM cell's correctness check on the card: the
reference in the precision below the configuration's (fp8 for bf16), in
the program's place, on each seed; prints one JSON line per seed with its
numbers and whether the cell's limits would pass it (they must not), and
the same for the bf16 witness with --witness.

    python benchmark/tools/control_sam.py \\
        --workload sam-vit-h.batch8_box16_960x1280 --seeds 11 22 33
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common, control  # noqa: E402
from benchmark.harness import sam as sam_h  # noqa: E402


def readings(cell: dict, cfg: dict, seed: int, device, quant: str) -> dict:
    """control.readings on SAM's weights."""
    from benchmark import run as bench_run
    ctx = bench_run.Context(cell=cell, cfg=cfg, seed=int(seed), seconds=0.0,
                            trace=False, device=device, t_start=time.time(),
                            read_device=lambda _: {})
    sd = sam_h.make_weights(cfg, seed, device)
    driver = common.load_module("drivers", cell["driver"])
    return driver.control(ctx, sd, quant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--witness", action="store_true",
                    help="also read the bf16 witness")
    args = ap.parse_args(argv)
    common.setup_environment()
    cell, cfg = common.cell_config(args.workload)
    below = control.QUANT_BELOW[cfg["dtype"]]
    quants = [below] + (["bf16"] if args.witness else [])
    for seed in args.seeds:
        for q in quants:
            t = time.time()
            nums = readings(cell, cfg, seed, args.device, q)
            correct, rows = control.judge(cell, nums)
            fails = {n: v for n, v, lim in rows if not v <= lim}
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "quant": q, "numbers": nums,
                              "fails": fails, "correct": correct,
                              "seconds": round(time.time() - t, 2)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
