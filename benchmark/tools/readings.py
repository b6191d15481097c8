"""Read the program's compared numbers for a cell on many seeds in one
process: for each seed, a whole run of the cell (set-up on the seed's
weights, a window of --seconds at the cell's own load, the run's own
check), printing one JSON line with every number the check computed,
limited or not. The limits' lower readings come from these lines and
from the full runs' stderr.

    python benchmark/tools/readings.py --workload yolo11n-seg.xr_tick \\
        --seconds 5 --seeds 11 22 33 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import common  # noqa: E402


def read(cell: str, seed: int, seconds: float, device: str = "cuda",
         cfg_override=None) -> dict:
    t = time.time()
    res = bench_run.execute(cell, seed, seconds, False, device=device,
                            t_start=t, cfg_override=cfg_override)
    nums = {**res["diagnostics"],
            **{k: c["value"] for k, c in res["checks"].items()}}
    return {"workload": cell, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "numbers": nums,
            "seconds": round(time.time() - t, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common.setup_environment()
    for seed in args.seeds:
        print(json.dumps(read(args.workload, seed, args.seconds,
                              args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
