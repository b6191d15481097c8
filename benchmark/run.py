"""Run one cell of the benchmark of xrseg_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. It builds the cell's program on weights made from the
seed, warms every shape the cell uses (set-up), measures for --seconds,
then holds a seeded sample of what the window produced against the plain
float32 reference. With --trace 0 it reports the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (after the same window, a
profiled one of the cell's `trace_seconds`). The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device,
(breakdown with --trace 1) and checks, each compared number with its
limit; the checks are also the last lines of standard error.

Exit codes: 0 a result was printed; 2 no (or too few) CUDA cards; 3 a
JAX module was loaded; 1 anything else.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell, its configuration, the run's
    arguments, the process's start (time.time clock) and the device."""
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    read_device: Callable[[Optional[dict]], dict]

    def mark(self, stage: str) -> None:
        """Print how far set-up has come (seconds since the start)."""
        print(f"setup {stage} {time.time() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", roots=(common.BENCH_DIR,),
            spec: Optional[dict] = None, t_start: Optional[float] = None,
            cfg_override: Optional[dict] = None) -> dict:
    """Run the cell and return the result object (without printing it),
    with the numbers compared but not limited under "diagnostics".
    Tests call it with device="cpu" and a small `cfg_override`."""
    import torch

    spec = spec or common.benchmark_spec()
    cell, cfg = common.cell_config(cell_name, roots)
    if cfg_override:
        cfg = {**cfg, **cfg_override}
    chips = int(cell["chips"])

    def read_device(trace_summary):
        if device == "cpu":
            info = {"platform": "cpu", "kind": "cpu", "count": chips,
                    "memory_peak_bytes": 0}
            if trace_summary is not None:
                info["busy_s"] = trace_summary["busy_s"]
                info["window_s"] = trace_summary["window_s"]
            return info
        return common.device_info(torch, chips, trace_summary)

    ctx = Context(cell=cell, cfg=cfg, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=device,
                  t_start=common.process_start() if t_start is None
                  else t_start, read_device=read_device)
    driver = common.load_module("drivers", cell["driver"], roots)
    run = driver.run(ctx)
    run["cell"], run["cfg"] = cell, cfg
    metrics = {}
    for m in common.metrics_for(spec, cell_name, trace):
        v = common.load_module("metrics", m["name"], roots).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": common.finite(v),
                                  "unit": m["unit"]}
    correct, rows = _judge(run["numbers"], cell["limits"])
    result = {"correct": correct, "attempted": int(run["attempted"]),
              "failed": int(run["failed"]), "metrics": metrics,
              "device": run["device"]}
    if trace and run.get("trace"):
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["diagnostics"] = {k: common.finite(v)
                             for k, v in run["numbers"].items()
                             if k not in cell["limits"]}
    result["checks"] = {n: {"value": common.finite(v), "limit": lim}
                        for n, v, lim in rows}
    return result


def _judge(numbers: dict, limits: dict):
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        ok = ok and v <= limit
        rows.append((name, v, limit))
    return ok, rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    t_start = common.process_start()
    common.setup_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell, _ = common.cell_config(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {common.power_limit()}", file=sys.stderr, flush=True)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, v in sorted(result.pop("diagnostics").items()):
        print(f"diag {name} {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
