"""What every run shares: finding a cell's files by name, the metrics a
cell reports, the run's environment, the device's description, the
check that no JAX module is loaded, and the result line.

A cell is `workloads/<cell>.json`; it names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`). Each
metric is read by `metrics/<metric>.py` (a `read(run)` that returns a
number, or None where it finds nothing to read). Which metrics a cell
reports comes from BENCHMARK.json at the checkout's root: its end-to-end
metrics with `--trace 0`, its per-layer ones with `--trace 1`, each
where its `workloads` list names the cell or it has none. So a later
cell, configuration or metric is new files and new entries only.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xrseg_tpu")


def find(kind: str, name: str, suffix: str,
         roots: Sequence[Path] = (BENCH_DIR,)) -> Path:
    for r in roots:
        p = Path(r) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                            f"{[str(r) for r in roots]}")


def load_json(kind: str, name: str, roots=(BENCH_DIR,)) -> dict:
    with open(find(kind, name, ".json", roots)) as f:
        return json.load(f)


def load_module(kind: str, name: str, roots=(BENCH_DIR,)):
    path = find(kind, name, ".py", roots)
    mod_name = f"_bench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_for(spec: dict, cell: str, trace: bool) -> List[dict]:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_config(cell_name: str, roots=(BENCH_DIR,)):
    """The cell's dict and its configuration's, found by name."""
    cell = load_json("workloads", cell_name, roots)
    if cell.get("name") != cell_name:
        raise ValueError(f"workloads/{cell_name}.json names itself "
                         f"{cell.get('name')!r}")
    cfg = load_json("configs", cell["config"], roots)
    return cell, cfg


def setup_environment() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout; no
    library may pull JAX in behind the program's back."""
    cache = BENCH_DIR / "out" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc; the
    interpreter's first statement where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int, trace: Optional[dict]) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def finite(v: float) -> float:
    """JSON has no infinity: an infinite reading is printed as 1e30."""
    return 1e30 if math.isinf(v) or math.isnan(v) else float(v)
