"""The port's HTTP load generator (xrseg_tpu_torch/tools/loadtest.py) on the
CPU, against the JAX package's tools/loadtest.py.

One port InferenceServer (64x64 YOLO11n-seg, micro-batch 2, an ephemeral
port, device="cpu") takes the JAX tool's `run_load` and the port's with 3
clients x 2 requests: the rows' keys are equal, every request is answered
and none fails. The port's `main` then runs its own in-process server
with --device cpu: its row adds micro_batch and batch_hist, as the JAX
tool's does, and the histogram accounts for every request, the warm-up
bursts included. Every wait has a deadline in seconds and every server
is closed.
"""
import contextlib
import functools
import importlib.util
import io
import json
import threading
from pathlib import Path

import pytest

import xrseg_tpu_torch.config as tconfig
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.runtime.server import InferenceServer
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import loadtest

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 120.0
HW = (64, 64)
CLIENTS, PER_CLIENT = 3, 2
WARMUP_POSTS = sum({1, 2, CLIENTS})       # run_load's warm-up bursts


def _within(fn, *args):
    """fn(*args) on a daemon thread, failed if it takes DEADLINE_S."""
    out, err = [], []

    def run():
        try:
            out.append(fn(*args))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), f"{fn} still running after {DEADLINE_S} s"
    if err:
        raise err[0]
    return out[0]


@pytest.fixture(scope="module")
def server():
    srv = InferenceServer(
        ExecutorConfig(model=ModelConfig(input_size=HW)), frame_hw=HW,
        port=0, micro_batch=2, device="cpu").start()
    try:
        yield srv
    finally:
        srv.close()


def _jax_run_load():
    spec = importlib.util.spec_from_file_location(
        "jax_loadtest", ROOT / "tools" / "loadtest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_load


@pytest.mark.parametrize("side", ["port", "jax"])
def test_run_load_rows_equal_the_jax_tool(server, side):
    run_load = loadtest.run_load if side == "port" else _jax_run_load()
    url = f"http://127.0.0.1:{server.port}"
    got = _within(run_load, url, CLIENTS, PER_CLIENT, HW)
    want_keys = ["clients", "requests", "errors", "fps", "p50_ms", "p95_ms"]
    assert list(got) == want_keys
    assert got["requests"] == CLIENTS * PER_CLIENT and got["errors"] == 0
    assert got["clients"] == CLIENTS
    assert got["fps"] > 0 and 0 < got["p50_ms"] <= got["p95_ms"]


def test_main_in_process_reports_the_batches(monkeypatch):
    monkeypatch.setattr(tconfig, "ModelConfig", functools.partial(
        tconfig.ModelConfig, input_size=HW))
    argv = ["--clients", str(CLIENTS), "--per-client", str(PER_CLIENT),
            "--micro-batch", "2", "--frame-hw", *map(str, HW),
            "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _within(loadtest.main, argv) == 0
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(row) == ["clients", "requests", "errors", "fps", "p50_ms",
                         "p95_ms", "micro_batch", "batch_hist"]
    n = CLIENTS * PER_CLIENT
    assert row["requests"] == n and row["errors"] == 0
    assert row["micro_batch"] == 2
    hist = {int(k): v for k, v in row["batch_hist"].items()}
    assert set(hist) <= {1, 2}
    assert sum(hist.values()) >= n / 2
    assert sum(k * v for k, v in hist.items()) == n + WARMUP_POSTS


def test_main_url_branch(server):
    """--url runs the load alone against an existing server."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _within(loadtest.main, [
            "--url", f"http://127.0.0.1:{server.port}", "--clients", "2",
            "--per-client", "1", "--frame-hw", *map(str, HW)]) == 0
    row = json.loads(buf.getvalue())
    assert row["requests"] == 2 and row["errors"] == 0


def test_main_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadtest.main(["--frame-hw", *map(str, HW)])
