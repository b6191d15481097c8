"""The port's probe tools (xrseg_tpu_torch/tools/{xr_probe,executor_probe,
o2o_latency_ab}.py) against the JAX package's tools/ run in this process,
with --device cpu on the port's side.

- xr_probe: --size 64 --frames 8, sequential and --fused --pipelined 2;
  both sides on one `torch_parity.detecting_tree` (seed 1) carried across
  by io/bridge, patched in for each package's `testing.detection_params`.
  The rows' keys are equal, and so are the lock's result index, the
  tracked-frame and point counts, the weights, the mode and the stage
  names. The readiness poll decides which camera frames produce results:
  the port's CPU poll is true at once, JAX's `is_ready()` flips after an
  asynchronous dispatch a varying number of ticks later, so the test pins
  JAX's cadence by blocking its `run_inference` until the frame's outputs
  are ready (a wrapper in this test; the JAX package is not changed).
- executor_probe: 4 frames after 2 of warm-up, both ModelConfigs at
  64x64: the keys, n_frames and frame_hw equal, the latencies positive.
- o2o_latency_ab: --size 64 --frames 4 --warmup 1: the keys, both arms,
  size and frames equal, worst_at_frame inside [0, frames).
Each JAX tool runs once per module. The JAX init is patched out (seeded
trees stand in for it; its jitted form costs about 25 s).
"""
import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import xrseg_tpu
import xrseg_tpu.config as jconfig
import xrseg_tpu.testing as jtesting
import xrseg_tpu_torch.config as tconfig
import xrseg_tpu_torch.testing as ttesting
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.runtime import executor as jexecutor
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import (ab_active, ab_distill, ab_letterbox,
                                   ab_o2o, executor_probe, o2o_latency_ab,
                                   stage_profile, xr_probe)
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
SIZE = 64
XR_MODES = {"sequential": [], "pipelined": ["--fused", "--pipelined", "2"]}
XR_ARGS = ["--size", str(SIZE), "--frames", "8"]


def _jax_script(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _rows(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _lock_line(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if ln.startswith("laser-selected target:")]
    assert len(lines) == 1, text
    return lines[0]


@pytest.fixture(scope="module")
def xr_tree():
    return detecting_tree(jconfig.ModelConfig(input_size=(SIZE, SIZE)),
                          seed=1)


def _pinned_run_inference(real):
    """JAX's run_inference, returning only once the frame's outputs are
    ready: the first readiness poll after it is true, as the port's CPU
    poll is."""
    def run_inference(self, frame):
        ok = real(self, frame)
        if ok:
            jax.block_until_ready(self._inflight)
        return ok
    return run_inference


@pytest.fixture(scope="module")
def jax_xr(xr_tree):
    jtool = _jax_script("jax_xr_probe", "tools/xr_probe.py")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xrseg_tpu, "enable_compile_cache", lambda: None)
        mp.setattr(jtesting, "detection_params", lambda key, cfg: xr_tree)
        mp.setattr(jexecutor.Executor, "run_inference",
                   _pinned_run_inference(jexecutor.Executor.run_inference))
        for mode, extra in XR_MODES.items():
            mp.setattr("sys.argv", ["xr_probe.py", *XR_ARGS, *extra])
            out[mode] = _stdout(jtool.main)
    return out


@pytest.mark.parametrize("mode", list(XR_MODES))
def test_xr_probe_equals_the_jax_tool(mode, jax_xr, xr_tree, monkeypatch):
    monkeypatch.setattr(
        ttesting, "detection_params",
        lambda gen, cfg, device="cuda": params_from_jax(xr_tree, cfg))
    got = _stdout(xr_probe.main, [*XR_ARGS, *XR_MODES[mode], *CPU])
    want = jax_xr[mode]
    assert _lock_line(got) == _lock_line(want)
    t_rows, j_rows = _rows(got), _rows(want)
    assert len(t_rows) == len(j_rows) == (2 if mode == "pipelined" else 1)
    for t, j in zip(t_rows, j_rows):
        assert set(t) == set(j)
        for key in ("frames_timed", "lost_frames", "points_min",
                    "points_p50", "weights", "fused_tick",
                    "pipelined_depth", "metric", "unit"):
            assert t[key] == j[key], (key, t, j)
        assert set(t["stage_p50_ms"]) == set(j["stage_p50_ms"])
        assert t["frames_timed"] == 8 and t["weights"] == "fixture"
        assert t["value"] > 0
    assert t_rows[-1]["points_p50"] > 0
    assert [r["pipelined_depth"] for r in t_rows] == (
        [1, 2] if mode == "pipelined" else [0])


def test_xr_probe_refuses_pipelined_without_fused():
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        xr_probe.main(["--pipelined", "2", *CPU])


@pytest.fixture(scope="module")
def jax_trees():
    """Seeded JAX trees for the 64x64 model, plain and o2o, built before
    the init is patched (seeded_tree reads the init's structure)."""
    return {o2o: seeded_tree(jconfig.ModelConfig(
        input_size=(SIZE, SIZE), o2o=o2o)) for o2o in (False, True)}


@pytest.fixture(scope="module")
def jax_executor_probe(jax_trees):
    jtool = _jax_script("jax_executor_probe", "tools/executor_probe.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jy, "init_params", lambda key, cfg: jax_trees[cfg.o2o])
        mp.setattr(jconfig, "ModelConfig", functools.partial(
            jconfig.ModelConfig, input_size=(SIZE, SIZE)))
        with contextlib.redirect_stderr(io.StringIO()):
            return _stdout(jtool.main, 4, 2)


def test_executor_probe_keys_equal_the_jax_tool(jax_executor_probe,
                                                monkeypatch):
    monkeypatch.setattr(tconfig, "ModelConfig", functools.partial(
        tconfig.ModelConfig, input_size=(SIZE, SIZE)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = _stdout(executor_probe.main, ["4", "--warmup", "2", *CPU])
    (t,), (j,) = _rows(got), _rows(jax_executor_probe)
    assert list(t) == list(j)
    assert t["n_frames"] == j["n_frames"] == 4
    assert t["frame_hw"] == j["frame_hw"] == [480, 640]
    assert t["platform"] == "cpu"
    assert t["p50_latency_ms"] > 0 and t["p95_latency_ms"] > 0
    assert t["interactive_fps"] > 0
    # on the CPU the port's poll is true at once (runtime/executor.py)
    assert t["running_ticks_p50"] == t["running_ticks_max"] == 0
    assert "event query()" in err.getvalue()


O2O_ARGS = ["--size", str(SIZE), "--frames", "4", "--warmup", "1"]


@pytest.fixture(scope="module")
def jax_o2o(jax_trees):
    jtool = _jax_script("jax_o2o_latency_ab", "tools/o2o_latency_ab.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xrseg_tpu, "enable_compile_cache", lambda: None)
        mp.setattr(jy, "init_params", lambda key, cfg: jax_trees[cfg.o2o])
        mp.setattr("sys.argv", ["o2o_latency_ab.py", *O2O_ARGS])
        return _stdout(jtool.main)


def test_o2o_latency_ab_keys_equal_the_jax_tool(jax_o2o):
    (t,), (j,) = _rows(_stdout(o2o_latency_ab.main, [*O2O_ARGS, *CPU])), \
        _rows(jax_o2o)
    assert list(t) == list(j)
    assert t["size"] == j["size"] == SIZE and t["frames"] == j["frames"] == 4
    for arm in ("plain", "o2o"):
        assert list(t[arm]) == list(j[arm])
        assert all(0 <= i < 4 for i in t[arm]["worst_at_frame"])
        assert len(t[arm]["worst_ms"]) == 4
        assert 0 < t[arm]["p50"] <= t[arm]["p95"] <= t[arm]["p99"]
    assert t["p50_delta_ms"] == round(t["o2o"]["p50"] - t["plain"]["p50"], 2)


TOOL_ARGV = {xr_probe: ["--size", "64", "--frames", "1"],
             executor_probe: ["1"], o2o_latency_ab: ["--size", "64"],
             stage_profile: ["2", "--size", "64"],
             ab_o2o: ["--size", "64", "--weights", "none"],
             ab_letterbox: ["--size", "64", "--weights", "none"],
             ab_active: ["--size", "64"], ab_distill: ["--size", "64"]}


@pytest.mark.parametrize("tool", list(TOOL_ARGV),
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tools_default_to_the_card(tool):
    """Without --device the tools ask for the card, which this host has
    not: they raise instead of running on the CPU (the donor tools before
    they look for a donor)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = TOOL_ARGV[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"), \
            contextlib.redirect_stdout(io.StringIO()):
        tool.main(argv)
