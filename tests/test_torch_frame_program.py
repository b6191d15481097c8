"""The one frame program of the port (xrseg_tpu_torch/compile.py), on the
CPU: every runner, single-device or split over devices, enters it through
CompiledPipeline.enqueue, once a call for each device program it runs,
and runs the whole of it (preprocess, forward, decode) under inference
mode. The runners' results are held against the JAX package in their own
files (test_torch_pipeline, _tta, _ensemble, _tick, _streaming and
_parallel)."""
import numpy as np
import pytest
import torch

from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.models.yolo11 import init_params
from xrseg_tpu_torch.parallel import batch as pbatch
from xrseg_tpu_torch.parallel.mesh import make_mesh
from xrseg_tpu_torch.parallel.pipeline import PipelinedRunner
from xrseg_tpu_torch.parallel.spatial import build_spatial_pipeline
from xrseg_tpu_torch.runtime.streaming import StreamingRunner
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

CPU = torch.device("cpu")
CFG = ExecutorConfig(model=ModelConfig(input_size=(64, 64), dtype="float32"),
                     post=PostprocessConfig(pre_nms_topk=64, max_detections=10,
                                            score_threshold=1e-7))


@pytest.fixture(scope="module")
def model():
    return init_params(torch.Generator().manual_seed(0), CFG.model)


def _frames(B):
    return np.random.default_rng(B).integers(0, 256, (B, 64, 64, 3),
                                             np.uint8)


def _pipeline(m):
    return tcompile.build_pipeline(CFG, m, batch=2, device="cpu")(_frames(2))


def _tta(m):
    return tcompile.build_pipeline(CFG, m, batch=2, device="cpu",
                                   tta=True)(_frames(2))


def _stream(m):
    runner = StreamingRunner(
        tcompile.build_pipeline(CFG, m, batch=2, device="cpu"), depth=1)
    runner.submit(_frames(2))
    return next(runner.drain()).device_out


def _ensemble(m):
    return tcompile.build_ensemble_pipeline(CFG, [m, m], batch=2,
                                            device="cpu")(_frames(2))


def _tick(m):
    tick = tcompile.build_xr_tick_pipeline(CFG, m, depth_hw=(16, 16),
                                           device="cpu")
    aux = np.zeros((tick.AUX_LEN,), np.float32)
    return tick(_frames(1), np.zeros((16, 16), np.uint16), aux)


def _sharded(m):
    fn, rows = pbatch.build_sharded_pipeline(
        CFG, m, make_mesh((2, 1), devices=[CPU] * 2), batch=2)
    return fn(rows, _frames(2))


def _spatial(m):
    fn, reps = build_spatial_pipeline(
        CFG, m, make_mesh((2, 1), devices=[CPU] * 2), batch=1)
    return fn(reps, _frames(1))


def _staged(m):
    return PipelinedRunner(CFG, m, devices=[CPU, CPU], batch=2)(_frames(2))


# runner -> the device programs one call of it runs (one a data row)
RUNNERS = {"pipeline": (_pipeline, 1), "tta": (_tta, 1),
           "stream": (_stream, 1), "ensemble": (_ensemble, 1),
           "tick": (_tick, 1), "sharded": (_sharded, 2),
           "spatial": (_spatial, 1), "staged": (_staged, 1)}


@pytest.mark.parametrize("runner", sorted(RUNNERS))
def test_every_runner_enters_the_program_through_enqueue(model, runner,
                                                        monkeypatch):
    entered, modes = [], []
    enqueue = tcompile.CompiledPipeline.enqueue
    preprocess = tcompile.CompiledPipeline.preprocess

    def counted(self, frames):
        entered.append(type(self).__name__)
        return enqueue(self, frames)

    def observed(self, *frames):
        modes.append(torch.is_inference_mode_enabled())
        return preprocess(self, *frames)

    monkeypatch.setattr(tcompile.CompiledPipeline, "enqueue", counted)
    monkeypatch.setattr(tcompile.CompiledPipeline, "preprocess", observed)
    fn, programs = RUNNERS[runner]
    out = fn(model)
    assert len(entered) == programs, entered
    assert modes == [True] * programs
    result = out["packed"] if runner == "tick" else out["slate"]
    assert torch.isfinite(result).all()
