"""The compiled artifact (compile.export_compiled / load_compiled: a
torch.export program with the weights inside) and the converter CLI
(python -m xrseg_tpu_torch.compile), on the CPU at 64x64.

The artifact must give the pipeline's detections: every output EQUAL (the
program runs the same ops on the same weights). The CLI writes an artifact
and an ultralytics-contract .onnx from an npz and from a .pt; each must
read back into the weights it was written from.
"""
import dataclasses

import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.io import weights as jw
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import onnx_loader, torch_pt
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from test_pt_loader import make_state_dict
from torch_parity import detecting_tree

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), num_classes=3, dtype="float32",
             matmul_precision="highest")


def _cfgs(task="detect"):
    return (jconfig.ModelConfig(task=task, **MODEL),
            tconfig.ModelConfig(task=task, **MODEL))


def _frames(B=1, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, 48, 64, 3),
                                                np.uint8)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("merge", ["nms", "wbf"])
def test_export_then_load_gives_the_pipelines_detections(merge, tmp_path):
    jcfg, mcfg = _cfgs("segment")
    cfg = tconfig.ExecutorConfig(model=mcfg, post=tconfig.PostprocessConfig(
        score_threshold=0.3, merge=merge))
    pipe = tcompile.build_pipeline(cfg, params_from_jax(detecting_tree(jcfg),
                                                        mcfg),
                                   frame_hw=(48, 64), batch=2, device="cpu")
    path = str(tmp_path / "seg.xrseg")
    tcompile.export_compiled(pipe, path)
    run = tcompile.load_compiled(path)
    assert run.meta["input_shape"] == [2, 48, 64, 3]
    assert run.meta["cfg"]["post"]["merge"] == merge
    frames = _frames(2, 1)
    got = run(frames)
    assert int(got["count"].min()) > 0
    _assert_same(got, pipe(frames))


def _write_sources(tmp_path):
    """An npz and an un-fused .pt of the same detect weights."""
    jcfg, mcfg = _cfgs()
    tree = detecting_tree(jcfg, seed=2)
    npz = str(tmp_path / "w.npz")
    jw.save_npz(npz, tree)
    pt = str(tmp_path / "w.pt")
    torch.save(make_state_dict(tree, jcfg, np.random.default_rng(0)), pt)
    return tree, mcfg, npz, pt


@pytest.mark.parametrize("source", ["npz", "pt"])
def test_cli_writes_an_artifact_and_an_onnx(source, tmp_path, capsys):
    tree, mcfg, npz, pt = _write_sources(tmp_path)
    weights = npz if source == "npz" else pt
    flags = ["--task", "detect", "--classes", "3", "--size", "64",
             "--score", "0.3", "--frame-hw", "48", "64"]
    out = str(tmp_path / "m.xrseg")
    assert tcompile._main([weights, "--out", out, "--device", "cpu",
                           *flags]) == 0
    onnx = str(tmp_path / "m.onnx")
    assert tcompile._main([weights, "--out", onnx, *flags]) == 0
    printed = capsys.readouterr().out
    assert "compiled" in printed and "ONNX opset 13" in printed

    model, cfg = tw.load_params_auto(weights, dataclasses.replace(
        mcfg, dtype="bfloat16", matmul_precision="default"))
    pipe = tcompile.build_pipeline(
        tconfig.ExecutorConfig(model=cfg, post=tconfig.PostprocessConfig(
            iou_threshold=0.6, score_threshold=0.3)), model,
        frame_hw=(48, 64), device="cpu")
    frames = _frames(1, 3)
    _assert_same(tcompile.load_compiled(out)(frames), pipe(frames))
    back, _ = onnx_loader.load_yolo11_onnx(onnx, cfg)
    src = params_from_jax(tree, mcfg).state_dict()
    for k, v in back.state_dict().items():
        # the .pt went through a BN fold: float32 rounding of the fold
        torch.testing.assert_close(v, src[k], rtol=3e-5, atol=3e-5,
                                   msg=k)


@pytest.mark.parametrize("ext", [".pt", ".pth", ".onnx"])
def test_load_params_auto_dispatches(ext, tmp_path):
    tree, mcfg, npz, pt = _write_sources(tmp_path)
    path = str(tmp_path / f"d{ext}")
    if ext == ".onnx":
        tcompile.export_onnx(params_from_jax(tree, mcfg), mcfg, path)
        want, _ = onnx_loader.load_yolo11_onnx(path, mcfg)
    else:
        torch.save(torch.load(pt, weights_only=True), path)
        want, _ = torch_pt.load_yolo11_pt(path, mcfg)
    got, cfg = tw.load_params_auto(path, mcfg)
    assert cfg == mcfg
    _assert_same(got.state_dict(), want.state_dict())
