"""The port's training scripts (xrseg_tpu_torch/examples/{train,
train_tasks,train_toy,distill}.py, xrseg_tpu_torch/tools/{pseudo_label,
select_frames}.py): each `main(argv)` with --device cpu at 64x64 for 2
steps, on npz and PNG files written to a temp directory.

- examples.train --weights on an 80-class npz with --classes 3 reports
  the transfer and trains; its ema.npz loads back strictly under the
  3-class config (the class branches keep the donor's width); on an
  80-class .onnx it prints the transfer line the JAX package's
  examples/train.py prints for the same file;
- examples.train_tasks (raw steps, and the Trainer with --eval),
  examples.train_toy, examples.distill (an npz teacher on PNG frames; its
  student.npz loads with the port's load_npz and unflattens to the JAX
  package's pytree structure);
- tools.pseudo_label's JSON reads back through CocoDataset with the
  labels generate_pseudo_samples gives; tools.select_frames ranks every
  frame;
- --mesh 2 (and train.py's --fsdp) train over a mesh of the CPU repeated
  twice, a .sentis file raises naming item 13.
"""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
from PIL import Image

from xrseg_tpu import config as jconfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.train import trainer as jtrainer
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.examples import distill, train, train_tasks, train_toy
from xrseg_tpu_torch.io import weights as W
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.io.onnx_export import export_onnx
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import pseudo_label, select_frames
from xrseg_tpu_torch.train.data import CocoDataset
from xrseg_tpu_torch.train.pseudo import generate_pseudo_samples
from torch_parity import detecting_tree

limit_cpu_threads()

SIZE = ["--size", "64", "--device", "cpu"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REAL_INIT = jy.init_params


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An 80-class YOLO11n-seg npz that detects, a 3-class detect npz, four
    64x64 PNG frames with YOLO labels (images/ + labels/)."""
    root = tmp_path_factory.mktemp("scripts")
    seg80 = detecting_tree(jconfig.ModelConfig(input_size=(64, 64)), seed=1)
    np.savez(root / "seg80.npz", **W.flatten_params(seg80))
    det3 = detecting_tree(jconfig.ModelConfig(
        task="detect", num_classes=3, input_size=(64, 64)), seed=2, label=1)
    np.savez(root / "det3.npz", **W.flatten_params(det3))
    cfg80 = ModelConfig(input_size=(64, 64), dtype="float32")
    export_onnx(params_from_jax(seg80, cfg80), cfg80, str(root / "seg80.onnx"))
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
            root / "images" / f"f{i}.png")
        (root / "labels" / f"f{i}.txt").write_text(
            f"{i % 3} 0.5 0.5 0.3 0.4\n1 0.3 0.6 0.2 0.2\n")
    return root


def test_train_transfers_an_80_class_npz(files, tmp_path, capsys):
    out = tmp_path / "run"
    rc = train.main(["--data", str(files), "--weights",
                     str(files / "seg80.npz"), "--classes", "3",
                     "--epochs", "1", "--batch", "2", "--out", str(out),
                     *SIZE])
    text = capsys.readouterr().out
    assert rc == 0
    assert f"transfer: 194 leaves from {files / 'seg80.npz'}; " \
           "reinitialized 6 (det)" in text, text
    assert "done: 1 epochs" in text
    cfg3 = ModelConfig(num_classes=3, input_size=(64, 64), dtype="float32")
    ema = W.load_npz(str(out / "ema.npz"), cfg3)
    assert ema.det.cv3[0].pw1.weight.shape[0] == 80     # the donor's width


def test_train_transfers_an_80_class_onnx_as_jax_does(files, tmp_path,
                                                      capsys, monkeypatch):
    """An .onnx donor's head does not load under --classes 3: the loader's
    ValueError sends it through the 80-class segmenter and transfer_params.
    The port's transfer line equals the one the JAX script prints for the
    same file (its init_params and Trainer stood in for: the report
    depends only on the tree's shapes, and the line comes before fit)."""
    onnx = str(files / "seg80.onnx")
    argv = ["--data", str(files), "--weights", onnx, "--classes", "3",
            "--batch", "2", "--out", str(tmp_path / "run")]

    def transfer_line(text):
        return [ln for ln in text.splitlines() if ln.startswith("transfer:")]

    assert train.main(argv + ["--epochs", "1", *SIZE]) == 0
    port = transfer_line(capsys.readouterr().out)
    assert port == [f"transfer: 194 leaves from {onnx}; reinitialized 6 "
                    "(det)"]

    class _Stop(Exception):
        pass

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(jy, "init_params", lambda key, cfg: jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: _REAL_INIT(k, cfg), key)))
    monkeypatch.setattr(jtrainer, "Trainer", stop)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--size", "64"])
    spec = importlib.util.spec_from_file_location(
        "jax_examples_train", os.path.join(ROOT, "examples", "train.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(_Stop):
        script.main()
    assert transfer_line(capsys.readouterr().out) == port


def test_train_tasks(files, tmp_path, capsys):
    out = tmp_path / "pose.npz"
    assert train_tasks.main(["--task", "pose", "--steps", "2", "--out",
                             str(out), "--weights", str(files / "seg80.npz"),
                             *SIZE]) == 0
    text = capsys.readouterr().out
    assert "transfer: " in text and "step 1: loss=" in text
    W.load_npz(str(out), ModelConfig(task="pose", num_classes=2,
                                     kpt_shape=(5, 3), input_size=(64, 64)))
    assert train_tasks.main(["--task", "classify", "--epochs", "1",
                             "--batch", "2", "--n-samples", "4", "--eval",
                             "2", *SIZE]) == 0
    assert "eval: {'top1_acc'" in capsys.readouterr().out


def test_train_toy(tmp_path, capsys):
    assert train_toy.main(["--steps", "2", "--batch", "2", "--out",
                           str(tmp_path), *SIZE]) == 0
    assert "2 steps in" in capsys.readouterr().out
    W.load_npz(str(tmp_path / "toy_ckpt.npz"), ModelConfig(
        num_classes=3, input_size=(64, 64)))


@pytest.mark.parametrize("source", ["images", "synthetic"])
def test_distill(files, tmp_path, capsys, source):
    argv = ["--teacher", str(files / "det3.npz"), "--teacher-task", "detect",
            "--steps", "2", "--batch", "2", "--out", str(tmp_path), *SIZE]
    argv += (["--images", str(files / "images")] if source == "images"
             else ["--synthetic", "--det-weight", "1.0", "--arch", "yolov8",
                   "--teacher-arch", "yolo11"])
    assert distill.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("teacher: yolo11-n detect nc=3")
    summary = json.loads(lines[-1])
    assert np.isfinite(summary["final_loss"]) and summary["steps"] == 2
    arch = "yolo11" if source == "images" else "yolov8"
    scfg = ModelConfig(arch=arch, task="detect", num_classes=3,
                       input_size=(64, 64))
    W.load_npz(summary["out"], scfg)
    with np.load(summary["out"]) as z:
        tree = W.unflatten_params({k: z[k] for k in z.files})
    jshapes = jax.eval_shape(lambda k: jy.init_params(k, jconfig.ModelConfig(
        arch=arch, task="detect", num_classes=3, input_size=(64, 64))),
        jax.random.key(0))
    assert jax.tree.structure(tree) == jax.tree.structure(jshapes)
    assert jax.tree.leaves(jax.tree.map(lambda a, b: a.shape == b.shape,
                                        tree, jshapes)) == \
        [True] * len(jax.tree.leaves(tree))


def test_pseudo_label_reads_back(files, tmp_path, capsys):
    out = tmp_path / "pseudo.json"
    assert pseudo_label.main(["--images", str(files / "images"), "--weights",
                              str(files / "seg80.npz"), "--out", str(out),
                              *SIZE]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 4 and summary["annotations"] > 0
    assert summary["with_masks"] > 0
    cfg = ExecutorConfig(model=ModelConfig(input_size=(64, 64)))
    model, _ = W.load_params_auto(str(files / "seg80.npz"), cfg.model)
    frames = [np.asarray(Image.open(files / "images" / f"f{i}.png"))
              for i in range(4)]
    want = generate_pseudo_samples(cfg, model, frames, poly_step=2,
                                   device="cpu")
    ds = CocoDataset(str(out), str(files / "images"))
    assert len(ds) == 4
    for i in range(4):
        np.testing.assert_array_equal(ds[i]["labels"], want[i]["labels"])


def test_select_frames(files, tmp_path, capsys):
    out = tmp_path / "sel.json"
    assert select_frames.main(["--images", str(files / "images"),
                               "--weights", str(files / "seg80.npz"),
                               "--k", "3", "--strategy", "flip", "--out",
                               str(out), *SIZE]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"strategy": "flip", "scored": 4, "selected": 3}
    rows = json.loads(out.read_text())
    assert [r["uncertainty"] for r in rows] == sorted(
        (r["uncertainty"] for r in rows), reverse=True)


@pytest.mark.parametrize("script", ["train", "train_toy", "distill"])
def test_mesh_is_item_10(files, tmp_path, script, capsys):
    """--mesh 2 (the training half of ROADMAP item 10) runs each script
    over a (2, 1) mesh of the CPU; train.py with --fsdp too."""
    argv = {"train": ["--data", str(files), "--epochs", "1", "--batch", "2",
                      "--classes", "3", "--no-mosaic", "--mesh", "2",
                      "--fsdp"],
            "train_toy": ["--steps", "2", "--batch", "2", "--mesh", "2"],
            "distill": ["--teacher", str(files / "det3.npz"),
                        "--teacher-task", "detect", "--synthetic",
                        "--steps", "2", "--batch", "2", "--mesh", "2"]
            }[script]
    main = {"train": train.main, "train_toy": train_toy.main,
            "distill": distill.main}[script]
    rc = main(argv + ["--out", str(tmp_path), *SIZE])
    text = capsys.readouterr().out
    if script == "train":
        assert rc == 0 and "done: 1 epochs" in text
        W.load_npz(str(tmp_path / "ema.npz"), ModelConfig(
            num_classes=3, input_size=(64, 64)))
    elif script == "train_toy":
        assert "training over mesh {'data': 2, 'model': 1}" in text
        assert "2 steps in" in text
        W.load_npz(str(tmp_path / "toy_ckpt.npz"), ModelConfig(
            num_classes=3, input_size=(64, 64)))
    else:
        assert rc == 0
        assert np.isfinite(json.loads(text.strip().splitlines()[-1])[
            "final_loss"])


def test_sentis_is_item_13(files, tmp_path):
    (tmp_path / "m.sentis").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 13"):
        pseudo_label.main(["--images", str(files / "images"), "--weights",
                           str(tmp_path / "m.sentis"), "--out",
                           str(tmp_path / "p.json"), *SIZE])
