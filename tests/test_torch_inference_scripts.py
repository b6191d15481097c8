"""The port's inference scripts (xrseg_tpu_torch/examples/{demo,serve}.py,
xrseg_tpu_torch/tools/{track_video,task_accuracy_report}.py): each
`main(argv)` with --device cpu on a few small synthetic inputs.

- demo: test mode over a PNG directory and over a Y4M clip (one overlay
  PNG a frame), XR mode on the synthetic passthrough camera;
- serve: one JSON line per path, equal to the direct b=1 pipeline's
  detections mapped to frame pixels;
- track_video: its MOTChallenge rows on a Y4M clip equal the JAX
  package's tools/track_video.py on the same clip and npz (run in this
  process; both ModelConfigs at 64x64 and float32: frames and ids equal,
  boxes within 0.02 px and scores within 2e-4, the rows' rounding), and
  --gt scores them;
- task_accuracy_report: the pose, obb and classify tables;
- demo and track_video --sentis on a synthetic template answer as the
  JAX scripts do on the same file.
Weights: tests/torch_parity.detecting_tree at 64x64 in an npz.
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
from PIL import Image

import xrseg_tpu.config as jconfig
import xrseg_tpu_torch.config as tconfig
from xrseg_tpu.io.weights import save_npz as jsave_npz
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.eval.metrics import detections_from_slate
from xrseg_tpu_torch.examples import demo, serve
from xrseg_tpu_torch.io.weights import load_npz
from xrseg_tpu_torch.ops.yuv import rgb_to_yuv420_numpy
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import task_accuracy_report, track_video
from torch_parity import detecting_tree

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
HW = (96, 128)
_ModelConfig = tconfig.ModelConfig


@pytest.fixture
def small_model(monkeypatch):
    """demo, serve and track_video build their ModelConfig at its 640x640
    default, as the JAX scripts do; here it is 64x64 (`**kw` adds more
    fields)."""
    def patch(**kw):
        monkeypatch.setattr(tconfig, "ModelConfig", functools.partial(
            _ModelConfig, input_size=(64, 64), **kw))
    patch()
    return patch


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 64x64 YOLO11n-seg npz that detects, three 96x128 PNGs and a Y4M
    clip of four frames."""
    root = tmp_path_factory.mktemp("inference")
    jsave_npz(str(root / "w.npz"), detecting_tree(
        jconfig.ModelConfig(input_size=(64, 64)), seed=5))
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, HW + (3,), np.uint8)).save(
            root / "imgs" / f"f{i}.png")
    frames = rng.integers(0, 256, (4,) + HW + (3,), np.uint8)
    y, u, v = rgb_to_yuv420_numpy(frames)
    with open(root / "clip.y4m", "wb") as f:
        f.write(f"YUV4MPEG2 W{HW[1]} H{HW[0]} F30:1 Ip A1:1 C420jpeg\n"
                .encode())
        for i in range(len(frames)):
            f.write(b"FRAME\n" + y[i].tobytes() + u[i].tobytes()
                    + v[i].tobytes())
    return root


def test_demo_test_mode_over_images_and_a_clip(files, tmp_path,
                                              small_model):
    out = _run(demo.main, ["--images", str(files / "imgs"), "--out",
                           str(tmp_path / "a"), "--ckpt",
                           str(files / "w.npz"), *CPU])
    assert out.count("detections in") == 3
    assert len(list((tmp_path / "a").glob("test_*.png"))) == 3
    out = _run(demo.main, ["--video", str(files / "clip.y4m"), "--out",
                           str(tmp_path / "b"), "--ckpt",
                           str(files / "w.npz"), *CPU])
    assert out.count("detections in") == 4
    assert Image.open(tmp_path / "b" / "test_003.png").size == HW[::-1]


def test_demo_xr_mode(files, tmp_path, small_model):
    out = _run(demo.main, ["--mode", "xr", "--frames", "6", "--out",
                           str(tmp_path), "--ckpt", str(files / "w.npz"),
                           "--score-threshold", "0.05", *CPU])
    assert "results from 6 frames" in out
    assert "laser-selected target" in out


def test_serve_json_equals_the_direct_pipeline(files, tmp_path,
                                              small_model):
    paths = sorted(str(p) for p in (files / "imgs").glob("*.png"))
    (tmp_path / "list.txt").write_text("\n".join(paths))
    lines = _run(serve.main, ["--list", str(tmp_path / "list.txt"),
                              "--ckpt", str(files / "w.npz"), "--score",
                              "0.05", *CPU]).strip().splitlines()
    mcfg = ModelConfig(input_size=(64, 64))
    cfg = ExecutorConfig(model=mcfg, post=PostprocessConfig(
        iou_threshold=0.6, score_threshold=0.05))
    pipe = build_pipeline(cfg, load_npz(str(files / "w.npz"), mcfg),
                          frame_hw=HW, batch=1, device="cpu")
    assert len(lines) == 3
    for path, line in zip(paths, lines):
        got = json.loads(line)
        assert got["path"] == path
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        det = {k: v.numpy() for k, v in pipe(img[None]).items()}
        want = detections_from_slate(det, frame_hw=HW,
                                     input_size=mcfg.input_size)
        assert len(got["detections"]) == len(want) > 0
        for g, w in zip(got["detections"], want):
            assert g["label"] == w.label
            assert abs(g["score"] - w.score) < 1e-3
            np.testing.assert_allclose(g["box_xywh"], w.box_xywh, atol=0.06)


def test_serve_takes_sentis(files, tmp_path, small_model):
    """serve --sentis (a synthetic template of the npz's weights): each
    line equals the direct b=1 pipeline on the model load_params_auto
    reads from the same file."""
    from xrseg_tpu_torch.io.weights import load_params_auto
    from xrseg_tpu_torch.testing import sentis_template
    mcfg = ModelConfig(input_size=(64, 64))
    path = sentis_template(mcfg, detecting_tree(jconfig.ModelConfig(
        input_size=(64, 64)), seed=5), str(tmp_path / "m.sentis"))
    paths = sorted(str(p) for p in (files / "imgs").glob("*.png"))
    (tmp_path / "list.txt").write_text("\n".join(paths))
    lines = _run(serve.main, ["--list", str(tmp_path / "list.txt"),
                              "--sentis", path, "--score", "0.05",
                              *CPU]).strip().splitlines()
    cfg = ExecutorConfig(model=mcfg, post=PostprocessConfig(
        iou_threshold=0.6, score_threshold=0.05))
    pipe = build_pipeline(cfg, load_params_auto(path, mcfg)[0], frame_hw=HW,
                          batch=1, device="cpu")
    assert len(lines) == 3
    for path, line in zip(paths, lines):
        got = json.loads(line)
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        want = detections_from_slate(
            {k: v.numpy() for k, v in pipe(img[None]).items()},
            frame_hw=HW, input_size=mcfg.input_size)
        assert len(got["detections"]) == len(want) > 0
        for g, w in zip(got["detections"], want):
            assert g["label"] == w.label
            assert abs(g["score"] - w.score) < 1e-3
            np.testing.assert_allclose(g["box_xywh"], w.box_xywh, atol=0.06)


def _rows(path):
    return np.array([[float(v) for v in ln.split(",")]
                     for ln in Path(path).read_text().splitlines()])


def test_track_video_rows_equal_the_jax_script(files, tmp_path,
                                               monkeypatch, small_model):
    """Both scripts build their model at float32: in bfloat16 the score
    logits tie in groups, and the port's extra bf16 rounding (models/
    layers.py) can move a logit across a tie, which reorders the NMS
    survivors and so the order in which new tracks take their ids."""
    small_model(dtype="float32")
    out = _run(track_video.main, [
        "--video", str(files / "clip.y4m"), "--out", str(tmp_path / "t.txt"),
        "--ckpt", str(files / "w.npz"), *CPU])
    assert "4 frames ->" in out
    spec = importlib.util.spec_from_file_location(
        "jax_track_video", ROOT / "tools" / "track_video.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    monkeypatch.setattr(jconfig, "ModelConfig", functools.partial(
        jconfig.ModelConfig, input_size=(64, 64), dtype="float32"))
    monkeypatch.setattr("sys.argv", [
        "track_video.py", "--video", str(files / "clip.y4m"), "--out",
        str(tmp_path / "j.txt"), "--ckpt", str(files / "w.npz")])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jtool.main() == 0
    got, want = _rows(tmp_path / "t.txt"), _rows(tmp_path / "j.txt")
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:6], want[:, 2:6], atol=0.02 + 1e-9)
    np.testing.assert_allclose(got[:, 6], want[:, 6], atol=2e-4)
    # --gt scores the rows (here an image directory's against themselves)
    score = json.loads(_run(track_video.main, [
        "--images", str(files / "imgs"), "--out", str(tmp_path / "i.txt"),
        "--ckpt", str(files / "w.npz"), "--gt", str(tmp_path / "i.txt"),
        *CPU]).strip().splitlines()[-1])
    assert score["MOTA"] == 1.0 and score["n_frames"] == 3


def test_task_accuracy_report(tmp_path):
    out = _run(task_accuracy_report.main, [
        "--size", "64", *CPU, "--out", str(tmp_path / "r.json")])
    assert "25 scenes at 64^2" in out
    rep = json.loads((tmp_path / "r.json").read_text())
    assert set(rep) == {"pose", "obb", "classify"}
    assert rep["pose"]["n_images"] == rep["obb"]["n_images"] == 25
    assert rep["pose"]["n_detections_ours"] > 0
    assert rep["classify"]["top1_agreement"] == 1.0


def _jax_script(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo_rows(text: str) -> list:
    """demo's per-frame lines without their timings: (count,) and, per
    box, (class name, score, cx, cy, w, h)."""
    rows = []
    for ln in text.splitlines():
        if ln.startswith("frame "):
            rows.append((int(ln.split()[2]),))
        elif "score=" in ln:
            name, rest = ln.split(" score=")
            nums = rest.replace("center=(", "").replace("size=(", "")
            nums = nums.replace(")", "").replace("x", ",").replace(" ", ",")
            rows.append((name.strip(), *[float(v) for v in nums.split(",")
                                         if v]))
    return rows


def test_sentis_is_refused_naming_item_13(files, tmp_path, monkeypatch,
                                          small_model):
    """demo and track_video take --sentis (a synthetic template of the
    npz's weights, float32 models) and answer as the JAX scripts do on
    the same file: demo's counts and class names equal, scores within
    0.01, centres and sizes within 1 px (printed rounded); track_video's
    rows as test_track_video_rows_equal_the_jax_script holds them. The
    name is kept from when the port refused .sentis."""
    import xrseg_tpu.models.yolo11 as jy
    from xrseg_tpu_torch.testing import sentis_template
    small_model(dtype="float32")
    jcfg = jconfig.ModelConfig(input_size=(64, 64))
    path = sentis_template(tconfig.ModelConfig(), detecting_tree(
        jcfg, seed=5), str(tmp_path / "m.sentis"))
    monkeypatch.setattr(jconfig, "ModelConfig", functools.partial(
        jconfig.ModelConfig, input_size=(64, 64), dtype="float32"))
    shapes = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                            jax.random.key(0))
    monkeypatch.setattr(jy, "init_params", lambda k, c: jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))  # all overwritten

    got = _run(demo.main, ["--images", str(files / "imgs"), "--out",
                           str(tmp_path / "d"), "--sentis", path, *CPU])
    jdemo = _jax_script("jax_demo", "examples/demo.py")
    monkeypatch.setattr("sys.argv", ["demo.py", "--images",
                                     str(files / "imgs"), "--out",
                                     str(tmp_path / "jd"), "--sentis", path])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jdemo.main() == 0
    t, j = _demo_rows(got), _demo_rows(buf.getvalue())
    assert len(t) == len(j) > 3 and t[0][0] > 0
    for a, b in zip(t, j):
        assert a[:1] == b[:1] and len(a) == len(b)
        if len(a) > 1:
            assert abs(a[1] - b[1]) <= 0.01 + 1e-9
            np.testing.assert_allclose(a[2:], b[2:], atol=1.0)

    _run(track_video.main, ["--video", str(files / "clip.y4m"), "--out",
                            str(tmp_path / "t.txt"), "--sentis", path, *CPU])
    jtool = _jax_script("jax_track_video", "tools/track_video.py")
    monkeypatch.setattr("sys.argv", [
        "track_video.py", "--video", str(files / "clip.y4m"), "--out",
        str(tmp_path / "j.txt"), "--sentis", path])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jtool.main() == 0
    got, want = _rows(tmp_path / "t.txt"), _rows(tmp_path / "j.txt")
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:6], want[:, 2:6], atol=0.02 + 1e-9)
    np.testing.assert_allclose(got[:, 6], want[:, 6], atol=2e-4)
