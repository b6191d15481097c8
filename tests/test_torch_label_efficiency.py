"""The port's pseudo-labelling and active selection
(xrseg_tpu_torch/train/pseudo.py, train/active.py) against the JAX
package's (xrseg_tpu/train/pseudo.py, active.py), on the CPU.

- the numpy helpers (mask_to_polygon, coco_from_samples,
  margin_uncertainty, flip_disagreement) EQUAL to JAX's on seeded inputs;
- generate_pseudo_samples and rank_frames ("margin" and "flip") through
  both packages' pipelines at 64x64 (float32, matmul_precision "highest")
  with the same tests/torch_parity weights on 48x80 frames: labels and
  counts equal, boxes within 1e-4 (normalized), polygons with the same
  None pattern and within one mask pixel (the 0.5 threshold may flip on a
  rounding), uncertainties within 1e-5 and the same order;
- the port's COCO JSON read back through its CocoDataset with the same
  labels; obb and classify refused.
"""
import json

import numpy as np
import pytest

from xrseg_tpu import config as jconfig
from xrseg_tpu.train import active as JA
from xrseg_tpu.train import pseudo as JP
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import active as TA
from xrseg_tpu_torch.train import pseudo as TP
from xrseg_tpu_torch.train.data import CocoDataset
from torch_parity import detecting_tree

limit_cpu_threads()

MODEL = dict(scale="n", num_classes=3, input_size=(64, 64),
             dtype="float32", matmul_precision="highest")
FRAME_HW = (48, 80)
N_FRAMES = 4
MASK_PX = 1.0 / 16            # one pixel of the 16x16 mask, normalized


# ---------------------------------------------------------------------------
# the numpy helpers
# ---------------------------------------------------------------------------

def _blobs(rng, n=6, hw=(40, 56)):
    """Seeded soft masks: ellipses with noise, one empty, one single row."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
        ry, rx = rng.uniform(2, h / 3), rng.uniform(2, w / 3)
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        out.append((1.0 / (1.0 + d) + rng.normal(0, 0.05, hw)).astype(
            np.float32))
    out.append(np.zeros(hw, np.float32))
    row = np.zeros(hw, np.float32)
    row[7, 3:9] = 1.0
    out.append(row)
    return out


@pytest.mark.parametrize("step", [1, 2, 3])
def test_mask_to_polygon_equals_jax(step):
    for m in _blobs(np.random.default_rng(step)):
        for thr in (0.3, 0.5):
            a = JP.mask_to_polygon(m, threshold=thr, step=step)
            b = TP.mask_to_polygon(m, threshold=thr, step=step)
            assert (a is None) == (b is None)
            if a is not None:
                assert b.dtype == a.dtype
                np.testing.assert_array_equal(b, a)
        box = np.asarray([0.4, 0.5, 0.5, 0.3], np.float32)
        np.testing.assert_array_equal(TP._crop_to_box(m, box),
                                      JP._crop_to_box(m, box))


def _det(rng, n, pad=8, width=64.0):
    b = np.zeros((pad, 4), np.float32)
    b[:n] = np.concatenate([rng.uniform(8, width - 8, (n, 2)),
                            rng.uniform(4, 20, (n, 2))], -1)
    return {"boxes_xywh": b, "labels": rng.integers(0, 3, pad).astype(
        np.int32), "scores": rng.uniform(0, 1, pad).astype(np.float32),
        "count": n}


def test_scorers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        s = rng.uniform(0, 1, rng.integers(0, 9)).astype(np.float32)
        assert TA.margin_uncertainty(s) == JA.margin_uncertainty(s)
        a, b = _det(rng, rng.integers(0, 8)), _det(rng, rng.integers(0, 8))
        if rng.uniform() < 0.5:          # the mirrored twin of a, jittered
            b = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in a.items()}
            b["boxes_xywh"][:, 0] = 64.0 - b["boxes_xywh"][:, 0] + \
                rng.normal(0, 1, 8).astype(np.float32)
        for gate in (0.3, 0.5):
            assert TA.flip_disagreement(a, b, 64.0, gate) == \
                JA.flip_disagreement(a, b, 64.0, gate)


def test_coco_from_samples_equals_jax():
    rng = np.random.default_rng(3)
    samples = []
    for i in range(3):
        n = i + 1
        samples.append({
            "image": np.zeros((30 + i, 50, 3), np.uint8),
            "boxes": rng.uniform(0.1, 0.5, (n, 4)).astype(np.float32),
            "labels": rng.integers(0, 4, n).astype(np.int32),
            "polys": [None if j == 1 else rng.uniform(0, 1, (5, 2)).astype(
                np.float32) for j in range(n)]})
    for names in (["a", "b", "c", "d"], ["a", "b"]):
        assert TP.coco_from_samples(samples, ["x", "y", "z"], names) == \
            JP.coco_from_samples(samples, ["x", "y", "z"], names)


# ---------------------------------------------------------------------------
# through the deployed pipeline, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The same weights in both packages: every anchor fires class 1, its
    score spread around 0.5 by a widened class conv, so gates, margins and
    the flip probe see varied detections."""
    jm = jconfig.ModelConfig(**MODEL)
    tree = detecting_tree(jm, seed=3, label=1)
    for d3 in tree["det"]["cv3"]:
        d3["out"]["w"] = d3["out"]["w"] * np.float32(40.0)
        d3["out"]["b"][1] = 0.0
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, FRAME_HW + (3,), np.uint8)
              for _ in range(N_FRAMES)]
    return (jconfig.ExecutorConfig(model=jm), tree,
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL)),
            params_from_jax(tree, tconfig.ModelConfig(**MODEL)), frames)


def _same_polys(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    if a.shape == b.shape:
        assert float(np.abs(a - b).max()) <= MASK_PX + 1e-6
    else:                    # a row flipped at the threshold: the extents
        for d in range(2):
            assert abs(a[:, d].min() - b[:, d].min()) <= MASK_PX + 1e-6
            assert abs(a[:, d].max() - b[:, d].max()) <= MASK_PX + 1e-6


@pytest.fixture(scope="module")
def pseudo(setup):
    jcfg, tree, tcfg, model, frames = setup
    kw = dict(score_gate=0.4, max_det=30, poly_step=2)
    return (JP.generate_pseudo_samples(jcfg, tree, frames, **kw),
            TP.generate_pseudo_samples(tcfg, model, frames, device="cpu",
                                       **kw))


def test_generate_pseudo_samples_matches_jax(pseudo):
    want, got = pseudo
    assert len(got) == len(want) == N_FRAMES
    n_poly = 0
    for w, g in zip(want, got):
        assert len(g["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4)
        assert len(g["polys"]) == len(w["polys"])
        for a, b in zip(w["polys"], g["polys"]):
            _same_polys(a, b)
            n_poly += a is not None
    assert n_poly > 0


def test_pseudo_coco_reads_back(pseudo, tmp_path):
    from PIL import Image
    _, samples = pseudo
    files = []
    for i, s in enumerate(samples):
        files.append(f"im{i}.png")
        Image.fromarray(s["image"]).save(tmp_path / files[-1])
    coco = TP.coco_from_samples(samples, files, ["a", "b", "c"])
    path = tmp_path / "pseudo.json"
    path.write_text(json.dumps(coco))
    ds = CocoDataset(str(path), str(tmp_path))
    assert len(ds) == N_FRAMES and ds.class_names == ["a", "b", "c"]
    for i, s in enumerate(samples):
        got = ds[i]
        np.testing.assert_array_equal(got["labels"], s["labels"])
        np.testing.assert_allclose(got["boxes"], s["boxes"], atol=0.02)
        assert sum(p is not None for p in got["polys"]) == \
            sum(p is not None for p in s["polys"])


@pytest.mark.parametrize("strategy", ["margin", "flip"])
def test_rank_frames_matches_jax(setup, strategy):
    jcfg, tree, tcfg, model, frames = setup
    want = JA.rank_frames(jcfg, tree, frames, strategy=strategy)
    got = TA.rank_frames(tcfg, model, frames, strategy=strategy,
                         device="cpu")
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([u for _, u in got], [u for _, u in want],
                               rtol=0, atol=1e-5)
    assert len({round(u, 4) for _, u in got}) > 1        # a real ranking
    with pytest.raises(ValueError, match="strategy"):
        TA.rank_frames(tcfg, model, frames, strategy="bogus", device="cpu")


@pytest.mark.parametrize("task", ["obb", "classify"])
def test_box_slate_tasks_only(task):
    mcfg = tconfig.ModelConfig(**{**MODEL, "task": task})
    cfg = tconfig.ExecutorConfig(model=mcfg)
    frames = [np.zeros(FRAME_HW + (3,), np.uint8)]
    with pytest.raises(ValueError, match=task):
        TP.generate_pseudo_samples(cfg, None, frames, device="cpu")
    with pytest.raises(ValueError, match=task):
        TA.rank_frames(cfg, None, frames, device="cpu")


def test_pose_pseudo_samples_have_boxes_only(setup):
    """A pose pipeline's slate is the box slate: boxes, labels, no
    polygons (as the JAX function reads it)."""
    _, _, _, _, frames = setup
    import torch
    from xrseg_tpu_torch.testing import detection_params
    mcfg = tconfig.ModelConfig(**{**MODEL, "task": "pose", "num_classes": 1,
                                  "kpt_shape": (5, 3)})
    model = detection_params(torch.Generator().manual_seed(0), mcfg,
                             device="cpu")
    out = TP.generate_pseudo_samples(tconfig.ExecutorConfig(model=mcfg),
                                     model, frames[:1], score_gate=0.3,
                                     device="cpu")
    assert len(out[0]["labels"]) > 0
    assert all(p is None for p in out[0]["polys"])
