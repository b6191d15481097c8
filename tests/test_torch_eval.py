"""The port's evaluation (xrseg_tpu_torch/eval) against the JAX package's,
on the CPU.

- metrics and MOT: both packages are numpy, so every result is held EQUAL
  (NaN where both are NaN) on constructed cases of known AP (perfect,
  false positives, misses, localization, class confusion, masks, OKS,
  rotated boxes, crowd regions) and on seeded random ones.
- evaluate_dataset / evaluate_task_dataset: the same synthetic datasets
  and tests/torch_parity weights through JAX's pipeline and the port's
  (float32, matmul_precision "highest"), segment, detect, pose, obb and
  classify, with tta=True and merge="wbf" once each. The per-image
  detections that reach the matcher are captured on both sides: counts
  and labels EQUAL, boxes within 1e-2 px, scores within 1e-4, masks
  agreeing on at least 99% of their pixels; the result dicts within
  1e-4; every detection image non-empty.
- the COCO results dump against JAX's rows, the eval CLI with
  --device cpu, and the port's parity oracle (a float32 CPU forward +
  numpy NMS) against tests/torch_ref.py's.
"""
import json
import math
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.eval import dataset_eval as jde
from xrseg_tpu.eval import metrics as jm
from xrseg_tpu.eval import mot as jmot
from xrseg_tpu.eval import parity as jpar
from xrseg_tpu.eval import task_parity as jtpar
from xrseg_tpu.train import data as jd
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.eval import dataset_eval as tde
from xrseg_tpu_torch.eval import metrics as tm
from xrseg_tpu_torch.eval import mot as tmot
from xrseg_tpu_torch.eval import parity as tpar
from xrseg_tpu_torch.eval import task_parity as ttpar
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.train import data as td
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree

limit_cpu_threads()

EXACT = dict(dtype="float32", matmul_precision="highest")


def _same(a: dict, b: dict, tol: float = 0.0) -> None:
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and math.isnan(x):
            assert isinstance(y, float) and math.isnan(y), (k, x, y)
        elif tol:
            assert abs(x - y) <= tol, (k, x, y)
        else:
            assert x == y, (k, x, y)


# ---------------------------------------------------------------------------
# metrics: constructed and seeded cases, both packages on the same inputs
# ---------------------------------------------------------------------------

def _build(M, spec):
    """spec: [(dets, gts)] of plain dicts -> M's Detection/GroundTruth."""
    out = []
    for dets, gts in spec:
        out.append((
            [M.Detection(np.asarray(d["box"], np.float32), d["label"],
                         d["score"], d.get("mask"), d.get("kpts"),
                         d.get("rbox")) for d in dets],
            [M.GroundTruth(np.asarray(g["box"], np.float32), g["label"],
                           g.get("mask"), g.get("kpts"), g.get("rbox"),
                           g.get("ignore", False)) for g in gts]))
    return out


def _disk(c, r, hw=(32, 32)):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return (xx - c[0]) ** 2 + (yy - c[1]) ** 2 < r ** 2


def _metric_cases():
    g3 = [dict(box=[20, 20, 10, 10], label=0),
          dict(box=[60, 40, 20, 16], label=1),
          dict(box=[30, 70, 12, 30], label=0)]
    perfect = [dict(g, score=0.9 - 0.1 * i) for i, g in enumerate(g3)]
    fp = perfect + [dict(box=[90, 90, 8, 8], label=0, score=0.95)]
    missed = perfect[:2]
    shifted = [dict(d, box=[d["box"][0] + 2, d["box"][1] - 1]
                    + d["box"][2:]) for d in perfect]
    confused = [dict(d, label=1 - d["label"]) for d in perfect]
    masks = [(
        [dict(box=[8, 8, 8, 8], label=0, score=0.9, mask=_disk((8, 8), 4)),
         dict(box=[24, 24, 8, 8], label=0, score=0.8,
              mask=_disk((22, 24), 4))],
        [dict(box=[8, 8, 8, 8], label=0, mask=_disk((8, 8), 4)),
         dict(box=[24, 24, 8, 8], label=0, mask=_disk((24, 24), 4))])]
    rng = np.random.default_rng(3)
    k17 = np.concatenate([rng.uniform(0, 50, (17, 2)),
                          (rng.uniform(0, 1, (17, 1)) > 0.2)], -1)
    k5 = np.concatenate([rng.uniform(0, 50, (5, 2)), np.ones((5, 1))], -1)
    oks = [(
        [dict(box=[25, 25, 40, 40], label=0, score=0.9,
              kpts=k17 + [1.5, -1.0, 0.0]),
         dict(box=[25, 25, 40, 40], label=0, score=0.7, kpts=k17 + 9.0)],
        [dict(box=[25, 25, 40, 40], label=0, kpts=k17)]),
        ([dict(box=[30, 30, 20, 20], label=1, score=0.8,
               kpts=k5 + [0.5, 0.5, 0.0])],
         [dict(box=[30, 30, 20, 20], label=1, kpts=k5)])]
    rb = [(
        [dict(box=[50, 50, 40, 10], label=0, score=0.9,
              rbox=[50, 50, 40, 10, 0.3]),
         dict(box=[20, 80, 30, 12], label=0, score=0.6,
              rbox=[22, 79, 30, 12, 1.2])],
        [dict(box=[50, 50, 40, 10], label=0, rbox=[51, 50, 40, 10, 0.35]),
         dict(box=[20, 80, 30, 12], label=0, rbox=[20, 80, 30, 12, -0.2])])]
    crowd = [(
        [dict(box=[20, 20, 10, 10], label=0, score=0.9),
         dict(box=[70, 70, 10, 10], label=0, score=0.85,
              mask=_disk((70, 70), 5, (100, 100))),
         dict(box=[72, 68, 6, 6], label=0, score=0.8),
         dict(box=[5, 90, 6, 6], label=0, score=0.7)],
        [dict(box=[20, 20, 10, 10], label=0),
         dict(box=[70, 70, 30, 30], label=0, ignore=True,
              mask=_disk((70, 70), 15, (100, 100)))])]
    return {
        "perfect": ([(perfect, g3)], {}),
        "false_positive": ([(fp, g3)], {}),
        "missed": ([(missed, g3)], {}),
        "localization": ([(shifted, g3)], {}),
        "class_confusion": ([(confused, g3)], {}),
        "mask": (masks, dict(use_mask=True)),
        "oks": (oks, dict(similarity="oks")),
        "rbox": (rb, dict(similarity="rbox")),
        "crowd_box": (crowd, {}),
        "crowd_mask": (crowd, dict(use_mask=True)),
        "empty_image": ([([], g3), (perfect, [])], {}),
    }


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_evaluate_constructed_equals_jax(case):
    spec, kw = _metric_cases()[case]
    j = jm.evaluate(_build(jm, spec), **kw)
    t = tm.evaluate(_build(tm, spec), **kw)
    _same(t, j)
    if case == "perfect":
        assert all(math.isclose(v, 1.0) for v in t.values()), t
    if case in ("false_positive", "missed", "localization"):
        assert 0.0 < t["mAP"] < 1.0
    if case == "class_confusion":
        assert t["mAP"] == 0.0


def _random_spec(seed, n_images=6, with_masks=True):
    rng = np.random.default_rng(seed)
    spec = []
    for _ in range(n_images):
        gts = []
        for _ in range(rng.integers(0, 5)):
            c = rng.uniform(10, 54, 2)
            r = rng.uniform(3, 10)
            gts.append(dict(box=[c[0], c[1], 2 * r, 2 * r],
                            label=int(rng.integers(0, 3)),
                            mask=_disk(c, r, (64, 64)) if with_masks
                            else None,
                            ignore=bool(rng.uniform() < 0.1)))
        dets = []
        for g in gts:
            if rng.uniform() < 0.8:
                j = rng.normal(0, 1.5, 2)
                b = g["box"]
                dets.append(dict(box=[b[0] + j[0], b[1] + j[1], b[2], b[3]],
                                 label=g["label"] if rng.uniform() < 0.9
                                 else int(rng.integers(0, 3)),
                                 score=float(rng.uniform(0.2, 1.0)),
                                 mask=_disk(b[:2] + j, b[2] / 2, (64, 64))
                                 if with_masks else None))
        for _ in range(rng.integers(0, 3)):
            c = rng.uniform(5, 59, 2)
            dets.append(dict(box=[c[0], c[1], 8, 8],
                             label=int(rng.integers(0, 3)),
                             score=float(rng.uniform(0.0, 1.0)),
                             mask=_disk(c, 4, (64, 64)) if with_masks
                             else None))
        spec.append((dets, gts))
    return spec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_seeded_equals_jax(seed):
    spec = _random_spec(seed)
    for kw in ({}, dict(use_mask=True),
               dict(iou_thresholds=(0.3, 0.5, 0.75))):
        _same(tm.evaluate(_build(tm, spec), **kw),
              jm.evaluate(_build(jm, spec), **kw))


def test_metric_helpers_equal_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        a = np.concatenate([rng.uniform(0, 50, 2), rng.uniform(0, 20, 2)])
        b = np.concatenate([rng.uniform(0, 50, 2), rng.uniform(0, 20, 2)])
        assert tm.box_iou_xywh(a, b) == jm.box_iou_xywh(a, b)
    m1, m2 = rng.uniform(0, 1, (2, 16, 16)) > 0.5
    assert tm.mask_iou(m1, m2) == jm.mask_iou(m1, m2)
    assert tm.mask_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 0.0
    for k in (17, 5):
        g = np.concatenate([rng.uniform(0, 40, (k, 2)),
                            rng.integers(0, 2, (k, 1))], -1)
        d = g + np.concatenate([rng.normal(0, 2, (k, 2)),
                                np.zeros((k, 1))], -1)
        assert tm.oks(d, g, 300.0) == jm.oks(d, g, 300.0)
    scores = rng.uniform(0, 1, 40)
    tps = rng.uniform(0, 1, 40) > 0.4
    assert tm.average_precision(scores, tps, 30) == \
        jm.average_precision(scores, tps, 30)
    assert math.isnan(tm.average_precision(scores, tps, 0))


@pytest.mark.parametrize("frame_hw,mode", [(None, "stretch"),
                                            ((48, 80), "stretch"),
                                            ((48, 80), "letterbox")])
def test_detections_from_slate_equals_jax(frame_hw, mode):
    rng = np.random.default_rng(9)
    B, D = 2, 6
    det = {"count": np.asarray([4, 0], np.int32),
           "boxes_xywh": rng.uniform(0, 64, (B, D, 4)).astype(np.float32),
           "labels": rng.integers(0, 3, (B, D)).astype(np.int32),
           "scores": rng.uniform(0, 1, (B, D)).astype(np.float32),
           "masks": rng.uniform(0, 1, (B, D, 16, 16)).astype(np.float32)}
    for i in range(B):
        kw = dict(frame_hw=frame_hw, input_size=(64, 64), resize_mode=mode)
        j = jm.detections_from_slate(det, i, **kw)
        t = tm.detections_from_slate(
            {k: torch.from_numpy(v) for k, v in det.items()}, i, **kw)
        assert len(t) == len(j) == int(det["count"][i])
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.box_xywh, b.box_xywh)
            assert (a.label, a.score) == (b.label, b.score)
            np.testing.assert_array_equal(a.mask, b.mask)


# ---------------------------------------------------------------------------
# MOT
# ---------------------------------------------------------------------------

def _mot_sequence(seed, n_frames=30, n_obj=4):
    """GT tracks moving linearly; predictions with jitter, drops, false
    positives and one identity swap halfway."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(20, 200, (n_obj, 2))
    vel = rng.uniform(-3, 3, (n_obj, 2))
    size = rng.uniform(15, 40, (n_obj, 2))
    gt, pred = [], []
    for f in range(n_frames):
        g, p = [], []
        for i in range(n_obj):
            c = start[i] + vel[i] * f
            box = np.concatenate([c, size[i]])
            g.append((i + 1, box))
            if rng.uniform() < 0.85:
                pid = 100 + i
                if f >= n_frames // 2 and i < 2:
                    pid = 101 - i            # ids 0 and 1 swap
                p.append((pid, box + np.concatenate(
                    [rng.normal(0, 2, 2), rng.normal(0, 1, 2)])))
        if rng.uniform() < 0.2:
            p.append((900 + f, np.asarray([5.0, 5.0, 10.0, 10.0])))
        gt.append(g)
        pred.append(p)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_mot_equals_jax(seed):
    gt, pred = _mot_sequence(seed)
    for thr in (0.3, 0.5):
        t = tmot.evaluate_mot(gt, pred, iou_threshold=thr)
        _same(t, jmot.evaluate_mot(gt, pred, iou_threshold=thr))
        assert t["id_switches"] > 0 and 0 < t["IDF1"] < 1
    perfect = tmot.evaluate_mot(gt, gt)
    assert perfect["MOTA"] == 1.0 and perfect["IDF1"] == 1.0
    with pytest.raises(ValueError):
        tmot.evaluate_mot(gt, pred[:-1])


def test_lsa_maximize_equals_scipy_and_jax():
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(2)
    for r, c in [(1, 1), (3, 5), (6, 4), (7, 7), (9, 3)]:
        s = rng.uniform(0, 1, (r, c))
        ri, ci = tmot._lsa_maximize(s)
        jr, jc = jmot._lsa_maximize(s)
        np.testing.assert_array_equal(ri, jr)
        np.testing.assert_array_equal(ci, jc)
        sr, sc = linear_sum_assignment(-s)
        assert len(ri) == min(r, c)
        assert math.isclose(s[ri, ci].sum(), s[sr, sc].sum(),
                            rel_tol=1e-12)
    assert tmot._hungarian_max(np.zeros((0, 0)), 0.5) == []


def test_track_sequence_equals_jax():
    """MultiTargetTracker (the port's perception/tracking.py) over noisy
    detections of crossing objects: the confirmed tracks per frame equal
    JAX's, and the result scores the same."""
    gt, pred = _mot_sequence(4, n_frames=25)
    dets = [[(0, b) for _, b in frame] for frame in pred]
    for kw in ({}, dict(motion=True)):
        t = tmot.track_sequence(dets, **kw)
        j = jmot.track_sequence(dets, **kw)
        assert len(t) == len(j) == len(dets)
        for ft, fj in zip(t, j):
            assert [i for i, _ in ft] == [i for i, _ in fj]
            for (_, a), (_, b) in zip(ft, fj):
                np.testing.assert_array_equal(a, b)
        assert sum(map(len, t)) > 0
        _same(tmot.evaluate_mot(gt, t), jmot.evaluate_mot(gt, j))


def test_motchallenge_loader_and_cli(tmp_path, monkeypatch, capsys):
    gt, pred = _mot_sequence(6, n_frames=12)

    def write(path, frames, conf):
        with open(path, "w") as f:
            for fi, frame in enumerate(frames):
                for tid, (cx, cy, w, h) in frame:
                    f.write(f"{fi + 1},{tid},{cx - w / 2:.3f},"
                            f"{cy - h / 2:.3f},{w:.3f},{h:.3f},{conf}\n")
            f.write("1,77,0,0,5,5,0\n")          # inactive GT row
            f.write("bad line\n")
    write(tmp_path / "gt.txt", gt, 1)
    write(tmp_path / "pred.txt", pred, 0.9)
    for name in ("gt.txt", "pred.txt"):
        t = tmot.load_motchallenge(str(tmp_path / name))
        j = jmot.load_motchallenge(str(tmp_path / name))
        assert len(t) == len(j) == 12
        for a, b in zip(t, j):
            assert [i for i, _ in a] == [i for i, _ in b]
            for (_, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)
    argv = ["mot", "--gt", str(tmp_path / "gt.txt"),
            "--pred", str(tmp_path / "pred.txt"), "--iou", "0.4"]
    outs = []
    for main in (tmot._main, jmot._main):
        monkeypatch.setattr(sys, "argv", argv)
        assert main() == 0
        outs.append(json.loads(capsys.readouterr().out.strip()))
    assert outs[0] == outs[1] and outs[0]["n_frames"] == 12


# ---------------------------------------------------------------------------
# dataset eval through both pipelines
# ---------------------------------------------------------------------------

def _capture(monkeypatch, owner):
    """Record every per_image list `owner.evaluate` is called with."""
    calls = []
    orig = owner.evaluate

    def wrapped(per_image, *a, **k):
        calls.append(per_image)
        return orig(per_image, *a, **k)
    monkeypatch.setattr(owner, "evaluate", wrapped)
    return calls


def _same_detections(t_images, j_images, masks: bool):
    n = 0
    for (td_, tg), (jd_, jg) in zip(t_images, j_images, strict=True):
        assert len(td_) == len(jd_) > 0
        n += len(td_)
        assert [d.label for d in td_] == [d.label for d in jd_]
        for a, b in zip(td_, jd_):
            np.testing.assert_allclose(a.box_xywh, b.box_xywh, atol=1e-2)
            assert abs(a.score - b.score) <= 1e-4
            for f in ("kpts", "box_xywhr"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_allclose(x, y, atol=1e-2)
            if masks:
                assert (a.mask != b.mask).mean() <= 0.01
        # the GT side: same boxes, labels, masks and ignore flags
        assert len(tg) == len(jg)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.box_xywh, b.box_xywh)
            assert (a.label, a.ignore) == (b.label, b.ignore)
            for f in ("mask", "kpts", "box_xywhr"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    return n


DATA_HW = (120, 136)
EVAL_CASES = {
    "segment": ("segment", {}),
    "detect": ("detect", {}),
    "segment_tta": ("segment", dict(tta=True)),
    "detect_wbf": ("detect", dict(merge="wbf")),
    "pose": ("pose", {}),
    "obb": ("obb", {}),
    "classify": ("classify", {}),
}


def _datasets(task, n=6):
    if task in ("segment", "detect"):
        return (jd.SyntheticShapesDataset(n=n, hw=DATA_HW),
                td.SyntheticShapesDataset(n=n, hw=DATA_HW))
    name = {"pose": "SyntheticPoseDataset", "obb": "SyntheticOBBDataset",
            "classify": "SyntheticClassifyDataset"}[task]
    return (getattr(jd, name)(n=n, hw=DATA_HW),
            getattr(td, name)(n=n, hw=DATA_HW))


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_dataset_eval_equals_jax(case, monkeypatch, tmp_path):
    """6 images in batches of 4 (the last batch padded) at 128x128 from
    120x136 frames; detecting_tree weights (every anchor detects class 0,
    so every image has detections and the class-0 GT is matched at
    AP50 > 0)."""
    task, kw = EVAL_CASES[case]
    size = (64, 64) if task == "classify" else (128, 128)
    mk = dict(EXACT, task=task, input_size=size, num_classes=3)
    if task == "pose":
        mk["kpt_shape"] = (5, 3)
    jcfg, tcfg = jconfig.ModelConfig(**mk), tconfig.ModelConfig(**mk)
    p = detecting_tree(jcfg)
    jds, tds = _datasets(task)
    common = dict(kw, batch=4, score_threshold=0.3, max_detections=100)
    dump = task in ("segment", "pose") and not kw
    jcalls = _capture(monkeypatch, jm)
    tcalls = _capture(monkeypatch, tde)
    if task in ("segment", "detect"):
        j = jde.evaluate_dataset(
            jcfg, p, jds, coco_dump=str(tmp_path / "j.json") if dump
            else None, **common)
        t = tde.evaluate_dataset(
            tcfg, params_from_jax(p, tcfg), tds, device="cpu",
            coco_dump=str(tmp_path / "t.json") if dump else None, **common)
    else:
        j = jde.evaluate_task_dataset(
            jcfg, p, jds, coco_dump=str(tmp_path / "j.json") if dump
            else None, **common)
        t = tde.evaluate_task_dataset(
            tcfg, params_from_jax(p, tcfg), tds, device="cpu",
            coco_dump=str(tmp_path / "t.json") if dump else None, **common)
    _same(t, j, tol=1e-4)
    assert t["n_images"] == 6
    if task == "classify":
        assert not tcalls and 0.0 <= t["top1_acc"] <= 1.0
        return
    assert len(tcalls) == len(jcalls) >= 1
    for tc, jc in zip(tcalls, jcalls):
        _same_detections(tc, jc, masks=task == "segment")
    key = {"pose": "oks_AP50", "obb": "rbox_AP50"}.get(task, "box_AP50")
    assert t[key] > 0.0, t
    if dump:
        _same_dump(tmp_path / "t.json", tmp_path / "j.json", t["dumped"])


def _same_dump(tp, jp, n):
    t, j = json.loads(tp.read_text()), json.loads(jp.read_text())
    assert len(t) == len(j) == n > 0
    for a, b in zip(t, j):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                      b["category_id"])
        assert abs(a["score"] - b["score"]) <= 2e-5
        for f in ("bbox", "keypoints"):
            if f in b:
                np.testing.assert_allclose(a[f], b[f], atol=0.02)
        if "segmentation" in b:
            ma = td.decode_coco_rle(a["segmentation"])
            mb = jd.decode_coco_rle(b["segmentation"])
            assert ma.shape == mb.shape
            assert (ma != mb).mean() <= 0.01


def _coco_from_synthetic(tmp_path, n=5):
    """A COCO instances JSON + PNGs written from SyntheticShapesDataset
    samples: sparse category ids, polygon segmentations, one iscrowd RLE
    region."""
    from PIL import Image
    ds = td.SyntheticShapesDataset(n=n, hw=DATA_HW)
    cat_ids = [3, 17, 90]
    H, W = DATA_HW
    images, anns = [], []
    for i in range(n):
        s = ds[i]
        Image.fromarray(s["image"]).save(tmp_path / f"{i}.png")
        images.append({"id": 100 + i, "file_name": f"{i}.png",
                       "height": H, "width": W})
        for b, lab, poly in zip(s["boxes"], s["labels"], s["polys"]):
            cx, cy, w, h = (float(v) for v in b * (W, H, W, H))
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": cat_ids[int(lab)], "iscrowd": 0,
                         "bbox": [cx - w / 2, cy - h / 2, w, h],
                         "segmentation": [(poly * (W, H)).ravel()
                                          .tolist()]})
    crowd = np.zeros(DATA_HW, bool)
    crowd[10:60, 20:90] = True
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": 3,
                 "iscrowd": 1, "bbox": [20, 10, 70, 50],
                 "segmentation": td.encode_coco_rle(crowd)})
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c, "name": f"c{c}"}
                                               for c in cat_ids]}))
    return str(path), str(tmp_path)


def test_coco_dataset_eval_and_dump_equal_jax(monkeypatch, tmp_path):
    """A CocoDataset through both pipelines: crowd regions ignore-matched,
    the dump's image and category ids mapped back to the annotation
    file's, rows equal to JAX's."""
    ann, imgs = _coco_from_synthetic(tmp_path)
    mk = dict(EXACT, task="segment", input_size=(128, 128), num_classes=3)
    jcfg, tcfg = jconfig.ModelConfig(**mk), tconfig.ModelConfig(**mk)
    p = detecting_tree(jcfg)
    jcalls = _capture(monkeypatch, jm)
    tcalls = _capture(monkeypatch, tde)
    common = dict(batch=4, score_threshold=0.3, max_detections=100)
    j = jde.evaluate_dataset(jcfg, p, jd.CocoDataset(ann, imgs),
                             coco_dump=str(tmp_path / "j.json"), **common)
    t = tde.evaluate_dataset(tcfg, params_from_jax(p, tcfg),
                             td.CocoDataset(ann, imgs), device="cpu",
                             coco_dump=str(tmp_path / "t.json"), **common)
    _same(t, j, tol=1e-4)
    for tc, jc in zip(tcalls, jcalls, strict=True):
        _same_detections(tc, jc, masks=True)
    assert any(g.ignore for g in tcalls[0][0][1])
    _same_dump(tmp_path / "t.json", tmp_path / "j.json", t["dumped"])
    rows = json.loads((tmp_path / "t.json").read_text())
    assert {r["image_id"] for r in rows} == set(range(100, 105))
    assert {r["category_id"] for r in rows} == {3}


def test_dataset_eval_refuses_tta_with_pipe():
    cfg = tconfig.ModelConfig(**EXACT, input_size=(64, 64))
    with pytest.raises(ValueError, match="tta=True has no effect"):
        tde.evaluate_dataset(cfg, None, [], pipe=object(), tta=True)
    with pytest.raises(ValueError, match="use evaluate_dataset"):
        tde.evaluate_task_dataset(cfg, None, [], device="cpu")


def test_eval_cli(monkeypatch, capsys, tmp_path):
    """python -m xrseg_tpu_torch.eval --data synthetic --device cpu: one
    JSON line; --device cuda raises without a card."""
    argv = ["xrseg_tpu_torch.eval", "--data", "synthetic", "--size", "64",
            "--classes", "3", "--batch", "4", "--max-images", "6",
            "--score", "0.001", "--dump", str(tmp_path / "d.json"),
            "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(SystemExit) as e:
        runpy.run_module("xrseg_tpu_torch.eval", run_name="__main__")
    assert e.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["n_images"] == 6 and out["n_gt"] > 0
    assert out["dumped"] == len(json.loads((tmp_path / "d.json")
                                           .read_text()))
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", argv[:-1] + ["cuda"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tde._main()


def test_eval_cli_refuses_sentis(monkeypatch, capsys, tmp_path):
    """The eval CLI on a .sentis file (a synthetic template of
    detecting_tree weights) prints the JSON line JAX's CLI prints on the
    same file: both ModelConfigs float32 "highest", each value within
    2e-4 (the line rounds to 4 places). The name is kept from when the
    port refused .sentis."""
    import functools

    from xrseg_tpu.models import yolo11 as jy
    from xrseg_tpu_torch.testing import sentis_template
    mk = dict(EXACT, input_size=(64, 64), num_classes=3)
    jcfg = jconfig.ModelConfig(**mk)
    path = str(tmp_path / "w.sentis")
    sentis_template(tconfig.ModelConfig(**mk), detecting_tree(jcfg, seed=3),
                    path)
    monkeypatch.setattr(tde, "ModelConfig", functools.partial(
        tconfig.ModelConfig, **EXACT))
    monkeypatch.setattr(jde, "ModelConfig", functools.partial(
        jconfig.ModelConfig, **EXACT))
    shapes = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                            jax.random.key(0))
    monkeypatch.setattr(jy, "init_params", lambda k, c: jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))  # all overwritten
    args = ["--data", "synthetic", "--weights", path, "--size", "64",
            "--classes", "3", "--batch", "4", "--max-images", "6",
            "--score", "0.3"]
    outs = []
    for main, extra in ((tde._main, ["--device", "cpu"]), (jde._main, [])):
        monkeypatch.setattr(sys, "argv", ["eval", *args, *extra])
        assert main() == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    t, j = outs
    _same(t, j, tol=2e-4)
    assert t["n_images"] == 6 and t["box_AP50"] > 0.0


# ---------------------------------------------------------------------------
# parity reports: the port's oracle against tests/torch_ref.py's
# ---------------------------------------------------------------------------

def _parity_images(n=2, hw=(72, 88)):
    rng = np.random.default_rng(12)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


PARITY_POST = dict(iou_threshold=0.6, score_threshold=0.3,
                   max_detections=20)


def test_parity_oracle_equals_torch_ref():
    """The port's oracle (float32 CPU forward of its own network, numpy
    NMS and mask synthesis) against the JAX package's torch
    re-implementation on the same weights and augmented images: counts
    and labels EQUAL, boxes 1e-3 px, scores 1e-5, cropped masks on 99%
    of their pixels."""
    mk = dict(EXACT, task="segment", input_size=(64, 64), num_classes=3)
    jcfg, tcfg = jconfig.ModelConfig(**mk), tconfig.ModelConfig(**mk)
    p = detecting_tree(jcfg)
    images = tpar.augment_images(_parity_images(), n_variants=4)
    assert len(images) == 10
    for a, b in zip(images, jpar.augment_images(_parity_images(),
                                                n_variants=4)):
        np.testing.assert_array_equal(a, b)
    j = jpar._oracle_detections(images, p, jcfg,
                                jconfig.PostprocessConfig(**PARITY_POST))
    t = tpar._oracle_detections(images, params_from_jax(p, tcfg), tcfg,
                                tconfig.PostprocessConfig(**PARITY_POST))
    for a_img, b_img in zip(t, j, strict=True):
        assert len(a_img) == len(b_img) > 0
        for a, b in zip(a_img, b_img):
            assert a.label == b.label
            np.testing.assert_allclose(a.box_xywh, b.box_xywh, atol=1e-3)
            assert (a.mask != b.mask).mean() <= 0.01


def test_parity_report_equals_jax():
    """parity_report: the deployed pipeline (here on the CPU in float32)
    against the oracle, both packages on the same weights: equal
    detection counts and the same AP agreement within 1e-3. (These
    weights' masks are mostly empty on both sides, which mask IoU scores
    as 0, so only the box agreement is anchored at 1.)"""
    mk = dict(EXACT, task="segment", input_size=(64, 64), num_classes=3)
    jcfg, tcfg = jconfig.ModelConfig(**mk), tconfig.ModelConfig(**mk)
    p = detecting_tree(jcfg)
    images = _parity_images(3)
    j = jpar.parity_report(images, p, jcfg,
                           jconfig.PostprocessConfig(**PARITY_POST))
    t = tpar.parity_report(images, params_from_jax(p, tcfg), tcfg,
                           tconfig.PostprocessConfig(**PARITY_POST),
                           device="cpu")
    assert t["n_detections_ours"] == t["n_detections_oracle"] > 0
    assert t["box_AP50"] >= 0.99
    _same(t, j, tol=1e-3)
    np.testing.assert_array_equal(
        tpar.crop_binary_mask(np.full((16, 16), 0.9), [32, 32, 16, 16],
                              (64, 64)),
        jpar.crop_binary_mask(np.full((16, 16), 0.9), [32, 32, 16, 16],
                              (64, 64)))


@pytest.mark.parametrize("task", ["pose", "obb", "classify"])
def test_task_parity_report_equals_jax(task):
    mk = dict(EXACT, task=task, input_size=(64, 64), num_classes=3)
    if task == "pose":
        mk["kpt_shape"] = (5, 3)
    jcfg, tcfg = jconfig.ModelConfig(**mk), tconfig.ModelConfig(**mk)
    p = detecting_tree(jcfg)
    images = _parity_images(2)
    j = jtpar.task_parity_report(task, images, p, jcfg,
                                 jconfig.PostprocessConfig(**PARITY_POST))
    t = ttpar.task_parity_report(task, images, params_from_jax(p, tcfg),
                                 tcfg,
                                 tconfig.PostprocessConfig(**PARITY_POST),
                                 device="cpu")
    _same(t, j, tol=1e-3)
    if task == "classify":
        assert t["top1_agreement"] == 1.0
        assert t["prob_max_abs_diff"] < 1e-4
    else:
        assert t["n_detections_ours"] == t["n_detections_oracle"] > 0
        assert t["oks_AP50" if task == "pose" else "rbox_AP50"] >= 0.99
