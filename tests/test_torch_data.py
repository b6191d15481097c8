"""The port's dataset readers (xrseg_tpu_torch/train/data.py) against the
JAX package's train/data.py, on the CPU.

Every reader and synthetic dataset is held sample for sample EQUAL to
JAX's (every key, every array, bit for bit) on fixtures written into a
temporary directory: an ultralytics detect/segment directory (boxes,
polygons, a malformed line, an image without labels), a COCO instances
JSON (polygons, a multi-ring instance, a degenerate box, an iscrowd RLE
region in both counts forms), a COCO keypoints JSON (an unlabeled person
becomes an ignore region), ultralytics pose and OBB directories and an
image folder. Also: RLE both ways, letterbox_sample, rasterize_mask, and
the native 2-tap resize bit-equal to its numpy twin and to JAX's.
"""
import json

import numpy as np
import pytest
from PIL import Image

from xrseg_tpu.train import data as jd
from xrseg_tpu_torch.train import data as td
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()


def _same_sample(a, b):
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list):
            assert len(x) == len(y), k
            for u, v in zip(x, y):
                assert (u is None) == (v is None), k
                if u is not None:
                    np.testing.assert_array_equal(u, v, err_msg=k)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def _same_dataset(t, j):
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        _same_sample(t[i], j[i])


def _png(path, hw, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                    ).save(path)


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("SyntheticShapesDataset", dict(n=5, hw=(40, 56), n_classes=3,
                                    max_objects=4, seed=3)),
    ("SyntheticPoseDataset", dict(n=4, hw=(48, 48))),
    ("SyntheticOBBDataset", dict(n=4, hw=(64, 40), max_objects=3)),
    ("SyntheticClassifyDataset", dict(n=5, hw=(32, 32), n_classes=3)),
])
def test_synthetic_datasets_equal_jax(name, kw):
    t, j = getattr(td, name)(**kw), getattr(jd, name)(**kw)
    _same_dataset(t, j)
    _same_sample(t[len(t) + 1], j[1])          # indices wrap
    if name == "SyntheticPoseDataset":
        assert t.kpt_shape == j.kpt_shape == (5, 3)


# ---------------------------------------------------------------------------
# file datasets on tmp-dir fixtures
# ---------------------------------------------------------------------------

def test_yolo_dataset_equals_jax(tmp_path):
    root = tmp_path / "yolo"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    _png(root / "images" / "a.png", (30, 40), 0)
    _png(root / "images" / "b.png", (24, 24), 1)
    _png(root / "images" / "c.png", (20, 36), 2)      # no label file
    (root / "labels" / "a.txt").write_text(
        "0 0.5 0.5 0.2 0.3\n"
        "2 0.1 0.1 0.4 0.1 0.3 0.5 0.05 0.4\n"
        "1 0.5 0.5\n"                                  # malformed: skipped
        "\n")
    (root / "labels" / "b.txt").write_text("1 0.25 0.75 0.5 0.5\n")
    _same_dataset(td.YoloDataset(str(root)), jd.YoloDataset(str(root)))
    for name in ("a.txt", "b.txt", "missing.txt"):
        p = str(root / "labels" / name)
        t, j = td.parse_yolo_label_file(p), jd.parse_yolo_label_file(p)
        for x, y in zip(t[:2], j[:2]):
            np.testing.assert_array_equal(x, y)
        assert len(t[2]) == len(j[2])
    flat = tmp_path / "flat"
    flat.mkdir()
    _png(flat / "x.jpg", (16, 16), 3)
    (flat / "x.txt").write_text("0 0.5 0.5 1 1\n")
    _same_dataset(td.YoloDataset(str(flat)), jd.YoloDataset(str(flat)))
    with pytest.raises(FileNotFoundError):
        td.YoloDataset(str(tmp_path / "nothing"))


def _coco_fixture(tmp_path, keypoints=False):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir(exist_ok=True)
    _png(img_dir / "1.png", (40, 60), 0)
    _png(img_dir / "2.png", (32, 32), 1)
    crowd = np.zeros((40, 60), bool)
    crowd[5:20, 30:50] = True
    cats = [{"id": 18, "name": "dog"}, {"id": 1, "name": "person"},
            {"id": 3, "name": "car"}]
    if keypoints:
        cats = [{"id": 1, "name": "person",
                 "keypoints": [f"k{i}" for i in range(5)]}]
    anns = [
        {"id": 1, "image_id": 7, "category_id": 1, "iscrowd": 0,
         "bbox": [4, 6, 20, 12],
         "segmentation": [[4, 6, 24, 6, 24, 18, 4, 18],
                          [30, 2, 32, 2, 31, 3]],
         "keypoints": [10, 10, 2, 12, 11, 1, 0, 0, 0, 14, 9, 2, 8, 8, 1]},
        {"id": 2, "image_id": 7, "category_id": 1 if keypoints else 18,
         "iscrowd": 0, "bbox": [40, 20, 10, 15],
         "segmentation": [[40, 20, 50, 20, 45, 35]],
         "keypoints": [0] * 15},
        {"id": 3, "image_id": 7, "category_id": 1, "iscrowd": 0,
         "bbox": [1, 1, 0, 5], "keypoints": [0] * 15},    # degenerate
        {"id": 4, "image_id": 7, "category_id": 1, "iscrowd": 1,
         "bbox": [30, 5, 20, 15],
         "segmentation": td.encode_coco_rle(crowd)},
        {"id": 5, "image_id": 3, "category_id": 1 if keypoints else 3,
         "iscrowd": 1, "bbox": [2, 2, 8, 8],
         "segmentation": {"size": [32, 32],
                          "counts": [70, 8, 24, 8, 922]}},
        {"id": 6, "image_id": 3, "category_id": 1, "iscrowd": 0,
         "bbox": [10, 10, 12, 8],
         "keypoints": [12, 12, 2, 0, 0, 0, 15, 14, 2, 16, 16, 1,
                       20, 11, 2]},
    ]
    coco = {"images": [{"id": 7, "file_name": "1.png", "height": 40,
                        "width": 60},
                       {"id": 3, "file_name": "2.png", "height": 32,
                        "width": 32}],
            "annotations": anns, "categories": cats}
    path = tmp_path / ("kp.json" if keypoints else "inst.json")
    path.write_text(json.dumps(coco))
    return str(path), str(img_dir)


def test_coco_dataset_equals_jax(tmp_path):
    ann, imgs = _coco_fixture(tmp_path)
    t, j = td.CocoDataset(ann, imgs), jd.CocoDataset(ann, imgs)
    _same_dataset(t, j)
    assert (t.cat_ids, t.class_names, t.cat_index) == \
        (j.cat_ids, j.class_names, j.cat_index)
    assert [t.image_id(i) for i in range(2)] == [3, 7]
    s = t[1]
    assert len(s["ignore_boxes"]) == 1 and s["ignore_masks"][0].sum() == \
        15 * 20


def test_coco_pose_dataset_equals_jax(tmp_path):
    ann, imgs = _coco_fixture(tmp_path, keypoints=True)
    t, j = td.CocoPoseDataset(ann, imgs), jd.CocoPoseDataset(ann, imgs)
    _same_dataset(t, j)
    assert t.kpt_shape == j.kpt_shape == (5, 3)
    # the unlabeled person (no visible keypoint) is an ignore region
    assert len(t[1]["labels"]) == 1 and len(t[1]["ignore_boxes"]) == 2


def test_yolo_pose_obb_and_image_folder_equal_jax(tmp_path):
    pose = tmp_path / "pose"
    (pose / "images").mkdir(parents=True)
    (pose / "labels").mkdir()
    _png(pose / "images" / "p.png", (20, 30), 4)
    rng = np.random.default_rng(0)
    k3 = " ".join(f"{v:.4f}" for v in np.concatenate(
        [rng.uniform(0, 1, (5, 2)), rng.integers(0, 3, (5, 1))], -1).ravel())
    (pose / "labels" / "p.txt").write_text(
        f"0 0.5 0.5 0.4 0.6 {k3}\n0 0.1 0.1\n")
    _same_dataset(td.YoloPoseDataset(str(pose), (5, 3)),
                  jd.YoloPoseDataset(str(pose), (5, 3)))
    k2 = " ".join(f"{v:.4f}" for v in rng.uniform(0, 1, 10))
    (pose / "labels" / "q.txt").write_text(f"1 0.5 0.5 0.2 0.2 {k2}\n")
    for kshape in ((5, 2), (5, 3)):
        p = str(pose / "labels" / ("q.txt" if kshape[1] == 2 else "p.txt"))
        for x, y in zip(td.parse_yolo_pose_label_file(p, kshape),
                        jd.parse_yolo_pose_label_file(p, kshape)):
            np.testing.assert_array_equal(x, y)

    obb = tmp_path / "obb"
    (obb / "images").mkdir(parents=True)
    (obb / "labels").mkdir()
    _png(obb / "images" / "o.png", (30, 50), 5)
    (obb / "labels" / "o.txt").write_text(
        "1 0.1 0.1 0.5 0.2 0.45 0.5 0.05 0.4\n"
        "0 0.9 0.5 0.9 0.9 0.5 0.9 0.5 0.5\n"
        "0 0.2 0.2\n")
    _same_dataset(td.YoloOBBDataset(str(obb)), jd.YoloOBBDataset(str(obb)))
    p = str(obb / "labels" / "o.txt")
    for x, y in zip(td.parse_yolo_obb_label_file(p, (30, 50)),
                    jd.parse_yolo_obb_label_file(p, (30, 50))):
        np.testing.assert_array_equal(x, y)

    folder = tmp_path / "cls"
    for c, n in (("cat", 2), ("ant", 1)):
        (folder / c).mkdir(parents=True)
        for i in range(n):
            _png(folder / c / f"{i}.png", (12, 12), 10 + i)
    t, j = td.ImageFolderDataset(str(folder)), \
        jd.ImageFolderDataset(str(folder))
    _same_dataset(t, j)
    assert t.classes == j.classes == ["ant", "cat"]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(7, 9), (32, 48), (1, 1)])
def test_coco_rle_both_ways(hw):
    rng = np.random.default_rng(hw[0])
    for p in (0.0, 0.3, 0.9, 1.0):
        m = rng.uniform(0, 1, hw) < p
        r = td.encode_coco_rle(m)
        assert r == jd.encode_coco_rle(m)
        np.testing.assert_array_equal(td.decode_coco_rle(r), m)
        np.testing.assert_array_equal(td.decode_coco_rle(r),
                                      jd.decode_coco_rle(r))
        r_bytes = dict(r, counts=r["counts"].encode())
        np.testing.assert_array_equal(td.decode_coco_rle(r_bytes), m)


def test_letterbox_sample_equals_jax():
    for hw, out in (((40, 56), (64, 64)), ((64, 30), (48, 80))):
        s = jd.SyntheticShapesDataset(n=2, hw=hw)[1]
        s["polys"].append(None)
        s["boxes"] = np.concatenate([s["boxes"], [[0.5, 0.5, 0.1, 0.1]]]
                                    ).astype(np.float32)
        _same_sample(td.letterbox_sample(s, out), jd.letterbox_sample(s, out))


def test_rasterize_mask_equals_jax():
    """Polygon fill (PIL, lazily imported as in JAX) on the synthetic
    16-gons and on seeded concave polygons, and the box fallback."""
    ds = td.SyntheticShapesDataset(n=4, hw=(160, 160), max_objects=3)
    rng = np.random.default_rng(8)
    polys = [p for i in range(4) for p in ds[i]["polys"]]
    for _ in range(6):
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        rad = rng.uniform(0.1, 0.45, 9)
        polys.append(np.stack([0.5 + rad * np.cos(ang),
                               0.5 + rad * np.sin(ang)], -1
                              ).astype(np.float32))
    box = np.asarray([0.4, 0.55, 0.3, 0.25], np.float32)
    for mhw in ((40, 40), (160, 160), (32, 48)):
        for p in polys + [None, polys[0][:2]]:
            a = td.rasterize_mask(p, box, mhw)
            np.testing.assert_array_equal(a, jd.rasterize_mask(p, box, mhw))
            assert a.shape == mhw and a.dtype == np.float32 and a.sum() > 0


@pytest.mark.parametrize("src,dst", [((37, 53), (64, 64)),
                                     ((480, 640), (160, 160)),
                                     ((64, 64), (31, 97)),
                                     ((97, 143), (200, 100))])
def test_resize_uint8_native_equals_numpy_and_jax(src, dst):
    """The port's native resize is bit-equal to its numpy twin and to the
    JAX package's _resize_uint8 (the same C++). JAX's numpy twin takes the
    sample positions in float64, so it is held as JAX's own test holds
    it: at most 1 off, on under 0.1% of the values."""
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,),
                                                 dtype=np.uint8)
    native = td._resize_uint8(img, dst)
    np.testing.assert_array_equal(native, td._resize2tap_numpy(img, dst))
    np.testing.assert_array_equal(native, jd._resize_uint8(img, dst))
    diff = np.abs(native.astype(int) - jd._resize2tap_numpy(img, dst))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    assert td._resize_uint8(img, src) is img


def test_tap_indices_float64_unchanged():
    """The device preprocess's plan (float64 positions) is the JAX
    package's."""
    from xrseg_tpu.ops.preprocess import _tap_indices as jtaps
    from xrseg_tpu_torch.ops.preprocess import _tap_indices as ttaps
    for src, dst in ((37, 64), (640, 160), (64, 97)):
        for a, b in zip(ttaps(src, dst), jtaps(src, dst)):
            np.testing.assert_array_equal(a, b)
