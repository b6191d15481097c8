"""The training half of the port's data module (xrseg_tpu_torch/train/
data.py: augmentations, collates, the Loader) against the JAX package's
xrseg_tpu/train/data.py, on the CPU.

Both are numpy on the host, and both reach the same C++ resize and HSV
kernels (native/src, each package's own build), so every output is held
EQUAL, array for array and dtype for dtype, on seeded samples: each
augmentation, augment_sample/augment_task_sample under several recipes,
every collate, and the Loader's host batches for two epochs (with scale
buckets, drop_last=False padding and each task's path). Then the port's
own Loader contract: torch tensors equal to the host batches, and the
prefetch thread's abandoned-generator, slow-consumer and dataset-error
cases as tests/test_data.py holds JAX's.
"""
import threading
import time

import numpy as np
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JCfg
from xrseg_tpu.train import data as JD
from xrseg_tpu_torch.config import ModelConfig as TCfg
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import data as TD

limit_cpu_threads()


def _same(a, b, path="") -> None:
    """Equal structure, dtypes and values (None where both are None)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                            b.dtype)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


def _samples(hw=(48, 64), n=4, seed=0, polys=True):
    ds = TD.SyntheticShapesDataset(n=n, hw=hw, seed=seed)
    out = [ds[i] for i in range(n)]
    if not polys:                           # detect-format labels
        out = [dict(s, polys=[None] * len(s["labels"])) for s in out]
    return out


def _pair(fn_name, *args, seed=0, **kw):
    """The same call on both packages, each with its own seeded rng when
    the function takes one."""
    outs = []
    for mod in (JD, TD):
        a = [np.random.default_rng(seed) if isinstance(x, str)
             and x == "rng" else x for x in args]
        outs.append(getattr(mod, fn_name)(*a, **kw))
    return outs


AUG_CASES = {
    "hflip": lambda s: _pair("hflip_sample", s[0]),
    "hsv": lambda s: _pair("hsv_jitter", s[0]["image"], "rng"),
    "hsv_numpy": lambda s: _pair("_hsv_jitter_numpy", s[0]["image"],
                                 np.asarray([1.013, 0.55, 1.32])),
    "scale_translate": lambda s: _pair("scale_translate", s[1], "rng"),
    "mosaic4": lambda s: _pair("mosaic4", s, "rng", (64, 64)),
    "copy_paste": lambda s: _pair("copy_paste", s[0], s[1], "rng", p=1.0),
    "mixup2": lambda s: _pair("mixup2", s[0], s[1], "rng"),
    "letterbox": lambda s: _pair("letterbox_sample", s[2], (64, 64)),
}


@pytest.mark.parametrize("name", list(AUG_CASES))
def test_augmentation_bit_equal(name):
    want, got = AUG_CASES[name](_samples())
    _same(want, got, name)


@pytest.mark.parametrize("name", ["pose", "obb"])
def test_task_flips_bit_equal(name):
    if name == "pose":
        ds = TD.SyntheticPoseDataset(n=2, hw=(48, 64))
        s = ds[1]
        s["kpts"][0, 2, 2] = 0.0                      # an invisible slot
        want, got = _pair("hflip_pose_sample", s,
                          flip_idx=(0, 4, 3, 2, 1))
    else:
        s = TD.SyntheticOBBDataset(n=2, hw=(48, 64), max_objects=3)[1]
        want, got = _pair("hflip_obb_sample", s)
    _same(want, got, name)


RECIPES = {
    "default": {},
    "mixup_copy_paste": {"mixup": 0.7, "copy_paste": 0.6},
    "letterbox_no_mosaic": {"letterbox": True, "mosaic": 0.0, "hflip": 1.0},
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_augment_sample_bit_equal(recipe):
    ds = TD.SyntheticShapesDataset(n=6, hw=(40, 56), seed=2)
    kw = RECIPES[recipe]
    for i in range(len(ds)):
        want = JD.augment_sample(ds.__getitem__, i,
                                 np.random.default_rng((3, 1, i)), (64, 64),
                                 JD.AugmentConfig(**kw), len(ds))
        got = TD.augment_sample(ds.__getitem__, i,
                                np.random.default_rng((3, 1, i)), (64, 64),
                                TD.AugmentConfig(**kw), len(ds))
        _same(want, got, f"{recipe}/{i}")


@pytest.mark.parametrize("task", ["pose", "obb", "classify"])
def test_augment_task_sample_bit_equal(task):
    ds = {"pose": TD.SyntheticPoseDataset(n=5, hw=(48, 64)),
          "obb": TD.SyntheticOBBDataset(n=5, hw=(48, 64)),
          "classify": TD.SyntheticClassifyDataset(n=5, hw=(48, 64))}[task]
    mix = 0.0 if task == "classify" else 0.6
    for i in range(len(ds)):
        args = (ds.__getitem__, i)
        want = JD.augment_task_sample(
            *args, np.random.default_rng((1, 0, i)), (64, 64),
            JD.AugmentConfig(mixup=mix), task, (0, 4, 3, 2, 1), len(ds))
        got = TD.augment_task_sample(
            *args, np.random.default_rng((1, 0, i)), (64, 64),
            TD.AugmentConfig(mixup=mix), task, (0, 4, 3, 2, 1), len(ds))
        _same(want, got, f"{task}/{i}")
    with pytest.raises(ValueError, match="mixup"):
        TD.augment_task_sample(ds.__getitem__, 0, np.random.default_rng(0),
                               (64, 64), TD.AugmentConfig(mixup=0.5),
                               "classify")


def test_collates_bit_equal():
    seg = _samples(polys=True) + _samples(polys=False, seed=1)
    for task in ("segment", "detect"):
        jc, tc = JCfg(input_size=(64, 64), task=task), TCfg(
            input_size=(64, 64), task=task)
        _same(JD.collate(seg, jc, max_gt=2, input_hw=(32, 64)),
              TD.collate(seg, tc, max_gt=2, input_hw=(32, 64)), task)
    pose = [TD.SyntheticPoseDataset(n=3, hw=(48, 64))[i] for i in range(3)]
    _same(*_pair("collate_pose", pose, (64, 64), max_gt=2), "pose")
    obb = [TD.SyntheticOBBDataset(n=3, hw=(48, 64))[i] for i in range(3)]
    _same(*_pair("collate_obb", obb, (64, 96), max_gt=2), "obb")
    cls = [TD.SyntheticClassifyDataset(n=3, hw=(48, 64))[i]
           for i in range(3)]
    _same(*_pair("collate_classify", cls, (32, 32)), "classify")


LOADERS = {
    "segment_scales": dict(task="segment", n=10, batch=4,
                           scales=[(32, 32), (64, 96)],
                           aug=dict(mixup=0.5, copy_paste=0.5)),
    "detect_drop_last": dict(task="detect", n=7, batch=4, drop_last=False,
                             aug=dict(mosaic=0.5)),
    "pose": dict(task="pose", n=6, batch=3, aug=dict(mixup=0.5),
                 kpt_flip_idx=(0, 4, 3, 2, 1)),
    "obb": dict(task="obb", n=6, batch=4, drop_last=False),
    "classify": dict(task="classify", n=5, batch=2, drop_last=False),
}


def _datasets(task, n):
    return {"pose": TD.SyntheticPoseDataset(n=n, hw=(48, 64)),
            "obb": TD.SyntheticOBBDataset(n=n, hw=(48, 64)),
            "classify": TD.SyntheticClassifyDataset(n=n, hw=(48, 64))
            }.get(task, TD.SyntheticShapesDataset(n=n, hw=(48, 64)))


def _loaders(name, **extra):
    kw = dict(LOADERS[name])
    task, n, aug = kw.pop("task"), kw.pop("n"), kw.pop("aug", {})
    ds = _datasets(task, n)
    cfg = dict(input_size=(64, 64), task=task, num_classes=3,
               kpt_shape=(5, 3))
    common = dict(max_gt=3, seed=5, **kw)
    return (JD.Loader(ds, JCfg(**cfg), aug=JD.AugmentConfig(**aug),
                      **common),
            TD.Loader(ds, TCfg(**cfg), aug=TD.AugmentConfig(**aug),
                      device="cpu", **common, **extra))


@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_host_batches_bit_equal(name):
    """Two epochs of host batches, EQUAL to the JAX Loader's."""
    jl, tl = _loaders(name)
    assert jl.steps_per_epoch() == tl.steps_per_epoch()
    for epoch in (0, 1):
        want = list(jl._host_batches(epoch))
        got = list(tl._host_batches(epoch))
        assert len(want) == len(got) == tl.steps_per_epoch()
        _same(want, got, f"{name}/epoch {epoch}")


def test_loader_epoch_yields_tensors_of_the_host_batches():
    _, tl = _loaders("segment_scales")
    host = list(tl._host_batches(1))
    got = list(tl.epoch(1))
    assert len(got) == len(host)
    for h, g in zip(host, got):
        assert set(h) == set(g)
        for k, v in h.items():
            assert g[k].device.type == "cpu"
            assert torch.equal(g[k], torch.from_numpy(v)), k


def test_loader_abandoned_generator_cleans_up():
    """Breaking out of an epoch must not leak a blocked producer thread."""
    ds = TD.SyntheticShapesDataset(n=16, hw=(48, 48))
    ld = TD.Loader(ds, TCfg(input_size=(64, 64)), batch=4, max_gt=4,
                   seed=0, prefetch=1, device="cpu")
    before = threading.active_count()
    for _ in range(3):
        gen = ld.epoch(0)
        next(gen)          # take one batch, abandon the rest
        gen.close()        # triggers the generator's finally
    assert threading.active_count() <= before + 1


def test_loader_slow_consumer_terminates():
    """With a consumer slower than the producer the queue is full when the
    producer finishes; the end-of-epoch sentinel must still arrive."""
    ds = TD.SyntheticShapesDataset(n=8, hw=(32, 32))
    ld = TD.Loader(ds, TCfg(input_size=(32, 32)), batch=4, max_gt=4,
                   seed=0, prefetch=1, device="cpu")
    done = []

    def consume():
        n = 0
        for _ in ld.epoch(0):
            time.sleep(0.3)
            n += 1
        done.append(n)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and done == [2], done


def test_loader_propagates_dataset_errors():
    class BadDataset:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise RuntimeError("corrupt sample")

    ld = TD.Loader(BadDataset(), TCfg(input_size=(32, 32)), batch=4,
                   max_gt=2, aug=TD.AugmentConfig(mosaic=0.0), device="cpu")
    with pytest.raises(RuntimeError, match="corrupt sample"):
        for _ in ld.epoch(0):
            pass


@pytest.mark.parametrize("case", ["bad_scale", "mesh", "cuda"])
def test_loader_refusals(case, monkeypatch):
    ds = TD.SyntheticShapesDataset(n=4, hw=(48, 48))
    cfg = TCfg(input_size=(64, 64))
    if case == "bad_scale":
        with pytest.raises(ValueError):
            TD.Loader(ds, cfg, batch=2, scales=[(50, 64)], device="cpu")
    elif case == "mesh":
        from xrseg_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
        with pytest.raises(ValueError, match="not divisible by the mesh"):
            TD.Loader(ds, cfg, batch=3, mesh=mesh, device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.Loader(ds, cfg, batch=2)
