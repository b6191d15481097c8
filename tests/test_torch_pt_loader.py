"""The port's ultralytics .pt importer (xrseg_tpu_torch/io/torch_pt.py)
against the JAX package's (xrseg_tpu/io/torch_pt.py), on the same files.

The files are made as tests/test_pt_loader.py makes them: the JAX
package's params (here the init's structure with seeded numpy leaves)
inverted into an un-fused
ultralytics-style state dict (random BN statistics, the weight divided
out) or its fused form, written with torch.save. Each package then loads
the file; the JAX params go through io/bridge.py, and the two state dicts
must be EQUAL leaf for leaf (both fuse in numpy float32). The inferred
configs must agree, and every rejection of the JAX loader must raise in
the port too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.io import torch_pt as jpt
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import torch_pt as tpt
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from test_pt_loader import make_state_dict

limit_cpu_threads()

EPS = tpt.ULTRALYTICS_BN_EPS


_REAL_INIT = jy.init_params


def _shapes(jcfg):
    return jax.eval_shape(lambda k: _REAL_INIT(k, jcfg), jax.random.key(0))


@pytest.fixture(autouse=True)
def cheap_jax_init(monkeypatch):
    """The JAX loader starts from init_params and overwrites every leaf it
    maps; the init's structure with zero leaves stands in for the eager
    JAX init, which takes seconds."""
    monkeypatch.setattr(jy, "init_params", lambda key, cfg: jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), _shapes(cfg)))


def _cfgs(**kw):
    m = dict(dict(scale="n", num_classes=5, input_size=(64, 64)), **kw)
    return jconfig.ModelConfig(**m), tconfig.ModelConfig(**m)


def _tree(jcfg, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 0.5, a.shape).astype(
        np.float32), _shapes(jcfg))


def _write(tmp_path, jcfg, name="sd.pt", fused=False, wrap=None, seed=7):
    sd = make_state_dict(_tree(jcfg), jcfg, np.random.default_rng(seed),
                         fused=fused)
    if wrap is not None:
        sd = wrap(sd)
    p = str(tmp_path / name)
    torch.save(sd, p)
    return p


def _assert_same_load(path, jcfg=None, tcfg=None):
    jp, jc = jpt.load_yolo11_pt(path, jcfg)
    tm, tc = tpt.load_yolo11_pt(path, tcfg)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want = params_from_jax(jax.device_get(jp), tc).state_dict()
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    return tm, tc


CASES = [("yolo11", "segment"), ("yolo11", "pose"), ("yolo11", "obb"),
         ("yolo11", "classify"), ("yolo11", "detect"),
         ("yolov8", "segment"), ("yolov8", "classify"), ("yolov8", "obb")]


@pytest.mark.parametrize("arch,task", CASES)
@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_pt_load_equals_jax(arch, task, fused, tmp_path):
    jcfg, _ = _cfgs(arch=arch, task=task)
    path = _write(tmp_path, jcfg, fused=fused)
    _, tc = _assert_same_load(path)           # the config is inferred
    assert (tc.arch, tc.scale, tc.task, tc.num_classes) == (arch, "n", task,
                                                            5)


@pytest.mark.parametrize("arch,scale", [("yolo11", "l"), ("yolov8", "m")])
def test_pt_deep_scales_equal_jax(arch, scale, tmp_path):
    jcfg, _ = _cfgs(arch=arch, scale=scale, task="detect")
    _, tc = _assert_same_load(_write(tmp_path, jcfg))
    assert (tc.arch, tc.scale) == (arch, scale)


def test_pt_prefixes_and_wrappers(tmp_path):
    jcfg, tcfg = _cfgs(task="detect", num_classes=3)
    for i, wrap in enumerate((
            lambda sd: {"model": {f"model.model.{k}": v
                                  for k, v in sd.items()}},
            lambda sd: {"state_dict": {f"module.{k}": v
                                       for k, v in sd.items()}},
            lambda sd: {"ema": sd, "epoch": 3})):
        _assert_same_load(_write(tmp_path, jcfg, f"w{i}.pt", wrap=wrap))


def test_pt_given_config_and_o2o(tmp_path):
    """A given config is used as it is; with o2o the one-to-one branch is
    seeded from the detect head, as the JAX loader seeds it."""
    jcfg, tcfg = _cfgs(task="segment", o2o=True)
    tm, _ = _assert_same_load(_write(tmp_path, jcfg), jcfg, tcfg)
    sd = tm.state_dict()
    assert torch.equal(sd["det_o2o.cv3.0.out.weight"],
                       sd["det.cv3.0.out.weight"])


def test_infer_pt_config_agrees(tmp_path):
    for kw in (dict(task="pose", kpt_shape=(5, 2)),
               dict(task="segment", num_masks=16),
               dict(arch="yolov8", task="detect", scale="s")):
        jcfg, tcfg = _cfgs(**kw)
        sd = make_state_dict(_tree(jcfg), jcfg, np.random.default_rng(0))
        base_j = jconfig.ModelConfig(input_size=(96, 96), dtype="float32")
        base_t = tconfig.ModelConfig(input_size=(96, 96), dtype="float32")
        jc = jpt.infer_pt_config(jpt.normalize_state_dict(sd), base_j)
        tc = tpt.infer_pt_config(tpt.normalize_state_dict(sd), base_t)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_fuse_matches_torch_oracle():
    from torch.nn.utils.fusion import fuse_conv_bn_weights
    rng = np.random.default_rng(0)
    for O, I, k in [(8, 4, 3), (16, 1, 3), (32, 16, 1)]:
        w = rng.normal(0, 1, (O, I, k, k)).astype(np.float32)
        gamma = rng.uniform(0.2, 2.0, O).astype(np.float32)
        beta = rng.normal(0, 1, O).astype(np.float32)
        mean = rng.normal(0, 1, O).astype(np.float32)
        var = rng.uniform(0.1, 2.0, O).astype(np.float32)
        wf, bf = tpt.fuse_conv_bn(w, gamma, beta, mean, var, EPS)
        ow, ob = fuse_conv_bn_weights(
            torch.from_numpy(w), None, torch.from_numpy(mean),
            torch.from_numpy(var), EPS, torch.from_numpy(gamma),
            torch.from_numpy(beta))
        np.testing.assert_allclose(wf, ow.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(bf, ob.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        jw, jb = jpt.fuse_conv_bn(w, gamma, beta, mean, var, EPS)
        np.testing.assert_array_equal(wf, jw)
        np.testing.assert_array_equal(bf, jb)


def _small_sd():
    jcfg, tcfg = _cfgs(task="detect", num_classes=3)
    return (make_state_dict(_tree(jcfg), jcfg, np.random.default_rng(0)),
            jcfg, tcfg)


def _both_raise(exc, match, jfn, tfn):
    with pytest.raises(exc, match=match) as je:
        jfn()
    with pytest.raises(exc, match=match) as te:
        tfn()
    assert str(te.value) == str(je.value)


def test_rejections_match_jax(tmp_path):
    sd, jcfg, tcfg = _small_sd()
    rogue = dict(sd, **{"99.rogue.weight": torch.zeros(1)})
    _both_raise(ValueError, "unconsumed",
                lambda: jpt.load_from_state_dict(rogue, jcfg),
                lambda: tpt.load_from_state_dict(rogue, tcfg))
    missing = {k: v for k, v in sd.items() if k != "0.conv.weight"}
    _both_raise(KeyError, "missing",
                lambda: jpt.load_from_state_dict(missing, jcfg),
                lambda: tpt.load_from_state_dict(missing, tcfg))
    with pytest.raises((KeyError, ValueError)):
        tpt.load_from_state_dict(sd, dataclasses.replace(tcfg,
                                                         arch="yolov8"))
    junk = str(tmp_path / "junk.pt")
    torch.save({"epoch": 3, "notes": "hi"}, junk)
    _both_raise(ValueError, "state dict", lambda: jpt.load_yolo11_pt(junk),
                lambda: tpt.load_yolo11_pt(junk))
    _both_raise(ValueError, "did not load as a dict",
                lambda: jpt.normalize_state_dict([1, 2]),
                lambda: tpt.normalize_state_dict([1, 2]))
    _both_raise(ValueError, "layer-indexed",
                lambda: jpt.normalize_state_dict({"a.b": torch.zeros(1)}),
                lambda: tpt.normalize_state_dict({"a.b": torch.zeros(1)}))
    bad_dfl = dict(sd, **{"23.dfl.conv.weight": torch.ones(1, 16, 1, 1)})
    _both_raise(ValueError, "DFL",
                lambda: jpt.load_from_state_dict(bad_dfl, jcfg),
                lambda: tpt.load_from_state_dict(bad_dfl, tcfg))
    pickled = str(tmp_path / "module.pt")
    torch.save(torch.nn.Linear(2, 2), pickled)
    with pytest.raises(ValueError, match="weights_only"):
        tpt.load_yolo11_pt(pickled)
    fused = make_state_dict(_tree(jcfg), jcfg, np.random.default_rng(0),
                            fused=True)
    fused.update({"0.conv.weight": torch.zeros(32, 3, 3, 3),
                  "0.conv.bias": torch.zeros(32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tpt.load_from_state_dict(fused, tcfg)
