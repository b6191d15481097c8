"""The port's head-surgery transfer and model summary
(xrseg_tpu_torch/io/weights.transfer_params, models/yolo11.model_info)
against the JAX package's (xrseg_tpu/io/weights.transfer_params,
tests/test_weights.py:102-167), on the CPU at 64x64.

For each case the reports are EQUAL (copied count, reinit and dropped
lists), every copied leaf of the port's model equals JAX's output leaf
bit for bit, the rescued class convs carry the same prior bias, and every
reinitialised leaf has JAX's shape (the two RNGs differ). JAX's transfer
calls its init_params, whose eager init takes seconds; the init's
structure with seeded numpy leaves stands in for it.
"""
import jax
import numpy as np
import pytest
import torch

from xrseg_tpu.config import ModelConfig as JCfg
from xrseg_tpu.io import weights as JW
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch.config import ModelConfig as TCfg
from xrseg_tpu_torch.io import weights as TW
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import init_params, model_info, yolo11
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

BASE = dict(scale="n", input_size=(64, 64), dtype="float32")
_REAL_INIT = jy.init_params


def _seeded(jcfg, seed):
    shapes = jax.eval_shape(lambda k: _REAL_INIT(k, jcfg), jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 0.2, a.shape).astype(
        np.float32), shapes)


@pytest.fixture(scope="module")
def donor():
    """A seeded 80-class YOLO11n-seg pytree (the deployed model's head)."""
    return _seeded(JCfg(**BASE), seed=1)


@pytest.fixture
def cheap_jax_init(monkeypatch):
    monkeypatch.setattr(jy, "init_params",
                        lambda key, cfg: _seeded(cfg, seed=2))


CASES = {
    "class_surgery": dict(num_classes=3),
    "segment_to_pose": dict(task="pose", num_classes=1),
    "detect_graft": dict(task="detect"),
    "o2o_seeded": dict(num_classes=3, o2o=True),
}


def _both(donor, case):
    kw = {**BASE, **CASES[case]}
    jp, jrep = JW.transfer_params(donor, JCfg(**kw), key=jax.random.key(7))
    model, trep = TW.transfer_params(donor, TCfg(**kw),
                                     torch.Generator().manual_seed(7))
    return (JW.flatten_params(jax.device_get(jp)), jrep,
            TW.flatten_params(TW.params_to_tree(model)), trep, model)


@pytest.mark.parametrize("case", list(CASES))
def test_transfer_matches_jax(donor, case, cheap_jax_init):
    jflat, jrep, tflat, trep, model = _both(donor, case)
    assert trep == jrep
    assert set(tflat) == set(jflat)
    reinit = set(jrep["reinit"])
    for k, want in jflat.items():
        assert tflat[k].shape == np.shape(want), k
        if k not in reinit and not k.startswith("det_o2o/"):
            np.testing.assert_array_equal(tflat[k], np.asarray(want),
                                          err_msg=k)
    if case in ("class_surgery", "o2o_seeded"):
        # nc 80 -> 3 changes c3 (80 -> 64 at scale n): the donor's hidden
        # stack is kept at its width, only the class conv is fresh, with
        # the YOLO prior bias
        assert jrep["reinit"] == [f"det/cv3/{i}/out/{w}" for i in range(3)
                                  for w in "bw"]
        for i, stride in enumerate((8, 16, 32)):
            b = tflat[f"det/cv3/{i}/out/b"]
            np.testing.assert_array_equal(b, np.asarray(
                jflat[f"det/cv3/{i}/out/b"]))
            np.testing.assert_allclose(b, np.log(5 / 3 / (640 / stride) ** 2),
                                       rtol=1e-6)
            np.testing.assert_array_equal(
                tflat[f"det/cv3/{i}/pw1/w"], donor["det"]["cv3"][i]["pw1"]["w"])
    if case == "o2o_seeded":
        # the one-to-one branch is seeded from the post-surgery det
        for k in tflat:
            if k.startswith("det_o2o/"):
                np.testing.assert_array_equal(
                    tflat[k], tflat["det/" + k[len("det_o2o/"):]])
    if case == "segment_to_pose":
        assert any(k.startswith("proto/") for k in trep["dropped"])
        assert any(k.startswith("pose_cv4/") for k in trep["reinit"])
    if case == "detect_graft":
        assert trep["reinit"] == []
    assert TW.params_match_config(TW.params_to_tree(model), model.cfg)


def test_transferred_model_runs_and_round_trips(donor, tmp_path):
    """The grafted model (class branches at the donor's width) runs at the
    new class count, and its npz loads back strictly (the bridge sizes the
    class branches to the file), from a module, a tree or a flat dict."""
    cfg3 = TCfg(**BASE, num_classes=3)
    model, rep = TW.transfer_params(donor, cfg3)
    assert model.det.cv3[0].pw1.weight.shape[0] == 80      # the donor's c3
    assert yolo11.Spec(cfg3).c3 == 64
    out = model(torch.zeros((1, 64, 64, 3)), concat_preds=True)
    assert out["preds"].shape == (1, cfg3.num_anchors, 4 + 3 + 32)
    path = str(tmp_path / "t.npz")
    TW.save_npz(path, model)
    back = TW.load_npz(path, cfg3)
    for a, b in zip(model.parameters(), back.parameters()):
        assert torch.equal(a, b)
    # every donor form gives the same graft; a CPU model for another
    # config keeps the weights
    g = lambda: torch.Generator().manual_seed(0)    # noqa: E731
    m_mod, r_mod = TW.transfer_params(params_from_jax(donor, TCfg(**BASE)),
                                      cfg3, g())
    m_flat, r_flat = TW.transfer_params(TW.flatten_params(donor), cfg3, g())
    m_tree, r_tree = TW.transfer_params(donor, cfg3, g())
    assert r_mod == r_flat == r_tree == rep
    for a, b, c in zip(m_mod.parameters(), m_flat.parameters(),
                       m_tree.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c)
    wide = TW.with_config(model, TCfg(**{**BASE, "input_size": (96, 96)},
                                      num_classes=3))
    assert wide.cfg.input_size == (96, 96)
    for a, b in zip(model.parameters(), wide.parameters()):
        assert torch.equal(a, b)


def test_load_for_config(donor, tmp_path, monkeypatch):
    """The training scripts' --weights: an 80-class npz under a 3-class
    config is read as a tree and transferred (load_npz would refuse it); a
    fitting npz loads as it is. An .onnx or .pt is retried under the donor
    config only for the loaders' head-mismatch ValueError, as the JAX
    scripts do: any other load error propagates from the first attempt."""
    path = str(tmp_path / "donor.npz")
    np.savez(path, **TW.flatten_params(donor))
    cfg80 = TCfg(**BASE)
    cfg3 = TCfg(**BASE, num_classes=3)
    with pytest.raises(RuntimeError):
        TW.load_npz(path, cfg3)
    model, cfg, rep = TW.load_for_config(path, cfg3, cfg80)
    assert cfg == cfg3 and rep["copied"] > 0 and model.cfg == cfg3
    model80, cfg80, rep80 = TW.load_for_config(path, cfg80, cfg80)
    assert rep80 is None
    ref = params_from_jax(donor, TCfg(**BASE))
    for a, b in zip(model80.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    calls = []

    def broken(p, c):
        calls.append(c)
        raise KeyError("state dict is missing 'model.0.conv.weight'")

    monkeypatch.setattr(TW, "load_params_auto", broken)
    with pytest.raises(KeyError, match="model.0.conv.weight"):
        TW.load_for_config(str(tmp_path / "donor.pt"), cfg3, cfg80)
    assert calls == [cfg3]


def test_model_info(monkeypatch):
    """The JAX test's numbers (tests/test_model_vs_torch.py:121): 2,868,648
    parameters at scale n; gflops from the flop counter at 64x64 within the
    JAX test's loose bound; the other keys as JAX's. Without a card the
    default device raises."""
    cfg = TCfg(scale="n", input_size=(64, 64), dtype="float32")
    info = model_info(cfg, device="cpu")
    assert info["params"] == 2_868_648
    assert jy.count_params(_seeded(JCfg(**BASE), 0)) == info["params"]
    assert info["anchors"] == cfg.num_anchors == 84
    assert info["params_m"] == 2.869
    assert (info["scale"], info["task"], info["input_size"]) == \
        ("n", "segment", (64, 64))
    assert 0.01 < info["gflops"] < 5.0
    model = init_params(torch.Generator().manual_seed(1), cfg)
    assert model_info(cfg, model, device="cpu") == info
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_info(cfg, model)
