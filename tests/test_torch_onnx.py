"""The port's ONNX modules (xrseg_tpu_torch/io/onnx_export.py,
onnx_loader.py, onnx_exec.py) against the JAX package's, on the CPU.

- export_onnx of bridged weights writes a file BYTE-IDENTICAL to the JAX
  package's export of the same params, for every task and both archs;
- load_yolo11_onnx of a JAX-written file gives state-dict leaves EQUAL to
  the JAX loader's (through io/bridge.py);
- run_onnx agrees with the JAX interpreter within 1e-4 (absolute, on
  outputs of magnitude up to 64 px: the two run the convolutions in
  another summation order) on exported models, and with the foreign op
  vocabulary of tests/test_onnx_foreign.py;
- read_class_names round-trips the `names` metadata.
Weights are the JAX init's structure with seeded numpy leaves.
"""
import jax
import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.io import onnx_exec as jexec
from xrseg_tpu.io import onnx_export as jexport
from xrseg_tpu.io import onnx_loader as jloader
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import onnx_exec as texec
from xrseg_tpu_torch.io import onnx_export as texport
from xrseg_tpu_torch.io import onnx_loader as tloader
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import seeded_tree

limit_cpu_threads()

TOL = 1e-4
_REAL_INIT = jy.init_params


@pytest.fixture(autouse=True)
def cheap_jax_init(monkeypatch):
    """The JAX loader starts from init_params and overwrites every leaf an
    export carries; the init's structure with zero leaves stands in for
    the eager JAX init, which takes seconds."""
    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: _REAL_INIT(k, cfg),
                                jax.random.key(0))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    monkeypatch.setattr(jy, "init_params", init)


def _cfgs(**kw):
    m = dict(dict(scale="n", num_classes=4, input_size=(64, 64),
                  dtype="float32", matmul_precision="highest"), **kw)
    return jconfig.ModelConfig(**m), tconfig.ModelConfig(**m)


CASES = {"segment": dict(task="segment"), "detect": dict(task="detect"),
         "pose": dict(task="pose", kpt_shape=(5, 3)),
         "obb": dict(task="obb"), "classify": dict(task="classify"),
         "v8-segment": dict(arch="yolov8", task="segment"),
         "v8-classify": dict(arch="yolov8", task="classify"),
         "coco80": dict(task="detect", num_classes=80)}


def _export_both(case, tmp_path):
    jcfg, tcfg = _cfgs(**CASES[case])
    tree = seeded_tree(jcfg, seed=11)
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jexport.export_onnx(tree, jcfg, jpath)
    texport.export_onnx(params_from_jax(tree, tcfg), tcfg, tpath)
    return jcfg, tcfg, tree, jpath, tpath


@pytest.mark.parametrize("case", list(CASES))
def test_export_is_byte_identical_and_loads_as_jax(case, tmp_path):
    jcfg, tcfg, tree, jpath, tpath = _export_both(case, tmp_path)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jp, _ = jloader.load_yolo11_onnx(jpath, jcfg)
    tm, tc = tloader.load_yolo11_onnx(jpath, tcfg)
    assert tc == tcfg
    want = params_from_jax(jax.device_get(jp), tcfg).state_dict()
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and the load gives back the exported weights themselves
    src = params_from_jax(tree, tcfg).state_dict()
    for k in src:
        assert torch.equal(got[k], src[k]), k


def test_ordered_param_slots_match_jax():
    for case in CASES.values():
        for scale in ("n", "m"):
            jcfg, tcfg = _cfgs(scale=scale, **case)
            assert tloader.ordered_param_slots(tcfg) == \
                jy.ordered_param_slots(jcfg)


@pytest.mark.parametrize("case", ["segment", "pose", "obb", "classify"])
def test_run_onnx_matches_jax_and_the_forward(case, tmp_path):
    jcfg, tcfg, tree, jpath, _ = _export_both(case, tmp_path)
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32)
    j = jexec.run_onnx(jpath, {"images": x})
    t = texec.run_onnx(jpath, {"images": x}, device="cpu")
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), j[k], atol=TOL, rtol=0,
                                   err_msg=k)
    # the port's forward computes the same function (output0's layout is
    # [1, C, A]; classify's output0 is the prob row)
    model = params_from_jax(tree, tcfg)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 2, 3, 1))
    if case == "classify":
        np.testing.assert_allclose(t["output0"].numpy(),
                                   out["probs"].numpy(), atol=TOL, rtol=0)
    elif case == "segment":
        np.testing.assert_allclose(t["output1"].permute(0, 2, 3, 1).numpy(),
                                   out["protos"].numpy(), atol=TOL, rtol=0)
        got = t["output0"].permute(0, 2, 1).numpy()
        np.testing.assert_allclose(got[..., 4:], out["preds"][..., 4:],
                                   atol=TOL, rtol=0)


def test_foreign_op_vocabulary_matches_jax(tmp_path):
    """tests/test_onnx_foreign.py's graph: ops and attribute forms the
    exporter never emits."""
    from test_onnx_foreign import _write_model
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32)
    w = rng.normal(0, 0.1, (192, 4)).astype(np.float32)
    bias = rng.normal(0, 1, (4,)).astype(np.float32)
    g = jexport._G()
    two = g.init("two", np.asarray(2.0, np.float32))
    y = g.n("Div", ["images", two])
    y = g.n("Pow", [y, two])
    y = g.n("Clip", [y, g.init("lo", np.asarray(0.0, np.float32)),
                     g.init("hi", np.asarray(4.0, np.float32))])
    y = g.n("Exp", [g.n("Neg", [g.n("Sqrt", [y])])])
    y = g.n("Unsqueeze", [y, g.init("ax", np.asarray([0], np.int64))])
    g.n("Squeeze", [y], axes=[0], out_names=["out_chain"])
    sh = g.n("Shape", ["images"])
    h = g.n("Gather", [sh, g.init("i2", np.asarray(2, np.int64))])
    r = g.n("Range", [g.init("z", np.asarray(0, np.int64)), h,
                      g.init("one", np.asarray(1, np.int64))])
    g.n("Cast", [r], to=1, out_names=["out_range"])
    g.n("Slice", ["images", g.init("st", np.asarray([0, 2], np.int64)),
                  g.init("en", np.asarray([2, 7], np.int64)),
                  g.init("sax", np.asarray([2, 3], np.int64)),
                  g.init("sst", np.asarray([1, 2], np.int64))],
        out_names=["out_slice"])
    f = g.n("Flatten", ["images"], axis=1)
    g.n("Gemm", [f, g.init("w", w.T.copy()), g.init("b", bias)],
        alpha=1.0, beta=1.0, transB=1, out_names=["out_gemm"])
    g.n("ReduceMax", ["images"], axes=[2, 3], keepdims=1,
        out_names=["out_rmax"])
    g.n("ReduceMean", ["images", g.init("rax", np.asarray([1], np.int64))],
        keepdims=0, out_names=["out_rmean"])
    am = g.n("ArgMax", ["images"], axis=1, keepdims=0)
    g.n("Cast", [am], to=1, out_names=["out_argmax"])
    g.n("GlobalAveragePool", ["images"], out_names=["out_gap"])
    gt = g.n("Greater", ["images", g.init("zz", np.asarray(0.0, np.float32))])
    g.n("Where", [gt, "images", g.n("Neg", ["images"])],
        out_names=["out_abs"])
    g.n("LeakyRelu", ["images"], alpha=0.1, out_names=["out_lrelu"])
    g.n("Relu", [g.n("Cos", ["images"])], out_names=["out_relu_cos"])
    gap2 = g.n("GlobalAveragePool", ["images"])
    g.n("Expand", [gap2, g.init("esh", np.asarray([1, 3, 2, 2], np.int64))],
        out_names=["out_expand"])
    g.n("Add", ["images", g.n("Constant", [], value=np.asarray(
        [[[[1.5]], [[-2.0]], [[0.25]]]], np.float32))],
        out_names=["out_const"])
    outs = ["out_chain", "out_range", "out_slice", "out_gemm", "out_rmax",
            "out_rmean", "out_argmax", "out_gap", "out_abs", "out_lrelu",
            "out_relu_cos", "out_expand", "out_const"]
    path = _write_model(g, str(tmp_path / "foreign.onnx"),
                        [("images", (1, 3, 8, 8))], [(o, (1,)) for o in outs])
    j = jexec.run_onnx(path, {"images": x})
    t = texec.run_onnx(path, {"images": x}, device="cpu")
    for k in outs:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def test_read_class_names_round_trip(tmp_path):
    jcfg, tcfg = _cfgs(task="detect", num_classes=3)
    tree = seeded_tree(jcfg)
    path = str(tmp_path / "named.onnx")
    names = ["cat", "dog's toy", "bus"]
    texport.export_onnx(params_from_jax(tree, tcfg), tcfg, path,
                        class_names=names)
    assert tloader.read_class_names(path) == names
    assert tloader.read_class_names(tloader.parse_onnx(path)) == names
    assert jloader.read_class_names(path) == names
    texport.export_onnx(params_from_jax(tree, tcfg), tcfg, path)
    assert tloader.read_class_names(path) == [f"class_{i}" for i in range(3)]
    assert tloader.parse_onnx(path)["metadata"]["task"] == "detect"


def test_loader_rejections(tmp_path):
    jcfg, tcfg = _cfgs(task="detect")
    tree = seeded_tree(jcfg)
    path = str(tmp_path / "d.onnx")
    texport.export_onnx(params_from_jax(tree, tcfg), tcfg, path)
    wrong = tconfig.ModelConfig(scale="n", task="segment", num_classes=4,
                                input_size=(64, 64))
    with pytest.raises(ValueError, match="count mismatch"):
        tloader.load_yolo11_onnx(path, wrong)
    with pytest.raises(ValueError, match="shape mismatch"):
        tloader.load_yolo11_onnx(path, tconfig.ModelConfig(
            scale="n", task="detect", num_classes=5, input_size=(64, 64)))
    junk = tmp_path / "junk.onnx"
    junk.write_bytes(b"\x08\x07")
    with pytest.raises(ValueError, match="ModelProto"):
        tloader.parse_onnx(str(junk))
