"""The port's .sentis reader and writer (xrseg_tpu_torch/io/sentis.py)
against the JAX package's (xrseg_tpu/io/sentis.py), on the CPU.

No real artifact is needed: xrseg_tpu_torch.testing.sentis_template writes
a small file of seeded weights in the container both modules read, and
the JAX parser, loader and writer act as the oracle on the same bytes.

- the template parses with JAX's parse_sentis to the port's program,
  field for field, and holds what the template promises (one weighted op
  per slot, a zero point at the flatbuffer default, float32 and int32
  constants, the segment after the program);
- dequantized_constants and conv_sequence are bit-equal to JAX's;
- load_yolo11_params gives every state tensor bit-equal to JAX's tree
  (through io/bridge.py) for segment, detect, pose, obb, the YOLOv8 arch
  and an o2o model; a classify template is refused on both sides (its
  Gemm is not a weighted op of the format);
- build_pipeline on the loaded model gives JAX's slate at the .onnx
  route's tolerance (labels, valid, count, indices equal; boxes 1e-3 px,
  scores 1e-5);
- quantize_uint8 under minmax and mse, and write_yolo11_sentis under
  both, are bit- and byte-equal to JAX's, the zero-point-pinned tensor
  included; every writer and loader error is raised on both sides;
- `python -m xrseg_tpu_torch.io.sentis FILE` prints what JAX's prints.
JAX's loader starts from its eager init_params and overwrites every leaf
the file carries; a zero tree of the init's structure stands in for it.
"""
import contextlib
import dataclasses
import io
import runpy
import struct
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.io import sentis as js
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import sentis as ts
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax, state_dict_from_jax
from xrseg_tpu_torch.testing import limit_cpu_threads, sentis_template
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32", num_classes=4)
POST = dict(iou_threshold=0.6, score_threshold=0.3)
CASES = {"segment": {}, "detect": dict(task="detect"),
         "pose": dict(task="pose", kpt_shape=(5, 3)),
         "obb": dict(task="obb"), "v8-segment": dict(arch="yolov8"),
         "o2o": dict(o2o=True)}
_REAL_INIT = jy.init_params


@pytest.fixture(autouse=True)
def cheap_jax_init(monkeypatch):
    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: _REAL_INIT(k, cfg),
                                jax.random.key(0))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    monkeypatch.setattr(jy, "init_params", init)


def _cfgs(**kw):
    m = dict(MODEL, **kw)
    return jconfig.ModelConfig(**m), tconfig.ModelConfig(**m)


def _template(tmp_path, case="segment", seed=0, tree=None, **kw):
    """(jcfg, tcfg, the JAX tree, the port's model, the template path)."""
    jcfg, tcfg = _cfgs(**dict(CASES.get(case, {}), **kw))
    tree = detecting_tree(jcfg, seed=seed) if tree is None else tree
    model = params_from_jax(tree, tcfg)
    path = sentis_template(tcfg, model, str(tmp_path / f"{case}.sentis"),
                           seed=seed)
    return jcfg, tcfg, tree, model, path


def _same_program(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "values":
            assert len(x) == len(y)
            for (tx, px), (ty, py) in zip(x, y):
                assert tx == ty
                if tx == 6:
                    assert dataclasses.asdict(px) == dataclasses.asdict(py)
                else:
                    assert px == py and type(px) is type(py)
        elif f.name == "chains":
            assert [dataclasses.asdict(c) for c in x] == \
                [dataclasses.asdict(c) for c in y]
        else:
            assert x == y, f.name


def _same_state(model, jparams):
    want = state_dict_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_template_parses_to_the_same_program(case, tmp_path):
    jcfg, _, _, _, path = _template(tmp_path, case, seed=3)
    jprog, tprog = js.parse_sentis(path), ts.parse_sentis(path)
    _same_program(jprog, tprog)
    # what the template promises, read by the oracle
    seq = js.conv_sequence(jprog)
    assert len(seq) == len(jy.ordered_param_slots(jcfg))
    dq = [c for c in jprog.chains if c.op == "DequantizeUint8"]
    pinned = [c for c in dq if jprog.value_pos[c.args[1]] is None]
    assert len(pinned) == 1 and jprog.values[pinned[0].args[1]] == (2, 0)
    assert all(jprog.value_pos[c.args[0]] is not None for c in dq)
    dtypes = {jprog.tensor(i).dtype for i, (ty, p) in
              enumerate(jprog.values) if ty == 6 and p.const}
    assert dtypes == {0, 1, 3}
    bias = jprog.tensor(jprog.chains[seq[0]["chain"]].inputs[2])
    assert bias.const and bias.dtype == 0         # a float32 constant
    assert {"Sigmoid", "Concat", "Reshape"} <= {c.op for c in jprog.chains}
    data = open(path, "rb").read()
    fb_size = struct.unpack_from("<I", data)[0]
    assert jprog.segment_base == 4 + fb_size
    assert len(data) == jprog.segment_base + len(jprog.segment)


@pytest.mark.parametrize("case", ["segment", "pose"])
def test_constants_and_conv_sequence_bit_equal(case, tmp_path):
    _, _, _, _, path = _template(tmp_path, case, seed=4)
    jprog, tprog = js.parse_sentis(path), ts.parse_sentis(path)
    jc, tc = js.dequantized_constants(jprog), ts.dequantized_constants(tprog)
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert jc[k].dtype == tc[k].dtype == np.float32
        np.testing.assert_array_equal(jc[k], tc[k])
    jseq, tseq = js.conv_sequence(jprog), ts.conv_sequence(tprog)
    assert len(jseq) == len(tseq)
    for a, b in zip(jseq, tseq):
        assert (a["chain"], a["op"], a["args"]) == (b["chain"], b["op"],
                                                    b["args"])
        np.testing.assert_array_equal(a["w"], b["w"])
        assert (a["b"] is None) == (b["b"] is None)
        if a["b"] is not None:
            np.testing.assert_array_equal(a["b"], b["b"])


@pytest.mark.parametrize("case", list(CASES))
def test_load_is_bit_equal_to_jax(case, tmp_path):
    jcfg, tcfg, tree, _, path = _template(tmp_path, case, seed=5)
    jparams, jgot = js.load_yolo11_params(path, jcfg)
    model, got = ts.load_yolo11_params(path, tcfg)
    assert got is tcfg and jgot is jcfg
    _same_state(model, jparams)
    # the loaded weights are the model's within the quantization step
    src = params_from_jax(tree, tcfg).state_dict()
    for k, v in model.state_dict().items():
        a = src[k.replace("det_o2o.", "det.")]     # seeded from det
        step = (max(float(a.max()), 0.0) - min(float(a.min()), 0.0)) / 255
        assert float((v - a).abs().max()) <= 0.51 * step + 1e-7, k
    if case == "o2o":
        assert torch.equal(model.det_o2o.cv2[0].out.weight,
                           model.det.cv2[0].out.weight)


def test_classify_is_refused_on_both_sides(tmp_path):
    jcfg, tcfg = _cfgs(task="classify")
    model = params_from_jax(seeded_tree(jcfg, seed=6), tcfg)
    path = sentis_template(tcfg, model, str(tmp_path / "cls.sentis"))
    with pytest.raises(ValueError, match="weighted-op count mismatch") as je:
        js.load_yolo11_params(path, jcfg)
    with pytest.raises(ValueError, match="weighted-op count mismatch") as te:
        ts.load_yolo11_params(path, tcfg)
    assert str(je.value) == str(te.value)
    with pytest.raises(ValueError, match="template/model mismatch") as je:
        js.write_yolo11_sentis(str(tmp_path / "j.sentis"),
                               seeded_tree(jcfg), path, jcfg)
    with pytest.raises(ValueError, match="template/model mismatch") as te:
        ts.write_yolo11_sentis(str(tmp_path / "t.sentis"), model, path,
                               tcfg)
    assert str(je.value) == str(te.value)


def test_load_errors_on_both_sides(tmp_path):
    _, _, _, _, det = _template(tmp_path, "detect", seed=7)
    jseg, tseg = _cfgs()
    for load, cfg in ((js.load_yolo11_params, jseg),
                      (ts.load_yolo11_params, tseg)):
        with pytest.raises(ValueError, match="weighted-op count mismatch: "
                                             "file has 88, model"):
            load(det, cfg)
    _, _, _, _, seg = _template(tmp_path, "segment", seed=7)
    j5, t5 = _cfgs(num_classes=5)
    for load, cfg in ((js.load_yolo11_params, j5),
                      (ts.load_yolo11_params, t5)):
        with pytest.raises(ValueError, match=r"shape mismatch at \('det', "
                                             r"'cv3', 0, 'out'\)"):
            load(seg, cfg)


def test_load_params_auto_reads_sentis(tmp_path):
    jcfg, tcfg, _, _, path = _template(tmp_path, seed=8)
    model, cfg = tw.load_params_auto(path, tcfg)
    assert cfg is tcfg
    _same_state(model, js.load_yolo11_params(path, jcfg)[0])


def test_pipeline_slate_matches_jax(tmp_path):
    jcfg, tcfg, _, _, path = _template(tmp_path, seed=9)
    jparams, _ = js.load_yolo11_params(path, jcfg)
    model, _ = tw.load_params_auto(path, tcfg)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    j = jax.device_get(jcompile.build_pipeline(
        jconfig.ExecutorConfig(model=jcfg,
                               post=jconfig.PostprocessConfig(**POST)),
        jparams, frame_hw=(48, 64), batch=2)(jnp.asarray(frames)))
    t = tcompile.build_pipeline(
        tconfig.ExecutorConfig(model=tcfg,
                               post=tconfig.PostprocessConfig(**POST)),
        model, frame_hw=(48, 64), batch=2, device="cpu")(frames)
    assert int(t["count"].min()) == 50
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(t["boxes_xywh"].numpy(), j["boxes_xywh"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"].numpy(), j["scores"], atol=1e-5,
                               rtol=0)


def _arrays():
    rng = np.random.default_rng(10)
    tail = rng.standard_normal(4096).astype(np.float32) * 0.05
    tail[:3] = (4.0, -2.5, 3.0)                    # outliers
    return {"normal": rng.standard_normal((16, 8, 3, 3)).astype(np.float32),
            "positive": rng.random(64).astype(np.float32) * 3 + 0.1,
            "negative": -rng.random(64).astype(np.float32),
            "zeros": np.zeros(10, np.float32),
            "tail": tail,
            "tiny": (rng.standard_normal(32) * 1e-6).astype(np.float32)}


@pytest.mark.parametrize("method", ["minmax", "mse"])
def test_quantize_uint8_bit_equal(method):
    for name, w in _arrays().items():
        jq, jscale, jzp = js.quantize_uint8(w, method)
        tq, tscale, tzp = ts.quantize_uint8(w, method)
        assert jq.dtype == tq.dtype == np.uint8, name
        np.testing.assert_array_equal(jq, tq, err_msg=name)
        assert (jscale, jzp) == (tscale, tzp), name
        assert type(tscale) is type(jscale) and type(tzp) is type(jzp)
    for q in (js.quantize_uint8, ts.quantize_uint8):
        with pytest.raises(ValueError, match="unknown quantization method"):
            q(np.ones(3, np.float32), "bogus")


WRITES = [(c, "minmax") for c in CASES] + [("segment", "mse"),
                                           ("obb", "mse")]


@pytest.mark.parametrize("case,method", WRITES)
def test_writer_bytes_equal_jax(case, method, tmp_path):
    jcfg, tcfg, tree, model, path = _template(tmp_path, case, seed=12)
    # new weights: the template's model moved, so every payload changes
    new = jax.tree.map(lambda a: a * np.float32(1.01) + np.float32(1e-3),
                       tree)
    for d2 in new["det"]["cv2"]:               # the pinned bias stays >= 0
        d2["out"]["b"] = np.abs(d2["out"]["b"])
    out = {k: str(tmp_path / f"{k}.sentis") for k in ("j", "t", "tree")}
    js.write_yolo11_sentis(out["j"], new, path, jcfg, method)
    ts.write_yolo11_sentis(out["t"], params_from_jax(new, tcfg), path, tcfg,
                           method)
    ts.write_yolo11_sentis(out["tree"], new, path, tcfg, method)
    want = open(out["j"], "rb").read()
    assert open(out["t"], "rb").read() == want
    assert open(out["tree"], "rb").read() == want
    assert want != open(path, "rb").read()
    # only scale/zero-point scalars move inside the program region
    prog = js.parse_sentis(path)
    scalars = {p + i for p in prog.value_pos if p is not None
               for i in range(4)}
    orig = open(path, "rb").read()
    moved = {i for i in range(prog.segment_base) if orig[i] != want[i]}
    assert moved and moved <= scalars


def test_round_trip_and_pinned_zero_point(tmp_path):
    """The loaded model written back into its own template changes fewer
    than 64 program bytes, and reloads within half a step of every leaf
    (tests/test_sentis_loader.py's bound); the pinned-zero-point tensor
    is rewritten by the pinned path on both sides."""
    jcfg, tcfg, _, _, path = _template(tmp_path, seed=13)
    model, _ = ts.load_yolo11_params(path, tcfg)
    out, jout = str(tmp_path / "rt.sentis"), str(tmp_path / "jrt.sentis")
    ts.write_yolo11_sentis(out, model, path, tcfg)
    js.write_yolo11_sentis(jout, js.load_yolo11_params(path, jcfg)[0], path,
                           jcfg)
    orig, new = open(path, "rb").read(), open(out, "rb").read()
    assert new == open(jout, "rb").read() and len(new) == len(orig)
    fb_size = struct.unpack_from("<I", orig)[0]
    assert sum(a != b for a, b in zip(orig[:4 + fb_size],
                                      new[:4 + fb_size])) < 64
    back, _ = ts.load_yolo11_params(out, tcfg)
    want = model.state_dict()
    for k, v in back.state_dict().items():
        a = want[k]
        step = (float(a.max()) - float(a.min())) / 255.0
        assert float((v - a).abs().max()) <= 0.51 * step + 1e-7, k
    # the pinned tensor: its payload bytes changed only where requantizing
    # the dequantized values moves them, and its zero point stays 0
    prog = ts.parse_sentis(out)
    pinned = [c for c in prog.chains if c.op == "DequantizeUint8"
              and prog.value_pos[c.args[1]] is None]
    assert len(pinned) == 1 and prog.values[pinned[0].args[1]][1] == 0


def test_writer_errors_on_both_sides(tmp_path):
    jcfg, tcfg, tree, model, path = _template(tmp_path, seed=14)
    jdet, tdet = _cfgs(task="detect")

    def both(match, jargs, targs):
        with pytest.raises(ValueError, match=match) as je:
            js.write_yolo11_sentis(str(tmp_path / "j.sentis"), *jargs)
        with pytest.raises(ValueError, match=match) as te:
            ts.write_yolo11_sentis(str(tmp_path / "t.sentis"), *targs)
        assert str(je.value) == str(te.value)

    # a detect model into a segment template: the weighted ops' count
    dtree = seeded_tree(jdet, seed=1)
    both("template/model mismatch", (dtree, path, jdet),
         (params_from_jax(dtree, tdet), path, tdet))
    # five classes into a four-class template: a payload's size
    j5, t5 = _cfgs(num_classes=5)
    tree5 = detecting_tree(j5, seed=1)
    both("size mismatch at value", (tree5, path, j5),
         (params_from_jax(tree5, t5), path, t5))
    # negative values into the zero-point-pinned tensor: its range
    signed = seeded_tree(jcfg, seed=2)
    both(r"exceed the template's fixed zero-point \(0\) range",
         (signed, path, jcfg), (params_from_jax(signed, tcfg), path, tcfg))


def _run_main(module: str, path: str, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [module, path])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # already imported
        try:
            runpy.run_module(module, run_name="__main__")
        except SystemExit as e:
            assert not e.code
    return buf.getvalue()


def test_summarize_cli_prints_as_jax(tmp_path, monkeypatch):
    _, _, _, _, path = _template(tmp_path, "pose", seed=15)
    want = _run_main("xrseg_tpu.io.sentis", path, monkeypatch)
    got = _run_main("xrseg_tpu_torch.io.sentis", path, monkeypatch)
    assert got == want
    assert "97 weighted ops:" in got and got.startswith("sentis program v1")


def test_compile_cli_takes_sentis(tmp_path, capsys):
    """python -m xrseg_tpu_torch.compile w.sentis --out m.onnx: the ONNX
    file holds the weights load_params_auto reads from the .sentis."""
    _, tcfg, _, _, path = _template(tmp_path, seed=16)
    onnx = str(tmp_path / "m.onnx")
    assert tcompile._main([path, "--out", onnx, "--size", "64", "--classes",
                           "4", "--device", "cpu"]) == 0
    assert f"exported {path} -> {onnx}" in capsys.readouterr().out
    want, _ = tw.load_params_auto(path, tcfg)
    got, _ = tw.load_params_auto(onnx, tcfg)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
