"""The port's accuracy A/B tools (xrseg_tpu_torch/tools/{ab_o2o,
ab_letterbox,ab_active,ab_distill}.py) against the JAX package's tools/
run in this process at --size 64, with --device cpu on the port's side.

(a) Training is stubbed on both sides: Trainer.fit builds the state and
    records one epoch without a step, and ab_distill's train and distill
    steps return the state as it is with a loss of 1. The weights come
    from the same `torch_parity` trees on both sides (io/bridge carries
    them across): the inits (init_params, behind Trainer and
    init_train_state) and the donor grafts (transfer_params) are patched
    to return them, so no JAX init runs. Every printed JSON row, the
    pseudo-label counts, ab_distill's step lines and the --out JSON then
    equal the JAX tool's: the keys exactly, the numbers within 1e-6. The
    JAX side's build_pipeline is memoized per config in this file (the
    jitted program takes the weights as an argument, so a pipeline of the
    same config with other weights gives what a new one would); each
    JAX tool runs once per module.
(b) One short real-training run of each port tool: finite losses and
    complete keys; ab_active and ab_distill (c) graft a
    `testing.sentis_template` donor, ab_active's found under
    XRSEG_REFERENCE.
(d) ab_active and ab_distill refuse to run without a donor.
Plus the two repairs the port needed: Trainer trains from another
Trainer's (frozen) eval_params, and io/weights.with_config gives an o2o
checkpoint's classic deploy.
"""
import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import xrseg_tpu
import xrseg_tpu.compile as jcompile
import xrseg_tpu.config as jconfig
import xrseg_tpu.io.weights as jweights
import xrseg_tpu.train.distill as jdistill
import xrseg_tpu.train.train_step as jts
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.train.trainer import Trainer as JTrainer
import xrseg_tpu_torch.io.weights as tweights
import xrseg_tpu_torch.train.distill as tdistill
import xrseg_tpu_torch.train.train_step as tts
from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.testing import limit_cpu_threads, sentis_template
from xrseg_tpu_torch.tools import ab_active, ab_distill, ab_letterbox, ab_o2o
from xrseg_tpu_torch.tools._donor import REF_SENTIS
from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_parity import detecting_tree

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
SIZE = 64
CPU = ["--device", "cpu"]
TOL = 1e-6
REPORT = {"copied": 1, "reinit": [], "dropped": []}

ARGS = {
    "ab_o2o": ["--size", "64", "--weights", "none", "--n-train", "4",
               "--n-val", "4", "--batch", "2", "--epochs", "1"],
    "ab_letterbox": ["--size", "64", "--weights", "none", "--n-train", "4",
                     "--n-val", "4", "--batch", "2", "--epochs", "1"],
    "ab_active": ["--size", "64", "--n-train", "8", "--n-val", "4",
                  "--seed-set", "2", "--budget", "3", "--batch", "2",
                  "--epochs", "1", "--seed-epochs", "1"],
    "ab_distill": ["--size", "64", "--n-train", "4", "--n-val", "4",
                   "--batch", "2", "--steps", "2", "--teacher-epochs", "1",
                   "--label-fraction", "0.5", "--pseudo-arm"],
}
PORT = {"ab_o2o": ab_o2o, "ab_letterbox": ab_letterbox,
        "ab_active": ab_active, "ab_distill": ab_distill}
DONOR_TOOLS = ("ab_active", "ab_distill")


def _key(cfg):
    return (cfg.arch, cfg.num_classes, bool(cfg.o2o))


def _jcfg(arch="yolo11", nc=3, o2o=False):
    return jconfig.ModelConfig(arch=arch, scale="n", input_size=(SIZE, SIZE),
                               num_classes=nc, dtype="float32", o2o=o2o)


@pytest.fixture(scope="module")
def trees():
    """One tree per network the tools build, every anchor firing: the
    3-class segmenter (seed model, teacher, letterbox arms), the o2o
    model (its one-to-one head a copy of the patched detect head) and the
    YOLOv8 student."""
    out = {}
    for jc, seed in ((_jcfg(), 0), (_jcfg(o2o=True), 0),
                     (_jcfg(arch="yolov8"), 1)):
        t = detecting_tree(jc, seed=seed)
        if jc.o2o:
            t["det_o2o"] = copy.deepcopy(t["det"])
        out[_key(jc)] = t
    return out


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """An 80-class npz both packages' load_params_auto read."""
    path = tmp_path_factory.mktemp("donor") / "donor80.npz"
    cfg = ModelConfig(input_size=(SIZE, SIZE), num_classes=80,
                      dtype="float32")
    tweights.save_npz(str(path),
                      ty.init_params(torch.Generator().manual_seed(0), cfg))
    return str(path)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _fit_stub(self, dataset, val_dataset=None, resume=False, epochs=None,
              verbose=True):
    """fit() without a step: the state (and its EMA) as _init_state makes
    it, one history row."""
    if self.state is None:
        self._init_state(1, False)
    self.history.append({"epoch": len(self.history), "loss": 1.0})
    return self.history


def _memoized(build):
    """The JAX build_pipeline, compiled once per config: the jitted
    program takes the weights as its argument."""
    cache = {}

    def build_pipeline(cfg, params, **kw):
        key = repr((cfg, sorted(kw.items())))
        if key not in cache:
            cache[key] = build(cfg, params, **kw)
        return dataclasses.replace(cache[key], params=params)
    return build_pipeline


def _identity_step(*_args, **_kw):
    def step(state, *rest):
        return state, {"loss": np.float32(1.0)}
    return step


@pytest.fixture(scope="module")
def jax_runs(trees, donor, tmp_path_factory):
    """Each JAX tool's stdout and --out JSON, training stubbed."""
    out_dir = tmp_path_factory.mktemp("jax_out")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xrseg_tpu, "enable_compile_cache", lambda: None)
        mp.setattr(jy, "init_params", lambda key, cfg: trees[_key(cfg)])
        mp.setattr(jweights, "transfer_params",
                   lambda donor, cfg, key=None: (trees[_key(cfg)], REPORT))
        mp.setattr(JTrainer, "fit", _fit_stub)
        mp.setattr(jts, "make_train_step", _identity_step)
        mp.setattr(jdistill, "make_distill_step", _identity_step)
        mp.setattr(jcompile, "build_pipeline",
                   _memoized(jcompile.build_pipeline))
        for name, args in ARGS.items():
            out = str(out_dir / f"{name}.json")
            argv = [*args, "--out", out]
            if name in DONOR_TOOLS:
                argv += ["--weights", donor]
            mp.setattr("sys.argv", [f"{name}.py", *argv])
            text = _stdout(_jax_script(name).main)
            runs[name] = (text, out)
    return runs


@pytest.fixture
def port_stubs(monkeypatch, trees):
    monkeypatch.setattr(
        ty, "init_params",
        lambda gen, cfg: params_from_jax(trees[_key(cfg)], cfg))
    monkeypatch.setattr(
        tweights, "transfer_params",
        lambda donor, cfg, gen=None: (
            params_from_jax(trees[_key(cfg)], cfg), REPORT))
    monkeypatch.setattr(Trainer, "fit", _fit_stub)
    monkeypatch.setattr(tts, "make_train_step", _identity_step)
    monkeypatch.setattr(tdistill, "make_distill_step", _identity_step)


def _rows(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _same(got, want, where="") -> None:
    """Equal keys at every level; numbers within TOL; the rest equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), \
            (where, list(got), list(want))
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert type(got) is type(want), (where, got, want)
        assert abs(got - want) <= TOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


# lines that are not JSON but carry the run's numbers
_COUNTED = re.compile(r"^(pool \d+:|pseudo-labeled|label fraction|"
                      r"\w+ step +\d+ loss|trained \w+: final loss|"
                      r"source frames)")


@pytest.mark.parametrize("name", list(ARGS))
def test_tool_equals_the_jax_tool(name, jax_runs, port_stubs, donor,
                                  tmp_path):
    want_text, want_out = jax_runs[name]
    out = str(tmp_path / f"{name}.json")
    argv = [*ARGS[name], "--out", out, *CPU]
    if name in DONOR_TOOLS:
        argv += ["--weights", donor]
    got_text = _stdout(PORT[name].main, argv)
    got, want = _rows(got_text), _rows(want_text)
    assert [r["config"] for r in got] == [r["config"] for r in want]
    _same(got, want, name)
    assert [ln for ln in got_text.splitlines() if _COUNTED.match(ln)] == \
        [ln for ln in want_text.splitlines() if _COUNTED.match(ln)]
    with open(out) as f, open(want_out) as g:
        _same(json.load(f), json.load(g), f"{name} --out")
    if name == "ab_o2o":
        with np.load(out + ".student.npz") as a, \
                np.load(want_out + ".student.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if name == "ab_active":
        proto = json.load(open(out))["protocol"]
        assert proto["pool"] == 6 and proto["budget"] == 3
        assert 0 <= proto["random_active_overlap"] <= 3


def test_the_comparison_sees_detections(jax_runs):
    """The trees fire: the A/B rows compare real mAP, not only zeros."""
    rows = _rows(jax_runs["ab_o2o"][0]) + _rows(jax_runs["ab_active"][0])
    assert any(r["box_mAP"] > 0 for r in rows)
    assert re.search(r"pool 6: [1-9]\d* pseudo detections",
                     jax_runs["ab_active"][0])


def _step_losses(text: str) -> list:
    """ab_distill's `<arm> step <i> loss <x>` lines."""
    return [float(m) for m in re.findall(r" step +\d+ loss (\S+)", text)]


@pytest.fixture(scope="module")
def sentis_donor(tmp_path_factory):
    """A .sentis of an 80-class model laid out as the reference project
    ships it (XRSEG_REFERENCE's root)."""
    root = tmp_path_factory.mktemp("reference")
    path = root / REF_SENTIS
    path.parent.mkdir(parents=True)
    cfg = ModelConfig(input_size=(SIZE, SIZE), num_classes=80,
                      dtype="float32")
    sentis_template(cfg, ty.init_params(torch.Generator().manual_seed(3),
                                        cfg), str(path))
    return root


@pytest.mark.parametrize("name", list(ARGS))
def test_tool_trains(name, sentis_donor, tmp_path, monkeypatch):
    """A short real run: finite losses, every row's keys; the donor tools
    graft the .sentis template (ab_active finds it under XRSEG_REFERENCE,
    ab_distill is given it)."""
    monkeypatch.delenv("XRSEG_REFERENCE", raising=False)
    argv = [*ARGS[name], *CPU, "--out", str(tmp_path / "out.json")]
    if name == "ab_active":
        monkeypatch.setenv("XRSEG_REFERENCE", str(sentis_donor))
    elif name == "ab_distill":
        argv += ["--weights", str(sentis_donor / REF_SENTIS),
                 "--pure-arm", "--combo-arm"]
    losses = []                      # every epoch's mean loss of every fit
    real_fit = Trainer.fit

    def fit(self, *a, **kw):
        history = real_fit(self, *a, **kw)
        losses.extend(row["loss"] for row in history)
        return history
    monkeypatch.setattr(Trainer, "fit", fit)
    before = threading.active_count()
    text = _stdout(PORT[name].main, argv)
    assert threading.active_count() <= before     # no Loader left running
    losses += _step_losses(text)
    assert losses and all(math.isfinite(v) for v in losses), losses
    rows = _rows(text)
    keys = {"box_mAP", "box_AP50", "box_AP75", "n_images", "n_gt"}
    for r in rows:
        assert keys <= set(r), r
        assert all(math.isfinite(v) for v in r.values()
                   if isinstance(v, (int, float))), r
    configs = [r["config"] for r in rows]
    if name == "ab_o2o":
        assert configs == ["o2o_nms_free@0.05", "o2o_nms_free@0.005",
                           "classic_nms@0.05", "classic_nms@0.005"]
        loaded = tweights.load_npz(str(tmp_path / "out.json.student.npz"),
                                   ModelConfig(input_size=(SIZE, SIZE),
                                               num_classes=3, o2o=True,
                                               dtype="float32"))
        assert loaded.cfg.o2o
    elif name == "ab_letterbox":
        assert configs == [f"train_{t}__deploy_{d}"
                           for t in ("stretch", "letterbox")
                           for d in ("stretch", "letterbox")]
    elif name == "ab_active":
        assert "graft: " in text
        assert configs == ["seed_model", "random_k_only", "active_k_only",
                           "pseudo_only", "random_k_mix", "active_k_mix",
                           "full_gt"]
        assert all({"n_train_images", "epochs"} <= set(r)
                   for r in rows[1:])
    else:
        assert configs == ["teacher", "student_scratch", "student_distill",
                           "student_pure", "student_pseudo",
                           "student_combo"]
    with open(tmp_path / "out.json") as f:
        assert json.load(f)


@pytest.mark.parametrize("name", DONOR_TOOLS)
def test_donor_tools_refuse_without_a_donor(name, tmp_path, monkeypatch):
    monkeypatch.delenv("XRSEG_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError, match="--weights"):
        PORT[name].main(["--size", "64", *CPU])
    monkeypatch.setenv("XRSEG_REFERENCE", str(tmp_path))   # no file there
    with pytest.raises(FileNotFoundError, match="--weights"):
        PORT[name].main(["--size", "64", *CPU])
    with pytest.raises(FileNotFoundError, match="--weights"):
        PORT[name].main(["--size", "64", "--weights",
                         str(tmp_path / "missing.npz"), *CPU])


def test_random_init_tools_fall_back_without_the_reference(monkeypatch,
                                                            tmp_path):
    """ab_o2o and ab_letterbox train from random init where the JAX tools'
    os.path.exists check fails: a reference root without the file."""
    monkeypatch.setenv("XRSEG_REFERENCE", str(tmp_path))
    monkeypatch.setattr(Trainer, "fit", _fit_stub)
    text = _stdout(ab_letterbox.main, [*ARGS["ab_letterbox"][:2],
                                       "--n-train", "2", "--n-val", "1",
                                       "--batch", "2", *CPU])
    assert "fine-tuning from" not in text
    assert len(_rows(text)) == 4


def test_trainer_trains_from_a_trainers_eval_params():
    """The seed model of ab_active is another Trainer's eval_params (its
    frozen EMA); a Trainer started from it trains a copy, and the source
    stays as it was."""
    from xrseg_tpu_torch.train.data import SyntheticShapesDataset

    cfg = ModelConfig(input_size=(32, 32), num_classes=3, dtype="float32")
    ds = SyntheticShapesDataset(n=4, hw=(32, 32), n_classes=3)
    # two steps: the schedule's first step is at lr 0
    tc = TrainConfig(epochs=1, batch=2, lr=1e-3, max_gt=4, warmup_steps=1)
    first = Trainer(cfg, tc, device="cpu")
    first.fit(ds, verbose=False)
    src = first.eval_params
    assert not any(p.requires_grad for p in src.parameters())
    before = [p.detach().clone() for p in src.parameters()]
    second = Trainer(cfg, tc, params=src, device="cpu")
    second.fit(ds, verbose=False)
    assert math.isfinite(second.history[-1]["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(
        second.params.parameters(), src.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(src.parameters(), before))


def test_with_config_gives_the_classic_deploy(trees):
    """An o2o checkpoint under o2o=False: the one-to-one head is left
    behind and the classic outputs are the o2o model's one-to-many ones."""
    cfg = ModelConfig(input_size=(SIZE, SIZE), num_classes=3, o2o=True,
                      dtype="float32")
    model = params_from_jax(trees[_key(cfg)], cfg)
    classic = dataclasses.replace(cfg, o2o=False)
    plain = tweights.with_config(model, classic)
    assert plain.cfg == classic and not hasattr(plain, "det_o2o")
    x = torch.rand((1, SIZE, SIZE, 3), generator=torch.Generator()
                   .manual_seed(0))
    with torch.no_grad():
        a, b = model(x, concat_preds=False), plain(x, concat_preds=False)
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert tweights.with_config(model, cfg) is model
