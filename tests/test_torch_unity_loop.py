"""The fine-tune -> redeploy loop of the port on the CPU, held against the
JAX package's io/sentis.py (the loop tests/test_unity_loop.py runs on the
reference's artifact, here on a synthetic template):

  .sentis template -> load_params_auto -> two train steps (float32, CPU)
  -> write_yolo11_sentis into a copy of the template -> reload
  -> export_onnx of the same trained model -> reload.

- the load is bit-equal to JAX's load of the same file;
- the written file is byte-identical to JAX's writer on the trained
  params, under minmax and mse; inside its program region only the
  quantization scale/zero-point scalars moved;
- the reload (port and JAX, bit-equal) holds every trained leaf within
  0.51 * (max - min) / 255 + 1e-7 (tests/test_sentis_loader.py's bound),
  and its pipeline gives a full slate;
- the ONNX export of the trained model reloads to its weights bit for bit
  through both packages' ONNX loaders.
"""
import jax
import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.io import onnx_loader as jonnx
from xrseg_tpu.io import sentis as js
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io import sentis as ts
from xrseg_tpu_torch.io import weights as tw
from xrseg_tpu_torch.io.bridge import params_from_jax, state_dict_from_jax
from xrseg_tpu_torch.io.onnx_export import export_onnx
from xrseg_tpu_torch.testing import limit_cpu_threads, sentis_template
from xrseg_tpu_torch.train import train_step as TTS
from torch_parity import detecting_tree

limit_cpu_threads()

MODEL = dict(input_size=(64, 64), dtype="float32", num_classes=3,
             matmul_precision="highest")
_REAL_INIT = jy.init_params


@pytest.fixture(autouse=True)
def cheap_jax_init(monkeypatch):
    """A zero tree of the init's structure stands in for JAX's eager
    init_params, which its loaders overwrite leaf by leaf."""
    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: _REAL_INIT(k, cfg),
                                jax.random.key(0))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    monkeypatch.setattr(jy, "init_params", init)


def _batch(rng, B=2, G=3):
    hw = MODEL["input_size"]
    boxes = np.concatenate([rng.uniform(16, 48, (B, G, 2)),
                            rng.uniform(10, 30, (B, G, 2))], -1)
    return {"images": rng.uniform(0, 1, (B,) + hw + (3,)).astype(np.float32),
            "boxes_xywh": boxes.astype(np.float32),
            "labels": rng.integers(0, 3, (B, G)).astype(np.int32),
            "masks": (rng.uniform(0, 1, (B, G, hw[0] // 4, hw[1] // 4))
                      > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The template, the loaded model and the model after two steps."""
    root = tmp_path_factory.mktemp("unity")
    jcfg, tcfg = jconfig.ModelConfig(**MODEL), tconfig.ModelConfig(**MODEL)
    tree = detecting_tree(jcfg, seed=21)
    template = sentis_template(tcfg, params_from_jax(tree, tcfg),
                               str(root / "deployed.sentis"), seed=21)
    loaded, cfg = tw.load_params_auto(template, tcfg)
    assert cfg is tcfg
    start = {k: v.clone() for k, v in loaded.state_dict().items()}
    opt = TTS.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = TTS.TrainState(params=loaded, opt_state=opt.init(loaded), step=0)
    step = TTS.make_train_step(tcfg, opt, use_remat=False, device="cpu")
    rng = np.random.default_rng(21)
    losses = []
    for _ in range(2):
        state, m = step(state, _batch(rng))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, template=template,
                start=start, trained=state.params)


def test_load_is_jax_load(loop):
    jp, _ = js.load_yolo11_params(loop["template"], loop["jcfg"])
    want = state_dict_from_jax(jax.device_get(jp))
    assert sorted(want) == sorted(loop["start"])
    for k, v in loop["start"].items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("method", ["minmax", "mse"])
def test_redeploy_is_jax_redeploy(loop, method):
    trained, template = loop["trained"], loop["template"]
    moved = [k for k, v in trained.state_dict().items()
             if not torch.equal(v, loop["start"][k])]
    assert len(moved) > 100                     # the steps moved weights
    out = str(loop["root"] / f"t_{method}.sentis")
    jout = str(loop["root"] / f"j_{method}.sentis")
    ts.write_yolo11_sentis(out, trained, template, loop["tcfg"], method)
    js.write_yolo11_sentis(jout, tw.params_to_tree(trained), template,
                           loop["jcfg"], method)
    new = open(out, "rb").read()
    assert new == open(jout, "rb").read()
    orig = open(template, "rb").read()
    prog = ts.parse_sentis(template)
    scalars = {p + i for p in prog.value_pos if p is not None
               for i in range(4)}
    changed = {i for i in range(prog.segment_base) if orig[i] != new[i]}
    assert changed and changed <= scalars

    back, _ = tw.load_params_auto(out, loop["tcfg"])
    jback, _ = js.load_yolo11_params(out, loop["jcfg"])
    jstate = state_dict_from_jax(jax.device_get(jback))
    want = trained.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, jstate[k]), k
        if method == "minmax":
            a = want[k]
            step = (float(a.max()) - float(a.min())) / 255.0
            assert float((v - a).abs().max()) <= 0.51 * step + 1e-7, k
    if method == "minmax":
        frames = np.random.default_rng(22).integers(0, 256, (2, 48, 64, 3),
                                                    np.uint8)
        det = tcompile.build_pipeline(
            tconfig.ExecutorConfig(model=loop["tcfg"]), back,
            frame_hw=(48, 64), batch=2, device="cpu")(frames)
        assert det["count"].tolist() == [50, 50]
        assert bool(det["slate"].isfinite().all())


def test_onnx_of_the_trained_model_reloads(loop):
    path = str(loop["root"] / "finetuned.onnx")
    export_onnx(loop["trained"], loop["tcfg"], path)
    back, _ = tw.load_params_auto(path, loop["tcfg"])
    jback, _ = jonnx.load_yolo11_onnx(path, loop["jcfg"])
    jstate = state_dict_from_jax(jax.device_get(jback))
    for k, v in loop["trained"].state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
        assert torch.equal(jstate[k], v), k
