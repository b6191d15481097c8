"""The port's stage_profile (xrseg_tpu_torch/tools/stage_profile.py) against
the JAX tool's stage functions (tools/stage_profile.py:42-81, :115-131),
written out here from xrseg_tpu.models.layers/yolo11 in float32 under
matmul precision "highest" at 64x64, batch 2.

Both sides read the same weights (`torch_parity.seeded_tree`, carried
across by io/bridge; the JAX init is never run) and the same inputs: the
port's build_stages draws them, and the JAX functions get them as NHWC
numpy arrays. Each stage's outputs agree within 1e-4 of the reference's
largest magnitude; composing the stages reproduces the port's forward;
main() prints JAX's 8 stage names in order, then WHOLE_PIPELINE; and the
stages' FLOPs sum to the forward's (FlopCounterMode, exactly) and to
model_info's (within its rounding to 0.01 GFLOP at batch 1).
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrseg_tpu.config as jconfig
from xrseg_tpu.models import layers as JL
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import preprocess as jpre
from xrseg_tpu.ops.postprocess import postprocess_batch_parts as jpost
from xrseg_tpu.precision import precision_scope as jscope
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.tools import stage_profile
from torch_parity import seeded_tree

limit_cpu_threads()

SIZE, BATCH = 64, 2
TOL = 1e-4
JCFG = jconfig.ModelConfig(input_size=(SIZE, SIZE), dtype="float32",
                           matmul_precision="highest")
TCFG = ModelConfig(input_size=(SIZE, SIZE), dtype="float32",
                   matmul_precision="highest")


def jax_stages(p, mcfg, pcfg):
    """The JAX tool's stage functions (tools/stage_profile.py:42-81) at
    the config's dtype, without the scan's carry; the detect and seg heads
    return both of their outputs."""
    dt = jnp.dtype(mcfg.dtype)

    def stem(x):
        x = JL.conv_apply(p["b0"], x, stride=2, dtype=dt)
        x = JL.conv_apply(p["b1"], x, stride=2, dtype=dt)
        return JL.c3k2_apply(p["b2"], x, shortcut=True, dtype=dt)

    def mid(x):
        x = JL.conv_apply(p["b3"], x, stride=2, dtype=dt)
        x4 = JL.c3k2_apply(p["b4"], x, shortcut=True, dtype=dt)
        x = JL.conv_apply(p["b5"], x4, stride=2, dtype=dt)
        return x4, JL.c3k2_apply(p["b6"], x, shortcut=True, dtype=dt)

    def deep(x6):
        x = JL.conv_apply(p["b7"], x6, stride=2, dtype=dt)
        x = JL.c3k2_apply(p["b8"], x, shortcut=True, dtype=dt)
        x = JL.sppf_apply(p["b9"], x, dtype=dt)
        return JL.c2psa_apply(p["b10"], x, dtype=dt)

    def neck(a, b, d):
        return jy.neck(p, (a, b, d), mcfg, dt)

    def det_heads(*feats):
        boxes, clss = jy._detect_branches(p, feats, mcfg, dt)
        B = feats[0].shape[0]
        box_flat = jnp.concatenate(
            [b.reshape(B, -1, 4 * mcfg.reg_max) for b in boxes], axis=1)
        cls_flat = jnp.concatenate(
            [c.reshape(B, -1, mcfg.num_classes) for c in clss], axis=1)
        return jy.dfl_decode(box_flat, mcfg.reg_max), cls_flat

    def seg_heads(*feats):
        protos = JL.proto_apply(p["proto"], feats[0], dtype=dt)
        B = feats[0].shape[0]
        mcs = []
        for i, f in enumerate(feats):
            c4 = p["seg_cv4"][i]
            m = JL.conv_apply(c4["conv0"], f, dtype=dt)
            m = JL.conv_apply(c4["conv1"], m, dtype=dt)
            mcs.append(JL.head_conv_apply(c4["out"], m, dtype=dt))
        return protos, jnp.concatenate(
            [m.reshape(B, -1, mcfg.num_masks) for m in mcs], axis=1)

    def postprocess(bx, cl, mc, pr):
        return jpost(bx, cl, mc, pr, pcfg, False, mcfg.input_size,
                     mask_dtype=dt, scores_are_logits=True)

    return {"preprocess": lambda fr: jpre.preprocess(
                fr, mcfg.input_size, dtype=dt),
            "backbone_stem_b0-2": stem, "backbone_mid_b3-6": mid,
            "backbone_deep_b7-10": deep, "neck": neck,
            "detect_heads+dfl": det_heads, "seg_heads+proto": seg_heads,
            "postprocess": postprocess}


def _jax_input(a: torch.Tensor, name: str) -> np.ndarray:
    """A port stage input as the JAX stage takes it: NCHW maps as NHWC
    (the stem's input is the NHWC batch permuted, as the forward does);
    frames and postprocess's raw heads as they are."""
    if a.dtype == torch.uint8:
        return a.numpy()
    if name == "postprocess" or a.dim() != 4:
        return a.float().numpy()
    return a.permute(0, 2, 3, 1).contiguous().numpy()


def _leaves(out) -> list:
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.fixture(scope="module")
def setup():
    tree = seeded_tree(JCFG)
    model = params_from_jax(tree, TCFG)
    cfg = ExecutorConfig(model=TCFG)
    stages = stage_profile.build_stages(
        model, cfg, BATCH, torch.Generator().manual_seed(0), "cpu")
    jcfg = jconfig.ExecutorConfig(model=JCFG)
    return model, stages, jax_stages(tree, JCFG, jcfg.post)


def test_stage_names_are_the_jax_tools():
    assert stage_profile.STAGES == (
        "preprocess", "backbone_stem_b0-2", "backbone_mid_b3-6",
        "backbone_deep_b7-10", "neck", "detect_heads+dfl",
        "seg_heads+proto", "postprocess")


@pytest.mark.parametrize("name", stage_profile.STAGES)
def test_stage_equals_the_jax_stage(setup, name):
    _, stages, jfns = setup
    fn, args = stages[name]
    with torch.no_grad():
        got = _leaves(fn(*args))
    jargs = [jnp.asarray(_jax_input(a, name)) for a in args]
    with jscope("highest"):
        want = jax.device_get(jfns[name](*jargs))
    if name == "postprocess":
        with torch.no_grad():
            det = fn(*args)
        assert set(det) == set(want), (sorted(det), sorted(want))
    want = _leaves(want)
    assert len(got) == len(want) and got
    for t, j in zip(got, want):
        t = t.detach()
        if t.dim() == 4 and name not in ("preprocess", "postprocess"):
            t = t.permute(0, 2, 3, 1)
        t, j = t.float().numpy(), np.asarray(j).astype(np.float32)
        assert t.shape == j.shape, (name, t.shape, j.shape)
        err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-6)
        assert err < TOL, (name, err)


def test_stages_compose_to_the_forward(setup):
    """stem -> mid -> deep -> neck -> heads on the real chain equals the
    port's forward on the same input."""
    model, stages, _ = setup
    fns = {n: f for n, (f, _) in stages.items()}
    frames = stages["preprocess"][1][0]
    with torch.no_grad():
        x = fns["preprocess"](frames)
        ref = model(x, concat_preds=False)
        x4, x6 = fns["backbone_mid_b3-6"](
            fns["backbone_stem_b0-2"](x.permute(0, 3, 1, 2)))
        feats = fns["neck"](x4, x6, fns["backbone_deep_b7-10"](x6))
        ltrb, cls = fns["detect_heads+dfl"](*feats)
        protos, coefs = fns["seg_heads+proto"](*feats)
    torch.testing.assert_close(cls, ref["cls_logits"], rtol=0, atol=0)
    torch.testing.assert_close(coefs.float(), ref["mask_coefs"], rtol=0,
                               atol=0)
    torch.testing.assert_close(protos.permute(0, 2, 3, 1).float(),
                               ref["protos"], rtol=0, atol=0)
    _, _, ref_ltrb, _ = model._detect(model.det, feats)
    torch.testing.assert_close(ltrb, ref_ltrb, rtol=0, atol=0)


def test_stage_flops_sum_to_the_forward(setup):
    model, stages, _ = setup
    total = sum(stage_profile.count_flops(*stages[n])
                for n in stage_profile.FORWARD_STAGES)
    x = torch.zeros((BATCH, SIZE, SIZE, 3))
    forward = stage_profile.count_flops(lambda a: model(a), (x,))
    assert total == forward > 0
    assert stage_profile.count_flops(*stages["preprocess"]) == 0
    info = yolo11.model_info(TCFG, model, device="cpu")["gflops"]
    assert abs(total / 1e9 - BATCH * info) <= BATCH * 0.005, (total, info)


def test_main_prints_the_stages_in_order():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert stage_profile.main(["2", "--size", "64", "--device",
                                   "cpu"]) == 0
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [r["stage"] for r in rows] == [*stage_profile.STAGES,
                                          "WHOLE_PIPELINE"]
    for r in rows[:-1]:
        assert set(r) == {"stage", "ms", "gflops", "tf_per_s"}
        assert np.isfinite(r["ms"]) and r["ms"] > 0
    assert rows[0]["gflops"] == rows[0]["tf_per_s"] == 0
    assert set(rows[-1]) == {"stage", "ms", "sum_of_stages_ms"}
    assert rows[-1]["ms"] > 0
    assert rows[-1]["sum_of_stages_ms"] == pytest.approx(
        sum(r["ms"] for r in rows[:-1]), abs=0.01)
