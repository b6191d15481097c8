"""YOLO12 (ModelConfig(arch="yolo12")): the port's network against the
benchmark's plain float32 reference (benchmark/reference/yolo12.py), its
area attention against the explicit product, its layer plan, its batch
path, and the paths that refuse it. The JAX package has no YOLO12, so
nothing here imports JAX.

On the card (marker `cuda`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_yolo12.py

the fused attention (SDPA through flash, memory-efficient or cuDNN) at
the cell's shapes against the float32 product, and a YOLO12x forward's
16 fused calls, none through the math backend.
"""
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

from benchmark.harness import arch, compare, traffic
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import yolo, yolo12
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops import attention, launches
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
CFG_X = json.loads((ROOT / "benchmark/configs/yolo12x-seg.json").read_text())
N_SCALE = {"scale": "n", "depth_multiple": 0.5, "width_multiple": 0.25,
           "max_channels": 1024}


def bench_cfg(scale: str, hw, dtype="float32") -> dict:
    """The benchmark's YOLO12x-seg configuration at another scale and
    size (frames at the model's size)."""
    cfg = {**CFG_X, "input_size": list(hw), "frame_hw": list(hw),
           "dtype": dtype}
    return {**cfg, **N_SCALE} if scale == "n" else cfg


def port_cfg(cfg: dict) -> ModelConfig:
    return arch.model_config(cfg)


# ---------------------------------------------------------------------------
# the network against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,hw", [("n", (64, 64)), ("n", (96, 128)),
                                      ("x", (64, 64)), ("x", (96, 128))])
def test_forward_matches_reference(scale, hw):
    """Every raw head output, float32 on both sides, on the benchmark's
    seeded weights (every anchor fires). At 96x128 the P4 map is 6x8, so
    each of its 4 areas is 12 tokens, a row and a half: the bands follow
    the token order, not whole rows.

    Tolerance: relative 1e-4, plus 1e-4 of the output's largest value.
    Both sides compute the same function in float32 but sum in other
    orders (conv algorithms, the attention's two products), and that
    rounding, about 1e-7 a step, grows through some 100 layers; elements
    near zero carry the same absolute error as the rest, so a purely
    relative check would read noise there."""
    cfg = bench_cfg(scale, hw)
    sd = arch.make_weights(cfg, 7, "cpu")
    model = arch.build_model(cfg, sd, "cpu")
    x = torch.rand((1,) + hw + (3,),
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(x)
        want = yolo12.forward(yolo.Ops(sd), cfg, x)
    for k in ("boxes_xywh", "cls_logits", "mask_coefs", "protos"):
        w = want[k]
        torch.testing.assert_close(got[k].float(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   msg=lambda m: f"{k}: {m}")


def _aattn_literal(m: L.AAttn, x: torch.Tensor) -> torch.Tensor:
    """Ultralytics' AAttn.forward written out: the qkv conv's tokens,
    [B*a, N/a, 3C] per area, q/k/v per head from [heads, 3*head_dim],
    (q^T k) * scale, softmax, v @ attn^T, pe on v, proj."""
    B, C, H, W = x.shape
    N, a, nh, hd = H * W, m.area, m.num_heads, m.head_dim

    def conv(c, z, groups=1):
        k = c.weight.shape[-1]
        return F.conv2d(z, c.weight, c.bias, 1, k // 2, 1, groups)

    qkv = conv(m.qkv, x).flatten(2).transpose(1, 2)
    if a > 1:
        qkv = qkv.reshape(B * a, N // a, C * 3)
    Bp, n, _ = qkv.shape
    q, k, v = qkv.view(Bp, n, nh, hd * 3).permute(0, 2, 3, 1).split(
        [hd, hd, hd], dim=2)
    attn = ((q.transpose(-2, -1) @ k) * hd ** -0.5).softmax(-1)
    o = (v @ attn.transpose(-2, -1)).permute(0, 3, 1, 2)
    v = v.permute(0, 3, 1, 2)
    o = o.reshape(B, H, W, C).permute(0, 3, 1, 2)
    v = v.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return conv(m.proj, o + conv(m.pe, v, C))


@pytest.mark.parametrize("area,hw", [(1, (5, 7)), (4, (8, 6)), (4, (6, 8)),
                                     (4, (2, 6))])
def test_area_attention_matches_explicit_product(area, hw):
    """The CPU path of AAttn (ops/attention's plain version) against the
    module's equations, float32, areas of whole rows and of part rows
    (6x8 and 2x6 at 4 areas: 12 and 3 tokens an area)."""
    m = L.AAttn(64, 2, area, dtype=torch.float32)
    L.reset_parameters(m, torch.Generator().manual_seed(area))
    x = torch.randn((2, 64) + hw, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(m(x), _aattn_literal(m, x), rtol=1e-5,
                                   atol=1e-5)


def test_area_attention_plain_version():
    """area_attention on CPU tensors is softmax(q k^T * scale) v in
    float32, rounded once to q's dtype."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 2, 10, 32, generator=g) for _ in range(3))
    want = torch.softmax(q @ k.transpose(-2, -1) * 0.2, -1) @ v
    torch.testing.assert_close(attention.area_attention(q, k, v, 0.2), want)
    got = attention.area_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   0.2)
    assert got.dtype == torch.bfloat16
    want = attention.area_attention_torch(q.bfloat16(), k.bfloat16(),
                                          v.bfloat16(), 0.2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("channels_last", [False, True])
def test_aattn_hands_attention_a_dense_last_dim(monkeypatch, batch,
                                                channels_last):
    """Whatever layout the qkv conv leaves (NCHW or channels-last) and at
    batch 1, where a strided view of an NCHW map is possible, q, k and v
    reach area_attention with their last dim dense, as the card's fused
    backends need."""
    seen = []

    def record(q, k, v, scale):
        seen.append([t.stride(-1) for t in (q, k, v)])
        return attention.area_attention_torch(q, k, v, scale)

    monkeypatch.setattr(L, "area_attention", record)
    m = L.AAttn(64, 2, 4, dtype=torch.float32)
    x = torch.randn(batch, 64, 8, 6)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        m(x)
    assert seen == [[1, 1, 1]]


def test_aattn_refuses_tokens_that_do_not_split():
    m = L.AAttn(32, 1, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="areas"):
        m(torch.zeros(1, 32, 3, 3))


# ---------------------------------------------------------------------------
# the layer plan
# ---------------------------------------------------------------------------

def test_x_layer_plan_matches_the_published_one():
    """YOLO12x-seg's state dict, on the meta device, has the reference's
    names and shapes (the yaml's layers at scale x: C3k in every C3k2,
    A2C2f with gamma and a 460-wide MLP), 63.2 M parameters with batch
    norm folded."""
    specs = yolo12.param_specs(CFG_X)
    with torch.device("meta"):
        model = yolo11.YOLO11(port_cfg(CFG_X))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {n: s for n, s, _ in specs}
    assert round(sum(math.prod(s) for s in got.values()) / 1e6, 2) == 63.23
    assert got["b6.m.0.0.mlp.0.weight"] == (460, 384, 1, 1)
    assert got["b1.weight"] == (192, 48, 3, 3)           # 2 groups
    assert got["b3.weight"] == (384, 96, 3, 3)           # 4 groups
    assert got["b6.gamma"] == (768,) and "h11.gamma" not in got
    b6 = model.b6.m[0][0].attn
    assert (b6.area, b6.num_heads, b6.head_dim) == (4, 12, 32)
    assert model.b8.m[3][1].attn.area == 1


def test_scale_flags_follow_parse_model():
    """gamma and the 1.2x MLP only at l and x; C3k in C3k2 at m, l, x."""
    for scale, residual in (("n", False), ("m", False), ("l", True)):
        s = yolo11.Spec(ModelConfig(arch="yolo12", scale=scale))
        assert s.a2_residual is residual
        assert s.mlp_ratio == (1.2 if residual else 2.0)
        assert s.force_c3k is (scale != "n")


def test_attention_counts_as_a_fused_call():
    """The count's attention: 4 * B * a * heads * (N/a)^2 * head_dim FLOPs
    a call, q, k, v in and o out once each in bf16."""
    c = yolo12.count_forward(CFG_X, batch=2)
    attn = [layer for layer in c.layers if layer[0] == "attention"]
    assert len(attn) == 16
    p4 = 4 * 2 * 4 * 12 * (60 * 80 // 4) ** 2 * 32
    p5 = 4 * 2 * 1 * 12 * (30 * 40) ** 2 * 32
    assert [f for _, f, _, _, _ in attn] == [p4] * 8 + [p5] * 8
    qkvo = 2 * 384 * 2
    assert attn[0][2:] == (3 * 60 * 80 * qkvo, 0, 60 * 80 * qkvo)
    assert sum(f for _, f, _, _, _ in attn) / 2 == 88473600000


# ---------------------------------------------------------------------------
# the batch path
# ---------------------------------------------------------------------------

def test_streaming_pipeline_gives_the_reference_slate():
    """build_pipeline + StreamingRunner for YOLO12n-seg at 64x64, float32:
    every row's slate is the reference pipeline's (compare.slate_numbers:
    the same anchors and classes, greedy NMS kept, scores within 1e-4)."""
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner

    cfg = bench_cfg("n", (64, 64))
    sd = arch.make_weights(cfg, 11, "cpu")
    pipe = build_pipeline(arch.exec_config(cfg), arch.build_model(cfg, sd,
                                                                  "cpu"),
                          frame_hw=(64, 64), batch=4, device="cpu")
    runner = StreamingRunner(pipe, depth=2)
    batches = traffic.batch_pool(11, 2, 4, (64, 64))
    results = [runner.submit(b) for b in batches]
    results = [r for r in results if r is not None] + list(runner.drain())
    assert len(results) == 2
    for frames, r in zip(batches, results):
        refs = arch.pipeline_run(sd, cfg, frames, "cpu")
        for row, ref in enumerate(refs):
            c = int(r.slate["count"][row])
            assert c == ref["count"] > 0
            res = compare.slate_numbers(
                ref, np.asarray(r.slate["boxes_xywh"][row])[:c],
                np.asarray(r.slate["scores"][row])[:c],
                np.asarray(r.slate["labels"][row])[:c])
            assert res["slate_miss"] == 0 and res["nms_miss"] == 0, res
            assert res["score_err_max"] < 1e-4 and res["box_err_max"] < 1e-3
            want = ref_pipeline.masks_of(ref, res["anchor"])
            got = r.device_out["masks"][row, :c].float().numpy()
            assert np.abs(got - want).max() < 1e-3


def test_profiler_ranges_only_in_the_attention_blocks():
    """Under a profiler a YOLO12n forward opens `xrseg.a2c2f` around its
    two attention A2C2f (not the neck's) and `xrseg.area_attn` around each
    of its 8 attention calls; a YOLO11 forward opens neither."""
    def ranges(cfg):
        model = yolo11.YOLO11(cfg)
        x = torch.zeros((1,) + cfg.input_size + (3,))
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            model(x)
        names = [e.name for e in prof.events()]
        return names.count("xrseg.a2c2f"), names.count("xrseg.area_attn")

    small = dict(input_size=(64, 64), dtype="float32")
    assert ranges(ModelConfig(arch="yolo12", **small)) == (2, 8)
    assert ranges(ModelConfig(**small)) == (0, 0)


# ---------------------------------------------------------------------------
# the paths that refuse yolo12
# ---------------------------------------------------------------------------

def _refusals():
    from xrseg_tpu_torch import compile as comp
    from xrseg_tpu_torch.io import bridge, onnx_export, onnx_loader, torch_pt
    from xrseg_tpu_torch.parallel import batch, pipeline, spatial
    from xrseg_tpu_torch.train import train_step

    cfg = ModelConfig(arch="yolo12", input_size=(64, 64), dtype="float32")
    ecfg = ExecutorConfig(model=cfg)
    state = types.SimpleNamespace(params=types.SimpleNamespace(cfg=cfg))
    return {
        "obb": lambda: yolo11.YOLO11(ModelConfig(arch="yolo12", task="obb")),
        "pose": lambda: yolo11.YOLO11(ModelConfig(arch="yolo12",
                                                  task="pose")),
        "classify": lambda: yolo11.YOLO11(ModelConfig(arch="yolo12",
                                                      task="classify")),
        "onnx_export": lambda: onnx_export.export_onnx(
            yolo11.YOLO11(cfg), cfg, "unused.onnx"),
        "onnx_and_sentis_slots": lambda: onnx_loader.ordered_param_slots(cfg),
        "ultralytics_pt": lambda: torch_pt.ultralytics_slots(cfg),
        "jax_bridge": lambda: bridge.params_from_jax({}, cfg),
        "tta": lambda: comp.build_pipeline(ecfg, yolo11.YOLO11(cfg), tta=True,
                                           device="cpu"),
        "xr_tick": lambda: comp.build_xr_tick_pipeline(ecfg, None,
                                                       device="cpu"),
        "data_parallel": lambda: batch.build_sharded_pipeline(
            ecfg, None, None, batch=2),
        "pipeline_parallel": lambda: pipeline.PipelinedRunner(
            ecfg, None, [torch.device("cpu")] * 2),
        "spatial_parallel": lambda: spatial.build_spatial_pipeline(
            ecfg, None, None),
        "mesh_training": lambda: train_step.shard_train_state(state, None),
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_out_of_scope_paths_refuse_yolo12(path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="yolo12"):
        _refusals()[path]()
    assert not (tmp_path / "unused.onnx").exists()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (fused SDPA backends)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("area", [4, 1])
def test_fused_attention_at_the_cells_shapes(card, area):
    """SDPA on bf16 q, k, v at 1200 tokens an area, 12 heads of width 32
    (b=8 of the cell's P4 or P5 calls), in the layout AAttn hands it,
    against the float32 product of the same bf16 inputs: within bf16's
    rounding of o (2^-8 relative) and of the probabilities the fused
    kernels keep in bf16 before the second product."""
    g = torch.Generator(device=card).manual_seed(area)
    t = torch.randn(8 * area, 1200, 12, 96, generator=g, device=card,
                    dtype=torch.bfloat16)
    q, k, v = t.transpose(1, 2).split(32, dim=-1)
    before = launches.read()["area_attention_cuda"]
    got = attention.area_attention(q, k, v, 32 ** -0.5)
    want = attention.area_attention_torch(q.float(), k.float(), v.float(),
                                          32 ** -0.5)
    torch.cuda.synchronize()
    assert launches.read()["area_attention_cuda"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = (got.float() - want).abs().max().item()
    assert err < 2e-2 * want.abs().max().item(), err


@pytest.mark.cuda
def test_x_forward_makes_16_fused_calls(card, monkeypatch):
    """A YOLO12x-seg forward at 960x1280, bf16: 16 fused attention calls,
    each one with the math backend shut out of SDPA's choice, and finite
    outputs."""
    model = yolo11.YOLO11(ModelConfig(arch="yolo12", scale="x",
                                      input_size=(960, 1280))).to(card)
    x = torch.rand(1, 960, 1280, 3, device=card)
    allowed = []
    sdpa_kernel = attention.sdpa_kernel

    def recorded(backends):
        allowed.append(set(backends))
        return sdpa_kernel(backends)

    monkeypatch.setattr(attention, "sdpa_kernel", recorded)
    calls = launches.read()["area_attention_cuda"]
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert launches.read()["area_attention_cuda"] - calls == 16
    fused = {SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION}
    assert len(allowed) == 16 and all(a == fused for a in allowed), allowed
    assert torch.isfinite(out["preds"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_aattn_takes_the_fused_path_from_either_layout(card, batch):
    """AAttn at P4 of a 640x640 YOLO12x (40x40, 4 areas of 400 tokens) on
    an NCHW and a channels-last input: one fused call each, equal to the
    CPU path's float32 product up to bf16 rounding."""
    m32 = L.AAttn(384, 12, 4, dtype=torch.float32)
    L.reset_parameters(m32, torch.Generator().manual_seed(batch))
    x = torch.randn(batch, 384, 40, 40,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = m32(x)
    m = L.AAttn(384, 12, 4).to(card)
    m.load_state_dict(m32.state_dict())
    for layout in (torch.contiguous_format, torch.channels_last):
        calls = launches.read()["area_attention_cuda"]
        with torch.no_grad():
            got = m(x.to(card).contiguous(memory_format=layout)).float()
        assert launches.read()["area_attention_cuda"] == calls + 1
        err = (got.cpu() - want).abs().max().item()
        assert err < 3e-2 * want.abs().max().item(), (layout, err)


@pytest.mark.cuda
def test_fused_attention_refuses_what_no_fused_backend_takes(card):
    """An input no fused backend takes (float64) raises; it never runs
    the math backend."""
    q = torch.zeros(1, 1, 16, 32, device=card, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="fused"):
        attention.area_attention_cuda(q, q, q, 1.0)
