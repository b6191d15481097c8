"""Segment Anything (ModelConfig(arch="sam")): the port against the plain
float32 reference `tests/sam_reference.py` (and that reference against the
benchmark's, `benchmark/reference/sam.py`), the rel-pos table, the
windows, the box transform, the batch path and its packed rows, and the
paths that refuse arch "sam". The JAX package has no SAM, so nothing here
imports JAX.

The model is a small one at the published structure (TINY: embed 64,
depth 4, 4 heads, global blocks 1 and 3, windows of 4 over 10x10 tokens,
so the map pads to 12; decoder width 32, MLP 64) on the benchmark's
seeded weights (harness/sam.make_weights: nonzero pos_embed and rel-pos
tables).

On the card (marker `cuda`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sam.py

the rel-pos attention at ViT-H's window (196 tokens) and global (4096
tokens) shapes, bf16 with heads of 80, against the plain form, never
through SDPA's math backend; and a ViT-H forward's 28 windowed and 4
global calls and its `sam_prompts` count.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.nn.attention import SDPBackend

import sam_reference as plain
from benchmark.harness import sam as sam_h
from benchmark.reference import sam as bench_ref
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
from xrseg_tpu_torch.models import sam
from xrseg_tpu_torch.ops import attention, launches
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.runtime.streaming import StreamingRunner
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
CFG_H = json.loads((ROOT / "benchmark/configs/sam-vit-h.json").read_text())
TINY = {**CFG_H, "encoder_embed_dim": 64, "encoder_depth": 4,
        "encoder_num_heads": 4, "encoder_global_attn_indexes": [1, 3],
        "image_size": 160, "window_size": 4, "prompt_embed_dim": 32,
        "decoder_mlp_dim": 64, "iou_head_hidden_dim": 32,
        "dtype": "float32", "frame_hw": [96, 128]}
SEED = 2 ** 33 + 5


def tiny(dtype="float32", frame_hw=(96, 128)) -> dict:
    return {**TINY, "dtype": dtype, "frame_hw": list(frame_hw)}


@pytest.fixture(scope="module")
def weights():
    return sam_h.make_weights(TINY, SEED, "cpu")


def inputs(frame_hw, batch=2, prompts=3, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch,) + tuple(frame_hw) + (3,),
                          dtype=np.uint8)
    return frames, sam_h.box_pool(seed, 1, batch, prompts, frame_hw)[0]


def pipeline(cfg, sd, batch=2, prompts=3):
    return build_pipeline(sam_h.exec_config(cfg),
                          sam_h.build_model(cfg, sd, "cpu"),
                          frame_hw=tuple(cfg["frame_hw"]), batch=batch,
                          prompts_per_frame=prompts, device="cpu")


def close(got, want, tol):
    """|got - want| <= tol * the largest |want|."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max())


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame_hw", [(96, 128), (100, 80)])
def test_float32_matches_the_plain_reference(weights, frame_hw):
    """float32 on both sides, TF32 off: every stage within 1e-5 of the
    output's largest value (a 96x128 frame is enlarged to 120x160 and
    padded below, a 100x80 one to 160x128 and padded right). Both compute
    the same function; they sum in other orders (the encoder's einsums,
    the LayerNorm2d's statistics), about 1e-7 a step."""
    cfg = tiny(frame_hw=frame_hw)
    pipe = pipeline(cfg, weights)
    frames, boxes = inputs(frame_hw)
    want = plain.run(weights, cfg, torch.as_tensor(frames),
                     torch.as_tensor(boxes))
    with torch.no_grad():
        x, b = pipe.preprocess(torch.as_tensor(frames),
                               torch.as_tensor(boxes))
        close(x.permute(0, 3, 1, 2),
              plain.preprocess(cfg, torch.as_tensor(frames)), 1e-6)
        emb = pipe.params.encode(x)
        close(emb, plain.image_encoder(weights, cfg, x.permute(0, 3, 1, 2)),
              1e-5)
        raw = pipe.params.decode(emb, b)
    close(raw["masks"], want["masks"], 1e-5)
    close(raw["iou"], want["iou"], 1e-5)
    out = pipe((frames, boxes))
    close(out["low_res_logits"], want["masks"][:, :, 0], 1e-5)
    close(out["iou"], want["iou"][:, :, 0], 1e-5)
    sure = want["frame_logits"].abs() > 1e-4
    assert torch.equal((want["frame_logits"] > 0)[sure],
                       out["masks"].bool()[sure])


def test_bfloat16_within_a_few_witnesses(weights):
    """bf16 compute against the float32 reference. Tolerance: the mean
    |logit error| of the worst prompt at most 4x the mean error of the
    bf16 witness (the reference with every product's operands rounded to
    bf16, as the program's are). The program also rounds what the
    witness keeps in float32 (the residual stream, the norms' outputs, the
    bias sums, the softmax's probabilities), so its error is a few times
    the witness's; a fault in the function (a dropped bias, a misplaced
    window) is many."""
    cfg = tiny("bfloat16")
    pipe = pipeline(cfg, weights)
    frames, boxes = inputs((96, 128))
    got = pipe((frames, boxes))
    ref = sam_h.pipeline_run(weights, cfg, frames, boxes, "cpu")
    wit = sam_h.pipeline_run(weights, cfg, frames, boxes, "cpu",
                             quant="bf16")
    for name, key in (("low_res_logits", "low_res"), ("iou", "iou")):
        err = (got[name] - ref[key]).abs()
        werr = (wit[key] - ref[key]).abs()
        if name == "low_res_logits":
            err, werr = err.mean((-2, -1)), werr.mean((-2, -1))
        assert err.max() <= 4 * werr.mean(), (name, err.max(), werr.mean())


def test_the_two_references_agree(weights):
    """tests/sam_reference.py and benchmark/reference/sam.py (the same
    functions over Ops) give equal outputs, within float32 summation
    order."""
    cfg = tiny()
    frames, boxes = inputs((96, 128))
    a = plain.run(weights, cfg, torch.as_tensor(frames),
                  torch.as_tensor(boxes))
    b = bench_ref.run(weights, cfg, torch.as_tensor(frames),
                      torch.as_tensor(boxes))
    for k in a:
        close(b[k], a[k], 1e-5)


def test_the_parameters_are_the_published_names(weights):
    """The port's state dict is the benchmark's spec, name for name and
    shape for shape, in SAM's published names."""
    model = sam_h.build_model(TINY, weights, "cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in weights.items()}
    assert "image_encoder.blocks.1.attn.rel_pos_h" in got
    assert got["image_encoder.blocks.0.attn.rel_pos_h"] == (7, 16)
    assert got["image_encoder.blocks.1.attn.rel_pos_h"] == (19, 16)
    assert "mask_decoder.transformer.layers.0.cross_attn_token_to_image" \
           ".q_proj.weight" in got


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 14, 64])
def test_get_rel_pos_is_the_offset_table(size):
    """Row (i - j) + (size - 1) for every query i and key j, as a loop
    over (i, j) reads it."""
    table = torch.randn(2 * size - 1, 8,
                        generator=torch.Generator().manual_seed(size))
    got = attention.get_rel_pos(size, size, table)
    want = torch.stack([torch.stack([table[i - j + size - 1]
                                     for j in range(size)])
                        for i in range(size)])
    assert torch.equal(got, want)
    assert torch.equal(got, plain.get_rel_pos(size, size, table))


def test_get_rel_pos_resizes_another_length():
    """A table of another length is resized linearly first, as SAM's."""
    table = torch.randn(7, 8, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(attention.get_rel_pos(10, 10, table),
                          plain.get_rel_pos(10, 10, table), atol=1e-6)


@pytest.mark.parametrize("hw", [(4, 4), (14, 14), (3, 5)])
def test_bias_expander_sums_the_two_terms(hw):
    """The card's bias GEMM: [rel_h | rel_w] times the 0/1 expander is
    rel_h[.., ky] + rel_w[.., kx] exactly, also into rows laid out
    BIAS_ALIGN apart."""
    qh, qw = hw
    N = qh * qw
    g = torch.Generator().manual_seed(N)
    rel_h = torch.randn(2, 3, qh, qw, qh, generator=g)
    rel_w = torch.randn(2, 3, qh, qw, qw, generator=g)
    want = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(2, 3, N, N)
    e = attention._bias_expander(qh, qw, torch.float32, torch.device("cpu"))
    row = -(-N // attention.BIAS_ALIGN) * attention.BIAS_ALIGN
    buf = torch.empty(2 * 3 * N, row)
    torch.mm(torch.cat([rel_h, rel_w], -1).reshape(-1, qh + qw), e,
             out=buf[:, :N])
    assert torch.equal(buf.view(2, 3, N, row)[..., :N], want)


@pytest.mark.parametrize("hw", [(10, 10), (12, 12), (9, 13)])
def test_window_round_trip(hw):
    """Partition pads with zeros at the bottom and right to multiples of
    the window; unpartition crops back to x exactly."""
    x = torch.randn((2,) + hw + (8,),
                    generator=torch.Generator().manual_seed(1))
    win, pad_hw = attention.window_partition(x, 4)
    Hp, Wp = pad_hw
    assert (Hp, Wp) == (-(-hw[0] // 4) * 4, -(-hw[1] // 4) * 4)
    assert win.shape == (2 * Hp * Wp // 16, 4, 4, 8)
    ref_win, ref_pad = plain.window_partition(x, 4)
    assert torch.equal(win, ref_win) and pad_hw == ref_pad
    full = win.view(2, Hp // 4, Wp // 4, 4, 4, 8).permute(
        0, 1, 3, 2, 4, 5).reshape(2, Hp, Wp, 8)
    assert not full[:, hw[0]:].any() and not full[:, :, hw[1]:].any()
    assert torch.equal(attention.window_unpartition(win, 4, pad_hw, hw), x)


def test_box_transform():
    """xyxy frame pixels onto the resized input: 960x1280 -> 768x1024 is
    x0.8 on both axes; 96x128 -> 120x160 at 160 is x1.25."""
    assert pre_ops.sam_input_hw((960, 1280), 1024) == (768, 1024)
    assert pre_ops.sam_input_hw((100, 80), 160) == (160, 128)
    b = torch.tensor([[[10.0, 20.0, 640.0, 480.0]]])
    assert torch.allclose(pre_ops.sam_boxes(b, (960, 1280), 1024),
                          b * 0.8)
    assert torch.allclose(pre_ops.sam_boxes(b, (96, 128), 160), b * 1.25)
    assert torch.equal(pre_ops.sam_boxes(b, (96, 128), 160),
                       plain.apply_boxes(b, (96, 128), 160))
    assert torch.equal(pre_ops.sam_boxes(b, (960, 1280), 1024),
                       plain.apply_boxes(b, (960, 1280), 1024))


def test_preprocess_pads_with_zeros():
    """The resized frame, normalised, top left; zeros below and right."""
    frames = torch.full((1, 96, 128, 3), 200, dtype=torch.uint8)
    x = pre_ops.sam_preprocess(frames, 160, sam.PIXEL_MEAN, sam.PIXEL_STD)
    assert x.shape == (1, 160, 160, 3)
    want = (200 - torch.tensor(sam.PIXEL_MEAN)) / torch.tensor(sam.PIXEL_STD)
    assert torch.allclose(x[0, :120, :160], want.expand(120, 160, 3))
    assert not x[:, 120:].any()


# ---------------------------------------------------------------------------
# the batch path
# ---------------------------------------------------------------------------

def test_packed_rows_round_trip_through_the_runner(weights):
    """The packed uint8 rows hold iou | logits | masks; the runner reads
    them back through its uint8 readback slots and unpacks copies equal to
    the pipeline's device outputs, in FIFO order."""
    cfg = tiny()
    pipe = pipeline(cfg, weights)
    assert pipe.readback.buffer.dtype == torch.uint8
    batches = [inputs((96, 128), seed=s) for s in (1, 2, 3)]
    want = [pipe(b) for b in batches]
    assert want[0]["slate"].shape == (2, pipe.row_bytes)
    assert want[0]["masks"].dtype == torch.uint8
    got = list(StreamingRunner(pipe, depth=2).run(iter(batches)))
    assert [r.frame_id for r in got] == [0, 1, 2]
    for r, w in zip(got, want):
        assert np.array_equal(r.slate["iou"], w["iou"].numpy())
        assert np.array_equal(r.slate["low_res_logits"],
                              w["low_res_logits"].numpy())
        assert np.array_equal(r.slate["masks"], w["masks"].numpy())
        assert r.slate["masks"].shape == (2, 3, 96, 128)


def test_profiler_ranges(weights):
    """One `xrseg.relpos_attn` a block (4) and one `xrseg.sam_decoder` a
    batch while a profiler records; none otherwise."""
    pipe = pipeline(tiny(), weights)
    batch = inputs((96, 128))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe(batch)
    names = [e.name for e in prof.events()]
    assert names.count("xrseg.relpos_attn") == 4
    assert names.count("xrseg.sam_decoder") == 1


def test_build_pipeline_options(weights):
    """SAM needs its prompt count and takes none of the YOLO options; a
    YOLO pipeline takes no prompt count."""
    cfg = tiny()
    ecfg, model = sam_h.exec_config(cfg), sam_h.build_model(cfg, weights,
                                                            "cpu")
    with pytest.raises(ValueError, match="prompts_per_frame"):
        build_pipeline(ecfg, model, device="cpu")
    with pytest.raises(ValueError, match="input_format"):
        build_pipeline(ecfg, model, prompts_per_frame=2,
                       input_format="yuv420", device="cpu")
    with pytest.raises(ValueError, match="prompts_per_frame is for arch"):
        build_pipeline(ExecutorConfig(), None, prompts_per_frame=2,
                       device="cpu")
    with pytest.raises(ValueError, match="Unknown sam scale"):
        sam.SAM(ModelConfig(arch="sam", scale="x", input_size=(160, 160)))


# ---------------------------------------------------------------------------
# the paths that refuse arch "sam"
# ---------------------------------------------------------------------------

def _refusals():
    from xrseg_tpu_torch import compile as comp
    from xrseg_tpu_torch.io import bridge, onnx_export, onnx_loader, torch_pt
    from xrseg_tpu_torch.parallel import batch, pipeline, spatial
    from xrseg_tpu_torch.train import train_step, trainer

    cfg = ModelConfig(arch="sam", scale="b", input_size=(160, 160),
                      dtype="float32")
    ecfg = ExecutorConfig(model=cfg)
    state = types.SimpleNamespace(params=types.SimpleNamespace(cfg=cfg))
    return {
        "tta": lambda: comp.build_pipeline(ecfg, None, tta=True,
                                           device="cpu"),
        "xr_tick": lambda: comp.build_xr_tick_pipeline(ecfg, None,
                                                       device="cpu"),
        "ensemble": lambda: comp.build_ensemble_pipeline(ecfg, [None],
                                                         device="cpu"),
        "data_parallel": lambda: batch.build_sharded_pipeline(
            ecfg, None, None, batch=2),
        "pipeline_parallel": lambda: pipeline.PipelinedRunner(
            ecfg, None, [torch.device("cpu")] * 2),
        "spatial_parallel": lambda: spatial.build_spatial_pipeline(
            ecfg, None, None),
        "train_state": lambda: train_step.init_train_state(
            torch.Generator(), cfg, None, device="cpu"),
        "train_step": lambda: train_step.make_train_step(cfg, None,
                                                         device="cpu"),
        "trainer": lambda: trainer.Trainer(cfg, device="cpu"),
        "mesh_training": lambda: train_step.shard_train_state(state, None),
        "onnx_export": lambda: onnx_export.export_onnx(None, cfg,
                                                       "unused.onnx"),
        "onnx_and_sentis_slots": lambda: onnx_loader.ordered_param_slots(cfg),
        "ultralytics_pt": lambda: torch_pt.ultralytics_slots(cfg),
        "jax_bridge": lambda: bridge.params_from_jax({}, cfg),
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_out_of_scope_paths_refuse_sam(path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="does not support arch 'sam'"):
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


@pytest.fixture
def backends(monkeypatch):
    """The backend sets every SDPA call of ops/attention was allowed."""
    allowed = []
    sdpa_kernel = attention.sdpa_kernel

    def recorded(b):
        allowed.append(set(b))
        return sdpa_kernel(b)

    monkeypatch.setattr(attention, "sdpa_kernel", recorded)
    return allowed


FUSED = {SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
         SDPBackend.CUDNN_ATTENTION}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,batch,hw", [("window", 50, (14, 14)),
                                           ("global", 2, (64, 64))])
def test_relpos_attention_at_vit_h_shapes(card, backends, kind, batch, hw):
    """bf16 q, k, v with 16 heads of 80 and nonzero tables: one fused
    call, the math backend shut out, against the float32 plain form of
    the same bf16 inputs: within bf16's rounding of the bias (added to
    scores of about 10) and of the probabilities the fused kernels keep in
    bf16 before the second product."""
    g = torch.Generator(device=card).manual_seed(batch)
    N = hw[0] * hw[1]
    q, k, v = (torch.randn(batch, 16, N, 80, generator=g, device=card,
                           dtype=torch.bfloat16) for _ in range(3))
    th, tw = (torch.randn(2 * s - 1, 80, generator=g, device=card)
              * 80 ** -0.5 for s in hw)
    before = launches.read()
    got = attention.relpos_attention(q, k, v, th, tw, hw, 80 ** -0.5, kind)
    want = attention.relpos_attention_torch(q.float(), k.float(), v.float(),
                                            th, tw, hw, 80 ** -0.5)
    torch.cuda.synchronize()
    after = launches.read()
    assert after["relpos_attention_cuda", kind] \
        == before["relpos_attention_cuda", kind] + 1
    assert backends == [FUSED]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = (got.float() - want).abs().max().item()
    assert err < 3e-2 * want.abs().max().item(), err


@pytest.mark.cuda
def test_vit_h_forward_counts(card, backends):
    """A SAM ViT-H forward at b=2 with 3 boxes a frame, bf16: 28 windowed
    and 4 global rel-pos calls, every SDPA call held to the fused
    backends, 6 prompts counted, finite outputs."""
    cfg = ModelConfig(arch="sam", scale="h", input_size=(1024, 1024))
    model = sam.init_params(torch.Generator().manual_seed(0), cfg).to(card)
    x = torch.randn(2, 1024, 1024, 3, device=card)
    boxes = torch.tensor([[[0.0, 0.0, 500.0, 400.0]] * 3] * 2, device=card)
    launches.reset()
    with torch.no_grad():
        out = model(x, boxes)
    torch.cuda.synchronize()
    c = launches.read()
    assert c["relpos_attention_cuda", "window"] == 28
    assert c["relpos_attention_cuda", "global"] == 4
    assert c["sam_prompts"] == 6
    assert backends and all(a == FUSED for a in backends)
    assert out["masks"].shape == (2, 3, 4, 256, 256)
    assert torch.isfinite(out["masks"].float()).all()
