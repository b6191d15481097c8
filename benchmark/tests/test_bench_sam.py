"""The SAM cell: a whole run on the CPU at a small size (the published
structure at embed 64, depth 4, 4 heads, global blocks 1 and 3, windows of
4 over 10x10 tokens, decoder width 32; 96x128 frames) reads correct=True,
and reads correct=False with the program broken underneath: the rel-pos
bias dropped, the windows' pad tokens masked out as keys, the global
blocks at other indexes, the boxes left in frame pixels, and a tanh GELU
(which only the float32 program's number sees). The count follows from
shapes and agrees with torch's FLOP counter over the program on the meta
device; the cell's readers read the trace's ranges.
"""
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run as bench_run
from benchmark.harness import common
from benchmark.harness import sam as sam_h

CELL = "sam-vit-h.batch8_box16_960x1280"
SMALL = {"encoder_embed_dim": 64, "encoder_depth": 4, "encoder_num_heads": 4,
         "encoder_global_attn_indexes": [1, 3], "image_size": 160,
         "window_size": 4, "prompt_embed_dim": 32, "decoder_mlp_dim": 64,
         "iou_head_hidden_dim": 32, "dtype": "float32", "frame_hw": [96, 128]}
SEED = 2 ** 31 + 11


def run_cell():
    torch.set_num_threads(2)
    return bench_run.execute(CELL, SEED, 0.3, False, device="cpu",
                             t_start=0.0, cfg_override=SMALL)


def test_clean_is_correct():
    """Correct, and the float32 program's errors far under the bf16
    witness's."""
    res = run_cell()
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_per_s"]["value"] > 0
    for name in ("mask_err_rel", "iou_err_rel", "f32_mask_err_rel"):
        assert res["checks"][name]["value"] < 1e-3, res["checks"]
    assert res["checks"]["mask_miss"]["value"] == 0
    checked = res["diagnostics"]["prompts_checked"]
    assert checked > 0 and checked % (8 * 16) == 0
    assert res["diagnostics"]["mask_sure"] > 0


def _no_bias(monkeypatch):
    from xrseg_tpu_torch.models import sam
    orig = sam.relpos_attention
    monkeypatch.setattr(sam, "relpos_attention",
                        lambda q, k, v, th, tw, *a: orig(q, k, v, th * 0,
                                                         tw * 0, *a))


def _pad_keys_masked(monkeypatch):
    """The windows' pad tokens masked out of every windowed attention."""
    from xrseg_tpu_torch.models import sam
    from xrseg_tpu_torch.ops import attention
    real = {}

    def partition(x, ws):
        B, H, W, _ = x.shape
        win, (Hp, Wp) = attention.window_partition(x, ws)
        m = torch.zeros(B, Hp, Wp, dtype=torch.bool)
        m[:, :H, :W] = True
        real["keys"] = m.view(B, Hp // ws, ws, Wp // ws, ws).permute(
            0, 1, 3, 2, 4).reshape(-1, ws * ws)
        return win, (Hp, Wp)

    def attend(q, k, v, th, tw, hw, scale, kind):
        if kind != "window":
            return attention.relpos_attention(q, k, v, th, tw, hw, scale,
                                              kind)
        B, nh, N, _ = q.shape
        rel_h, rel_w = attention._rel_terms(q, th, tw, hw, torch.float32)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            B, nh, N, N)
        mask = torch.where(real["keys"], 0.0, -math.inf)[:, None, None, :]
        s = (q.float() * scale) @ k.float().transpose(-2, -1) + bias + mask
        return (s.softmax(-1) @ v.float()).to(q.dtype)

    monkeypatch.setattr(sam, "window_partition", partition)
    monkeypatch.setattr(sam, "relpos_attention", attend)


def _globals_shifted(monkeypatch):
    """The global blocks one later (1, 3 -> 2, 0): their tables resized
    as SAM resizes a table of another length."""
    from xrseg_tpu_torch.models import sam
    orig = sam.ImageEncoderViT.__init__

    def init(self, spec):
        orig(self, spec)
        n = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            blk.window_size = 0 if (i - 1) % n in spec.global_attn_indexes \
                else spec.window_size

    monkeypatch.setattr(sam.ImageEncoderViT, "__init__", init)


def _boxes_in_frame_pixels(monkeypatch):
    from xrseg_tpu_torch.ops import preprocess
    monkeypatch.setattr(preprocess, "sam_boxes",
                        lambda boxes, hw, size: boxes.float())


def _tanh_gelu(monkeypatch):
    from xrseg_tpu_torch.models import sam
    monkeypatch.setattr(sam, "_gelu",
                        lambda x: F.gelu(x, approximate="tanh"))


@pytest.mark.parametrize("fault", [_no_bias, _pad_keys_masked,
                                   _globals_shifted, _boxes_in_frame_pixels,
                                   _tanh_gelu], ids=lambda f: f.__name__)
def test_fault_reads_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = run_cell()
    assert not res["correct"], res["checks"]


def test_count_matches_torch_flop_counter():
    """pipeline_counts' FLOPs are those torch's FLOP counter reads from
    the program's forward on the meta device (the plain attention's
    products, every linear, conv and matmul), but for the positional
    encodings' [.., 2] @ [2, d/2] products, which the count leaves out."""
    from xrseg_tpu_torch.models import sam
    cfg = {**common.load_json("configs", "sam-vit-h"), **SMALL}
    B, P = 2, 3
    with torch.device("meta"):
        model = sam.SAM(sam_h.model_config(cfg), sam_h.spec(cfg))
    S, g, d = cfg["image_size"], cfg["image_size"] // 16, 32
    with FlopCounterMode(display=False) as fc:
        model(torch.empty(B, S, S, 3, device="meta"),
              torch.empty(B, P, 4, device="meta"))
    pe = 2 * g * g * 2 * (d // 2) + 2 * (B * P * 2) * 2 * (d // 2)
    assert sam_h.pipeline_counts(cfg, B, P)["flops"] \
        == fc.get_total_flops() - pe


def test_counted_matches_the_configuration():
    """The configuration file's `counted` is what the count gives."""
    cfg = common.load_json("configs", "sam-vit-h")
    got = sam_h.config_numbers(cfg)
    for k, v in got.items():
        assert abs(cfg["counted"][k] - v) < 0.01, (k, v)


def test_readers():
    """The two new readers: least time x steps over the range's busy
    time, and the decoder range's busy time a batch; None without the
    ranges (a program that opens none)."""
    roof = common.load_module("metrics", "relpos_attn_roofline.batch")
    dec = common.load_module("metrics", "sam_decoder_ms.batch")
    run = {"trace_steps": 10, "relpos_least_s": 0.002,
           "trace": {"ranges": {"xrseg.relpos_attn": {"device_s": 0.1,
                                                      "count": 320},
                                "xrseg.sam_decoder": {"device_s": 0.05,
                                                      "count": 10}}}}
    assert roof.read(run) == pytest.approx(20.0)
    assert dec.read(run) == pytest.approx(5.0)
    empty = {"trace_steps": 10, "relpos_least_s": 0.002,
             "trace": {"ranges": {"xrseg.relpos_attn": {"device_s": 0.0,
                                                        "count": 0}}}}
    assert roof.read(empty) is None and dec.read(empty) is None
    assert roof.read({}) is None and dec.read({}) is None


def test_the_parent_fails_at_once(monkeypatch):
    """A program without models.sam stops the driver before any work."""
    import builtins
    real_import = builtins.__import__

    def no_sam(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "xrseg_tpu_torch.models" and fromlist \
                and "sam" in fromlist:
            raise ImportError("no models.sam")
        return real_import(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_sam)
    with pytest.raises(ImportError):
        bench_run.execute(CELL, SEED, 0.3, False, device="cpu", t_start=0.0,
                          cfg_override=SMALL)


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """The fp8 control reads correct=False at the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.harness import control
    from benchmark.tools import control_sam
    cell, cfg = common.cell_config(CELL)
    nums = control_sam.readings(cell, cfg, SEED, "cuda", "fp8")
    assert not control.judge(cell, nums)[0], nums
