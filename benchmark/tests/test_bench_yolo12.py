"""The YOLO12 cell: a whole run on the CPU at a small size (YOLO12l's
layers, which have the gamma residual and the 1.2x MLP, at 64x64) reads
correct=True, and reads correct=False with the program's area attention
broken underneath: attention across the whole map instead of per area,
q/k/v split along the NCHW channels instead of per head, pe applied to
x instead of v, gamma dropped; and with the last row's masks inverted,
which mask_err_rel alone catches. The count's attention and the cell's
readers follow from shapes and from the trace. The card's control is
marked `cuda` (it skips here, deciding inside the test):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_yolo12.py
"""
import copy
import importlib.util

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import arch, common, control, counts
from benchmark.harness.ranges import reduce_ranges

CELL = "yolo12x-seg.batch32_960x1280"
SMALL = {"input_size": [64, 64], "frame_hw": [48, 64], "dtype": "float32",
         "scale": "l", "depth_multiple": 1.0, "width_multiple": 1.0,
         "max_channels": 512}
SEED = 2 ** 31 + 7


def run_cell():
    torch.set_num_threads(2)
    return bench_run.execute(CELL, SEED, 0.5, False, device="cpu",
                             t_start=0.0, cfg_override=SMALL)


def test_clean_is_correct():
    """Correct, and the float32 program's score and mask errors far under
    the bf16 witness's."""
    res = run_cell()
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_per_s"]["value"] > 0
    for name in ("score_err_rel", "mask_err_rel"):
        assert res["checks"][name]["value"] < 0.01, res["checks"]


def _whole_map(monkeypatch):
    """Every AAttn attends over the whole map, whatever its areas."""
    from xrseg_tpu_torch.models import layers as L
    orig = L.AAttn.forward

    def forward(self, x):
        area, self.area = self.area, 1
        try:
            return orig(self, x)
        finally:
            self.area = area

    monkeypatch.setattr(L.AAttn, "forward", forward)


def _nchw_split(monkeypatch):
    """q, k and v taken as the first, second and third C channels of the
    qkv conv's NCHW output, then cut into heads."""
    from xrseg_tpu_torch.models import layers as L
    from xrseg_tpu_torch.ops.attention import area_attention

    def forward(self, x):
        B, C, H, W = x.shape
        a, nh, hd = self.area, self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(B, nh, hd, H * W).transpose(2, 3).reshape(
                B, nh, a, H * W // a, hd).transpose(1, 2).reshape(
                B * a, nh, H * W // a, hd)

        q, k, v = (heads(t) for t in self.qkv(x).chunk(3, 1))
        o = area_attention(q, k, v, hd ** -0.5)
        o = o.transpose(1, 2).reshape(B, H, W, C).permute(0, 3, 1, 2)
        v = v.transpose(1, 2).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj(o + self.pe(v))

    monkeypatch.setattr(L.AAttn, "forward", forward)


def _pe_on_x(monkeypatch):
    """The positional conv reads the block's input instead of v."""
    from xrseg_tpu_torch.models import layers as L
    orig = L.AAttn.forward

    class PeOnX(torch.nn.Module):
        def __init__(self, pe, x):
            super().__init__()
            self.pe, self.x = pe, x

        def forward(self, v):
            return self.pe(self.x)

    def forward(self, x):
        pe = self.pe
        self.pe = PeOnX(pe, x)
        try:
            return orig(self, x)
        finally:
            self.pe = pe

    monkeypatch.setattr(L.AAttn, "forward", forward)


def _no_gamma(monkeypatch):
    """A2C2f's residual adds its output unscaled: gamma dropped."""
    from xrseg_tpu_torch.models import layers as L
    orig = L.A2C2f._forward

    def _forward(self, x):
        gamma, self.gamma = self.gamma, None
        try:
            y = orig(self, x)
        finally:
            self.gamma = gamma
        return y if gamma is None else x + y

    monkeypatch.setattr(L.A2C2f, "_forward", _forward)


def _masks_inverted(monkeypatch):
    """The last row's masks inverted where the pipeline makes them, after
    the attention: only the masks are wrong."""
    from xrseg_tpu_torch import compile as comp
    orig = comp.CompiledPipeline.run

    def run(self, *frames):
        det = orig(self, *frames)
        det["masks"][-1] = 1.0 - det["masks"][-1]
        return det

    monkeypatch.setattr(comp.CompiledPipeline, "run", run)


@pytest.mark.parametrize("fault", [_whole_map, _nchw_split, _pe_on_x,
                                   _no_gamma], ids=lambda f: f.__name__)
def test_attention_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = run_cell()
    assert not res["correct"], res["checks"]


def test_masks_inverted_is_caught_by_the_masks(monkeypatch):
    """The slate is sound and only the masks' number fails."""
    _masks_inverted(monkeypatch)
    res = run_cell()
    failed = {k for k, c in res["checks"].items()
              if not c["value"] <= c["limit"]}
    assert failed == {"mask_err_rel"}, res["checks"]


def test_attention_count_by_hand():
    """The cell's step (b=32, 960x1280): 8 P4 calls over 4 areas of 1200
    tokens and 8 P5 calls over 1200, 12 heads of 32; the attention's
    least time is its FLOPs over the peak (compute-bound)."""
    cell, cfg = common.cell_config(CELL)
    c = arch.pipeline_counts(cfg, 32)
    flops = 4 * 32 * 12 * 1200 ** 2 * 32 * (8 * 4 + 8 * 1)
    assert flops == 2831155200000
    assert c["attn_least_s"] == pytest.approx(flops / counts.PEAK_FLOPS)
    fwd = arch.reference(cfg).count_forward(cfg, 32)
    assert sum(f for kind, f, *_ in fwd.layers
               if kind == "attention") == flops
    assert c["least_s"] > c["attn_least_s"]


def _reader(name):
    path = common.find("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_ranges_and_their_readers():
    """Device busy time inside each program range, from a hand-made trace:
    a kernel half inside a range counts its inside half; the readers give
    None where no range was traced (as on the parent, or on the CPU)."""
    W = "bench.window"
    events = [("cpu", W, 0, 1000, 1, True),
              ("dev", "gemm", 100, 300, 2, False),
              ("dev", "flash_fwd", 400, 600, 2, False),
              ("dev", "xrseg.area_attn", 350, 500, 2, True),
              ("dev", "xrseg.a2c2f", 50, 700, 2, True),
              ("dev", "xrseg.area_attn", 550, 650, 2, True)]
    r = reduce_ranges(events, ("xrseg.area_attn", "xrseg.a2c2f", "none"))
    assert r == {"xrseg.area_attn": {"device_s": 150e-9, "count": 2},
                 "xrseg.a2c2f": {"device_s": 400e-9, "count": 1},
                 "none": {"device_s": 0.0, "count": 0}}
    run = {"trace": {"ranges": r}, "trace_steps": 2, "attn_least_s": 30e-9}
    assert _reader("attn_roofline.batch")(run) == pytest.approx(40.0)
    assert _reader("a2c2f_ms.batch")(run) == pytest.approx(200e-9 * 1e3)
    for name in ("attn_roofline.batch", "a2c2f_ms.batch"):
        assert _reader(name)({"trace": {"busy_s": 1.0}, "trace_steps": 2,
                              "attn_least_s": 1e-3}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 977])
def test_control_is_not_correct(seed):
    """The reference in fp8, in the program's place, at b=8, fails one of
    the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.tools.control_arch import readings
    cell, cfg = common.cell_config(CELL)
    cell = copy.deepcopy(cell)
    cell["params"]["batch"] = 8
    nums = readings(cell, cfg, seed, "cuda",
                    control.QUANT_BELOW[cfg["dtype"]])
    correct, rows = control.judge(cell, nums)
    assert not correct, f"the control passed every limit: {rows}"
