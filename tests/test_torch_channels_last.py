"""One layout: channels-last activations and conv weights from the stem
to the head (models/layers.channels_last and the weights made so).

On the CPU every conv epilogue of a forward sees a channels-last output,
and the outputs equal the same forward run NCHW (the layout helper
patched to dense NCHW) within float32 rounding. The weights keep the
layout through the ways a model is moved, cast and loaded, and a conv
given a weight in another layout computes the same. The x2 upsample is
bit-equal to repeating rows and columns, in either layout.

On the card (marker `cuda`; the file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_channels_last.py

a YOLO11x-seg and a YOLO12x-seg forward run no cuDNN layout transpose
and every conv epilogue on a channels-last output, the conv epilogue is
bit-equal at YOLO12x's 460 channels channels-last (its 8-byte path), and
a YOLO11n-seg b=1 forward launches no more kernels than before the
layout change.
"""
import copy

import pytest
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.weights import cast_params
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops import conv_epilogue as ce
from xrseg_tpu_torch.testing import epilogue_calls, limit_cpu_threads

limit_cpu_threads()

MODELS = {"yolo11n-seg": dict(scale="n"), "yolo11x-seg": dict(scale="x"),
          "yolo12l-seg": dict(arch="yolo12", scale="l")}
# the conv epilogues of one forward of each
EPILOGUES = {"yolo11n-seg": 100, "yolo11x-seg": 186, "yolo12l-seg": 224}


def _model(name, dtype="float32", hw=(64, 64)):
    cfg = ModelConfig(input_size=hw, dtype=dtype, **MODELS[name])
    return yolo11.init_params(torch.Generator().manual_seed(0), cfg).eval()


def _frames(hw=(64, 64), b=2):
    return torch.rand(b, *hw, 3, generator=torch.Generator().manual_seed(1))


def _forward(model, x):
    with torch.inference_mode():
        return model(x, concat_preds=False)


def _old_upsample(x):
    """The x2 upsample the network ran before: two repeat_interleaves,
    dense NCHW out."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _is_channels_last(t):
    return t.is_contiguous(memory_format=torch.channels_last)


def _nchw(x, dtype=None):
    """models/layers.channels_last's stand-in for an NCHW forward."""
    return x.to(dtype or x.dtype).contiguous()


def _weights(model):
    return [m.weight for m in model.modules() if isinstance(m, L.Conv)] + [
        m.up_w for m in model.modules() if isinstance(m, L.Proto)]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_is_channels_last_everywhere(name, monkeypatch):
    """Every epilogue of the forward sees a channels-last output, and the
    outputs equal the NCHW forward within float32 rounding."""
    model, x = _model(name), _frames()
    weights = _weights(model)
    assert all(_is_channels_last(w) for w in weights)
    assert any(not w.is_contiguous() for w in weights)
    calls = epilogue_calls(model, x)
    assert len(calls) == EPILOGUES[name]
    assert all(cl for *_, cl in calls), [i for i, (*_, cl) in
                                         enumerate(calls) if not cl]
    got = _forward(model, x)
    assert _is_channels_last(got["protos"].permute(0, 3, 1, 2))
    monkeypatch.setattr(L, "channels_last", _nchw)
    nchw = epilogue_calls(model, x)
    assert sum(cl for *_, cl in nchw) < len(nchw) // 2
    want = _forward(model, x)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(
            got[k], want[k], rtol=1e-5,
            atol=1e-5 * float(want[k].abs().max()), msg=k)


@pytest.mark.parametrize("move", ["to", "deepcopy", "cast_bfloat16",
                                  "load_state_dict"])
def test_weights_stay_channels_last(move):
    """The weights keep their layout however the model is moved, cast or
    loaded, so every conv of the forward still runs channels-last."""
    model, x = _model("yolo11n-seg"), _frames()
    if move == "to":
        model = model.to("cpu", torch.float32)
    elif move == "deepcopy":
        model = copy.deepcopy(model)
    elif move == "cast_bfloat16":
        model = cast_params(model, "bfloat16")
    else:
        state = {k: v.contiguous() for k, v in model.state_dict().items()}
        model = _model("yolo11n-seg")
        model.load_state_dict(state)
    assert all(_is_channels_last(w) for w in _weights(model))
    assert all(cl for *_, cl in epilogue_calls(model, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_takes_a_weight_in_any_layout(dtype):
    """A conv whose weight lost its layout (a parameter replaced in place,
    as a sharded or loaded one can be) computes bit for bit the same, on
    a channels-last output."""
    conv = L.Conv(6, 8, 3, dtype=dtype)
    conv.reset_parameters(torch.Generator().manual_seed(3))
    x = L.channels_last(torch.randn(2, 6, 9, 7))
    with torch.inference_mode():
        want = conv(x)
        conv.weight.data = conv.weight.data.contiguous()
        assert not _is_channels_last(conv.weight)
        got = conv(x)
    assert want.dtype == got.dtype == dtype
    assert _is_channels_last(got) and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 5, 7, 9), (1, 8, 4, 6), (3, 1, 1, 3)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [False, True])
def test_upsample_is_the_repeats_in_its_layout(shape, dtype, channels_last):
    """Bit-equal to repeating each row and each column twice, odd H and W
    included; a channels-last map stays channels-last, an NCHW one NCHW."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)
                    ).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    got = L.upsample2x_nearest(x)
    want = _old_upsample(x)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if channels_last:
        assert _is_channels_last(got)
    else:
        assert got.is_contiguous()


def test_channels_last_makes_a_channel_half_dense():
    """A strided channel half of a channels-last map becomes one dense
    channels-last copy with the same values, and a dense map is returned
    as it is."""
    y = torch.randn(2, 8, 5, 3).contiguous(memory_format=torch.channels_last)
    a, b = y.chunk(2, 1)
    assert not _is_channels_last(b)
    got = L.channels_last(b)
    assert _is_channels_last(got) and torch.equal(got, b)
    assert L.channels_last(y) is y


@pytest.mark.parametrize("block", ["Conv", "HeadConv", "Proto"])
def test_init_draws_the_weights_in_oihw_order(block):
    """A seed gives the weights it gave when they were OIHW in memory: the
    uniform draw lands in OIHW order in the channels-last weight."""
    m = {"Conv": lambda: L.Conv(6, 8, 3), "HeadConv": lambda: L.HeadConv(6, 8),
         "Proto": lambda: L.Proto(6, 8, 4)}[block]()
    m.reset_parameters(torch.Generator().manual_seed(4))
    w = m.up_w if block == "Proto" else m.weight
    assert _is_channels_last(w)
    g = torch.Generator().manual_seed(4)
    if block == "HeadConv":
        b = 1.0 / 6 ** 0.5
        want = torch.empty(w.shape).uniform_(-b * 3 ** 0.5, b * 3 ** 0.5,
                                             generator=g)
    else:
        fan = w.shape[1] * 9 if block == "Conv" else w.shape[0] * 4
        b = (1.0 / fan) ** 0.5 * 3 ** 0.5
        want = torch.empty(w.shape).uniform_(-b, b, generator=g)
    assert torch.equal(w.detach(), want)


def test_channels_last_casts_a_weight_in_one_copy():
    """An OIHW weight cast to the compute dtype comes out dense
    channels-last with the cast's values; a weight already so in that
    dtype is returned as it is."""
    w = torch.randn(8, 4, 3, 3)
    got = L.channels_last(w, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _is_channels_last(got)
    assert torch.equal(got, w.to(torch.bfloat16))
    assert L.channels_last(got, torch.bfloat16) is got
    cl = L.channels_last(w)
    assert L.channels_last(cl, torch.float32) is cl
    one = L.Conv(4, 8, 1).weight.detach().to(torch.bfloat16)
    assert L.channels_last(one, torch.bfloat16) is one


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# kernel launches of one YOLO11n-seg b=1 inference forward at 640x640 on the
# H100 before the layout change (NCHW maps after the first upsample, OIHW
# weights; PERF.md)
NCHW_B1_FORWARD_LAUNCHES = 487
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _card_model(cfg, card):
    """Built on the CPU and moved with Module.to, as a deployment does:
    the weights keep the layout they were made in."""
    model = yolo11.YOLO11(cfg).to(card).eval()
    assert all(_is_channels_last(w) for w in _weights(model))
    return model


def _profiled_forward(model, x):
    """(kernel names of one inference forward, the conv epilogue's launches
    and channels-last launches in it), after one forward to warm up."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        n, n_cl = (ce.conv_epilogue_cuda.launches,
                   ce.conv_epilogue_cuda.launches_channels_last)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (kernels, ce.conv_epilogue_cuda.launches - n,
            ce.conv_epilogue_cuda.launches_channels_last - n_cl)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,n", [
    ("yolo11x-seg", ModelConfig(scale="x"), 186),
    ("yolo12x-seg", ModelConfig(arch="yolo12", scale="x",
                                input_size=(960, 1280)), 224)],
    ids=["yolo11x-seg", "yolo12x-seg"])
def test_forward_runs_no_layout_transpose(card, name, cfg, n):
    """A b=2 forward of the benchmark's networks at their sizes: no cuDNN
    layout transpose, and every conv epilogue on a channels-last output."""
    model = _card_model(cfg, card)
    x = torch.rand(2, *cfg.input_size, 3, device=card)
    kernels, launches, launches_cl = _profiled_forward(model, x)
    transposes = [k for k in kernels if any(t in k for t in TRANSPOSES)]
    print(f"{name} b=2: {len(kernels)} kernels, {len(transposes)} layout "
          f"transposes, conv epilogue {launches_cl} of {launches} "
          "channels-last")
    assert kernels and not transposes, transposes[:4]
    assert launches == launches_cl == n


@pytest.mark.cuda
@pytest.mark.parametrize("shape,start", [
    ((2, 460, 60, 80), 0), ((2, 460, 30, 40), 0), ((3, 460, 7, 5), 0),
    ((2, 460, 30, 40), 4), ((2, 64, 20, 20), 4), ((2, 12, 9, 7), 0)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else
    f"start{v}")
@pytest.mark.parametrize("act", [True, False])
def test_epilogue_460_channels_last_is_bit_equal(card, shape, start, act):
    """The conv epilogue channels-last at C % 8 == 4 (YOLO12x's ABlock
    MLP) and at a start 8 bytes off a 16-byte boundary (the 8-byte
    vectors), and at C = 12 (the 8-byte vectors' remainder of 4): bit-equal
    to the composition, in place."""
    g = torch.Generator(device=card).manual_seed(sum(shape) + start)
    n = torch.Size(shape).numel()
    flat = torch.empty(n + start, dtype=torch.bfloat16, device=card)
    B, C, H, W = shape
    y = flat[start:].view(B, H, W, C).permute(0, 3, 1, 2)
    y.copy_(torch.randn(shape, generator=g, device=card) * 3)
    assert _is_channels_last(y) and y.data_ptr() % 16 == 2 * start % 16
    bias = torch.randn(C, generator=g, device=card)
    want = ce.conv_epilogue_torch(y, bias, act)
    before = ce.conv_epilogue_cuda.launches_channels_last
    got = ce.conv_epilogue_cuda(y, bias, act)
    torch.cuda.synchronize()
    assert ce.conv_epilogue_cuda.launches_channels_last == before + 1
    assert torch.equal(got.contiguous().view(torch.int16),
                       want.contiguous().view(torch.int16))


@pytest.mark.cuda
def test_b1_forward_launches_no_more_kernels(card):
    """The XR tick's network (YOLO11n-seg, b=1, 640x640) is host-bound: the
    layout must not add launches to its forward."""
    model = _card_model(ModelConfig(), card)
    x = torch.rand(1, 640, 640, 3, device=card)
    kernels, launches, launches_cl = _profiled_forward(model, x)
    print(f"yolo11n-seg b=1: {len(kernels)} kernel launches a forward "
          f"(before the layout change: {NCHW_B1_FORWARD_LAUNCHES}); conv "
          f"epilogue {launches_cl} of {launches} channels-last")
    assert launches == launches_cl == 100
    assert len(kernels) <= NCHW_B1_FORWARD_LAUNCHES
