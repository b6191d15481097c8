"""The conv epilogue (ops/conv_epilogue.py, csrc/conv_epilogue.cu): bias,
SiLU and the rounding to bf16 after each conv in one pass.

On the CPU: the plain version is the four-op composition conv_apply ran
before it; conv_apply and conv_transpose_apply take that composition for
CPU tensors, float32 compute and any gradient (through the conv, or to
a trainable bias alone), launching nothing; the wrapper refuses what the
kernel does not take, CPU tensors too; and an exported program holds the
custom op.

On the card (marker `cuda`; the file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_conv_epilogue.py

the kernel is bit-equal to the composition at every epilogue shape of
YOLO11n-seg, YOLO11x-seg and YOLO12x-seg, on special values, on its scalar path and
through whole forwards, and a forward launches it once an epilogue.
"""
import pytest
import torch
import torch.nn.functional as F

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.ops import conv_epilogue as ce
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.testing import epilogue_calls, limit_cpu_threads

limit_cpu_threads()


def composition(y, bias, act):
    """What conv_apply and conv_transpose_apply ran before the kernel."""
    out = y.float() + bias.float()[:, None, None]
    if act:
        out = F.silu(out)
    return out.to(y.dtype)


def _inputs(shape, dtype, channels_last=False, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=g) * 3).to(dtype)
    bias = torch.randn(shape[1], generator=g)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    return y.to(device), bias.to(device)


def _bits(t):
    return t.contiguous().view(torch.int16)


def _small_conv(act, dtype, groups=1):
    conv = L.Conv(8, 16 if groups == 1 else 8, 3, act=act, groups=groups,
                  dtype=dtype)
    conv.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(2))
    return conv


# ---------------------------------------------------------------------------
# CPU: the plain version, the dispatch, the refusals, the export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [True, False])
def test_plain_version_is_the_composition(act, dtype, channels_last):
    y, bias = _inputs((2, 16, 6, 10), dtype, channels_last)
    got = ce.conv_epilogue_torch(y, bias, act)
    want = composition(y, bias, act)
    assert got.dtype == dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["conv", "conv_act", "depthwise",
                                  "transposed"])
@pytest.mark.parametrize("grad", [False, True, "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_float32_and_grad_take_the_composition(kind, grad, dtype,
                                                   monkeypatch):
    """conv_apply and conv_transpose_apply on CPU tensors (bf16 and float32
    compute; no gradient, every gradient, or the bias's alone with the
    weight frozen) equal conv + the composition, never reach the kernel's
    wrapper, and launch nothing; a trainable bias gets its gradient."""
    def refuse(*a):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(L, "conv_epilogue_cuda", refuse)
    before = launches.read()["conv_epilogue_cuda"]
    x = torch.randn(2, 8, 12, 12, generator=torch.Generator().manual_seed(3))
    with torch.set_grad_enabled(bool(grad)):
        if kind == "transposed":
            proto = L.Proto(8, 8, 4, dtype=dtype)
            proto.reset_parameters(torch.Generator().manual_seed(4))
            with torch.no_grad():
                proto.up_b.uniform_(-1, 1)
            w, b = proto.up_w, proto.up_b
            w.requires_grad_(grad != "bias")
            got = L.conv_transpose_apply(proto, x.to(dtype), w, b)
            want = composition(
                F.conv_transpose2d(x.to(dtype), w.to(dtype), None, stride=2),
                b, False)
        else:
            conv = _small_conv(kind == "conv_act", dtype,
                               8 if kind == "depthwise" else 1)
            conv.weight.requires_grad_(grad != "bias")
            b = conv.bias
            got = conv(x)
            want = composition(F.conv2d(x.to(dtype), conv.weight.to(dtype),
                                        None, 1, 1, 1, conv.groups),
                               conv.bias, conv.act)
    assert got.requires_grad == bool(grad)
    assert torch.equal(got, want)
    assert launches.read()["conv_epilogue_cuda"] == before
    if grad:
        got.float().sum().backward()
        assert b.grad is not None and bool(b.grad.abs().sum() > 0)


def _refused_cases():
    y, bias = _inputs((2, 16, 4, 8), torch.bfloat16)
    return {
        "float32 y": (y.float(), bias, TypeError),
        "float16 y": (y.half(), bias, TypeError),
        "bf16 bias": (y, bias.bfloat16(), TypeError),
        "strided y": (y[..., ::2], bias, ValueError),
        "transposed y": (y.transpose(2, 3), bias, ValueError),
        "short bias": (y, bias[:-1], ValueError),
        "long bias": (y, torch.cat([bias, bias[:1]]), ValueError),
        "strided bias": (y, torch.randn(32)[::2], ValueError),
        "3-d y": (y[0], bias, ValueError),
        "cpu y": (y, bias, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    y, bias, err = _refused_cases()[case]
    before = launches.read()["conv_epilogue_cuda"]
    with pytest.raises(err):
        ce.conv_epilogue_cuda(y, bias, True)
    assert launches.read()["conv_epilogue_cuda"] == before


class _Epilogue(torch.nn.Module):
    def __init__(self, act):
        super().__init__()
        self.act = act
        self.bias = torch.nn.Parameter(torch.linspace(-1, 1, 16))

    def forward(self, y):
        return ce.conv_epilogue_cuda(y, self.bias.detach(), self.act)


@pytest.mark.parametrize("act", [True, False])
def test_export_holds_the_custom_op(act):
    """A traced tensor goes through xrseg::conv_epilogue (on the card the
    op launches the kernel), and the exported program computes the
    composition."""
    y, _ = _inputs((2, 16, 4, 8), torch.bfloat16)
    mod = _Epilogue(act)
    with torch.no_grad():
        program = torch.export.export(mod, (y,), strict=False)
    assert "xrseg.conv_epilogue" in str(program.graph)
    got = program.module()(y)
    assert torch.equal(got, composition(y, mod.bias.detach(), act))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _kernel_equals_composition(y, bias, act):
    want = composition(y, bias, act)
    got = ce.conv_epilogue_cuda(y.clone(memory_format=torch.preserve_format),
                                bias, act)
    torch.cuda.synchronize()
    assert got.stride() == want.stride()
    assert torch.equal(_bits(got), _bits(want)), (tuple(y.shape), act)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("scale", ["n", "x"])
def test_every_epilogue_shape_is_bit_equal(card, scale, batch):
    """Every distinct (C, H, W, act) that a 640x640 forward runs, at this
    batch, in the layout the forward gives it and in the other one."""
    model = yolo11.YOLO11(ModelConfig(scale=scale)).to(card)
    x = torch.zeros(1, 640, 640, 3, device=card)
    shapes = sorted({(s[1:], act, cl) for s, act, cl in
                     epilogue_calls(model, x)})
    for i, (chw, act, channels_last) in enumerate(shapes):
        for layout in (channels_last, not channels_last):
            y, bias = _inputs((batch, *chw), torch.bfloat16, layout, seed=i,
                              device=card)
            _kernel_equals_composition(y, bias, act)
    print(f"{scale} b={batch}: {len(shapes)} distinct epilogues, "
          f"{sum(cl for *_, cl in shapes)} channels-last")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_every_yolo12x_epilogue_shape_is_bit_equal(card, batch):
    """The same for YOLO12x-seg at its cell's 960x1280, whose ABlock MLP
    is 460 channels wide (not a multiple of 8: the scalar path when
    channels-last); b=8, since the inputs are drawn on the host."""
    model = yolo11.YOLO11(ModelConfig(arch="yolo12", scale="x",
                                      input_size=(960, 1280))).to(card)
    x = torch.zeros(1, 960, 1280, 3, device=card)
    shapes = sorted({(s[1:], act, cl) for s, act, cl in
                     epilogue_calls(model, x)})
    assert any(chw[0] == 460 for chw, _, _ in shapes)
    for i, (chw, act, channels_last) in enumerate(shapes):
        for layout in (channels_last, not channels_last):
            y, bias = _inputs((batch, *chw), torch.bfloat16, layout, seed=i,
                              device=card)
            _kernel_equals_composition(y, bias, act)
    print(f"yolo12x b={batch}: {len(shapes)} distinct epilogues, "
          f"{sum(cl for *_, cl in shapes)} channels-last")


def _special_values(device):
    """±inf, NaN, ±0, the largest and smallest bf16 normals, subnormals,
    and values around ±88 where expf(-x) over- and underflows."""
    vals = [float("inf"), -float("inf"), float("nan"), 0.0, -0.0,
            3.3895e38, -3.3895e38, 1.1755e-38, -1.1755e-38, 9.2e-41,
            -9.2e-41, 1e-45, 87.0, 88.0, 88.7, 89.0, -87.0, -88.0, -88.7,
            -89.0, -103.0, -104.0, 1e-3, -1e-3, 0.5, -0.5]
    v = torch.tensor(vals).to(torch.bfloat16)
    return torch.cat([v, -v, v.roll(3)]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [True, False])
def test_special_values(card, act):
    """Bit-equal on every special value, NaN compared by NaN-ness only;
    biases of 0, ±0 and ±88 reach the SiLU's edges from each side."""
    v = _special_values(card)
    n = v.numel()
    y = v.reshape(1, 1, 1, n).expand(2, 8, 8, n).contiguous()
    bias = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 88.0, -88.0, 1.0, -1.0],
                        device=card)
    want = composition(y, bias, act)
    got = ce.conv_epilogue_cuda(y.clone(), bias, act)
    torch.cuda.synchronize()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


SCALAR_CASES = {"odd_plane_7x7": (3, 24, 7, 7),
                "odd_plane_14x14": (2, 40, 14, 14),
                "odd_plane_5x3": (2, 16, 5, 3),
                "unaligned_start": (2, 16, 8, 8),
                "channels_last_odd_c": (2, 12, 8, 8), "tiny": (1, 1, 1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCALAR_CASES))
@pytest.mark.parametrize("act", [True, False])
def test_scalar_path(card, case, act):
    """An H*W that is not a multiple of 8, a start off a 16-byte boundary,
    channels-last with C % 8 != 0: the scalar path, still bit-equal."""
    shape = SCALAR_CASES[case]
    y, bias = _inputs(shape, torch.bfloat16,
                      case == "channels_last_odd_c", device=card)
    if case == "unaligned_start":
        flat = torch.empty(y.numel() + 1, dtype=y.dtype, device=card)
        flat[1:] = y.reshape(-1)
        y = flat[1:].view(shape)
        assert y.data_ptr() % 16 and y.is_contiguous()
    want = composition(y, bias, act)
    got = ce.conv_epilogue_cuda(y, bias, act)       # in place, unaligned too
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["n", "x"])
def test_forward_is_bit_equal_and_launches_once_an_epilogue(card, scale):
    """A b=2 forward under inference_mode runs the kernel once for each
    Conv and Proto module (186 for YOLO11x-seg) and equals, bit for bit,
    the same forward with gradients on, which takes the composition and
    launches nothing."""
    from xrseg_tpu_torch.testing import detection_params
    cfg = ModelConfig(scale=scale)
    model = detection_params(torch.Generator().manual_seed(0), cfg,
                             device=card)
    n = sum(isinstance(m, (L.Conv, L.Proto)) for m in model.modules())
    x = torch.rand(2, 640, 640, 3, generator=torch.Generator().manual_seed(1)
                   ).to(card)
    before = launches.read()["conv_epilogue_cuda"]
    with torch.inference_mode():
        fast = model(x, concat_preds=False)
    torch.cuda.synchronize()
    assert launches.read()["conv_epilogue_cuda"] - before == n
    for p in model.parameters():
        p.requires_grad_(True)
    before = launches.read()["conv_epilogue_cuda"]
    with torch.enable_grad():
        slow = model(x, concat_preds=False)
    torch.cuda.synchronize()
    assert launches.read()["conv_epilogue_cuda"] == before
    assert fast.keys() == slow.keys()
    for k in fast:
        a, b = fast[k], slow[k].detach()
        assert a.dtype == b.dtype and torch.equal(a, b), k
    print(f"{scale}: {n} epilogues a forward, outputs bit-equal")
    if scale == "x":
        assert n == 186


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv_act", "transposed"])
def test_trainable_bias_alone_takes_the_composition(card, kind):
    """The weight frozen and only the bias trainable (a bias-only
    fine-tune), in grad mode: no launch, the composition's output, and the
    bias gets its gradient."""
    bf16 = torch.bfloat16
    x = torch.randn(2, 8, 12, 12, generator=torch.Generator().manual_seed(3)
                    ).to(card, bf16)
    before = launches.read()["conv_epilogue_cuda"]
    if kind == "transposed":
        proto = L.Proto(8, 8, 4, dtype=bf16)
        proto.reset_parameters(torch.Generator().manual_seed(4))
        proto.to(card)
        w, b = proto.up_w, proto.up_b
        w.requires_grad_(False)
        with torch.enable_grad():
            got = L.conv_transpose_apply(proto, x, w, b)
        y = F.conv_transpose2d(x, w.to(bf16), None, stride=2)
        act = False
    else:
        conv = _small_conv(True, bf16).to(card)
        w, b = conv.weight, conv.bias
        w.requires_grad_(False)
        with torch.enable_grad():
            got = conv(x)
        y = F.conv2d(x, w.to(bf16), None, 1, 1, 1, 1)
        act = True
    torch.cuda.synchronize()
    assert launches.read()["conv_epilogue_cuda"] == before
    assert got.requires_grad
    want = composition(y, b.detach(), act)
    assert torch.equal(_bits(got.detach()), _bits(want))
    got.float().sum().backward()
    assert b.grad is not None and bool(b.grad.abs().sum() > 0)


@pytest.mark.cuda
def test_batch_pipeline_launches_the_kernel_for_every_epilogue(card):
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.config import ExecutorConfig
    cfg = ExecutorConfig(model=ModelConfig(scale="x"))
    model = yolo11.YOLO11(cfg.model)
    n = sum(isinstance(m, (L.Conv, L.Proto)) for m in model.modules())
    pipe = build_pipeline(cfg, model, frame_hw=(480, 640), batch=2,
                          device=card).warmup()
    before = launches.read()["conv_epilogue_cuda"]
    pipe(pipe.dummy_input())["slate"].cpu()
    assert launches.read()["conv_epilogue_cuda"] - before == n == 186
