"""Card-only tests of the port's CUDA kernels (marker `cuda`).

A CUDA kernel has no interpret mode, so these skip on a host without a
card. The file imports neither JAX nor the JAX package, so it also runs
on the card's machine, which has no JAX; tests/conftest.py imports JAX,
hence --noconftest there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Every check is exact: the kernels must give the plain versions' idx/ok.
"""
import numpy as np
import pytest
import torch

from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.ops import nms as tnms
from xrseg_tpu_torch.ops import nms_kernels as tk
from xrseg_tpu_torch.testing import detection_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _inputs(seed, B, K, ties=False, zero_area=False, empty_last=False):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(4, 120, (B, K, 2))
    if zero_area:
        wh[:, ::7, 0] = 0.0
    boxes = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 640, (B, K, 2)), wh], -1).astype(np.float32))
    scores = torch.from_numpy(rng.normal(0, 1.5, (B, K)).astype(np.float32))
    if ties:
        scores = scores.bfloat16().float()
    if empty_last:
        scores[-1] = -10.0
    labels = torch.from_numpy(rng.integers(0, 4, (B, K)))
    corners = tnms.class_corners(boxes, labels, True)
    masked = torch.where(scores > -1.2, scores, tk.NEG)
    return corners, masked


CASES = {"random": {}, "ties": dict(ties=True),
         "zero_area": dict(zero_area=True), "empty": dict(empty_last=True)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B,K", [(1, 8400), (5, 8400), (3, 257), (2, 1)])
def test_k1_equals_plain(card, case, B, K):
    c, m = (t.to(card) for t in _inputs(B * K, B, K, **CASES[case]))
    got = tk.nms_select_batched_cuda(c, m, 0.45, 50)
    ref = tk.nms_select_batched_torch(c, m, 0.45, 50)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("K", [8400, 1024, 33])
def test_k2_equals_plain(card, case, K):
    c, m = (t.to(card) for t in _inputs(K, 1, K, **CASES[case]))
    before = tk.nms_select_cuda.launches
    got = tk.nms_select_cuda(c[0], m[0], 0.6, 50)
    ref = tk.nms_select_torch(c[0], m[0], 0.6, 50)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert tk.nms_select_cuda.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    c, m = (t.to(card) for t in _inputs(0, 1, 64))
    with pytest.raises(TypeError, match="float32"):
        tk.nms_select_batched_cuda(c.double(), m, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tk.nms_select_batched_cuda(c[:, ::2], m[:, ::2], 0.5)
    big = 1 << 16
    cb = torch.zeros((1, big, 4), device=card)
    mb = torch.zeros((1, big), device=card)
    with pytest.raises(ValueError, match="shared-memory limit"):
        tk.nms_select_batched_cuda(cb, mb, 0.5)


def test_pipeline_goes_through_the_kernels(card):
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    scan = ExecutorConfig(model=cfg.model,
                          post=PostprocessConfig(nms_backend="scan"))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3),
                                               np.uint8)
    before = tk.nms_select_batched_cuda.launches
    got = build_pipeline(cfg, model, frame_hw=(96, 128), batch=2)(frames)
    assert tk.nms_select_batched_cuda.launches == before + 1
    ref = build_pipeline(scan, model, frame_hw=(96, 128), batch=2)(frames)
    assert torch.equal(got["slate"], ref["slate"])
    assert int(got["count"].min()) == 50
