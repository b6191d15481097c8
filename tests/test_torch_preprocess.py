"""Port preprocess (xrseg_tpu_torch/ops/preprocess.py) against
xrseg_tpu.ops.preprocess on the same uint8 frames.

Tolerances: float32 1e-6 absolute (both sides gather the same taps and
lerp in float32; only rounding order can differ). bfloat16 2^-7: one
bf16 step near 1.0 is 2^-8, and the two frameworks may round the lerp's
intermediate products at different places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import preprocess as jpre
from xrseg_tpu_torch.ops import preprocess as tpre
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("hw,out", [((48, 64), (32, 32)),    # downscale
                                    ((30, 20), (64, 96)),    # upscale
                                    ((32, 32), (32, 32)),    # identity
                                    ((37, 50), (32, 64))])   # mixed
def test_resize_normalize_f32(hw, out):
    f = _frames((2,) + hw + (3,))
    j = jpre.resize_normalize_bf16(jnp.asarray(f), out, dtype=jnp.float32)
    t = tpre.resize_normalize(torch.from_numpy(f), out, torch.float32)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_resize_normalize_bf16():
    f = _frames((1, 48, 64, 3))
    j = jpre.resize_normalize_bf16(jnp.asarray(f), (32, 40))
    t = tpre.resize_normalize(torch.from_numpy(f), (32, 40), torch.bfloat16)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j).astype(np.float32),
                               rtol=0, atol=2 ** -7)


def test_resize_is_not_interpolate():
    """On downscale the 2-tap plan differs from an antialiased resize; the
    port must follow the taps (checked against a direct numpy lerp)."""
    f = _frames((1, 64, 64, 3), seed=3)
    t = tpre.resize_normalize(torch.from_numpy(f), (16, 16),
                              torch.float32).numpy()
    i0, i1, w = tpre._tap_indices(64, 16)
    x = f[0].astype(np.float32) * np.float32(1 / 255)
    rows = x[i0] * (1 - w)[:, None, None] + x[i1] * w[:, None, None]
    ref = rows[:, i0] * (1 - w)[None, :, None] + rows[:, i1] * w[None, :,
                                                                 None]
    np.testing.assert_allclose(t[0], ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["stretch", "letterbox"])
@pytest.mark.parametrize("hw", [(48, 64), (64, 40)])
def test_preprocess_modes(mode, hw):
    f = _frames((2,) + hw + (3,), seed=1)
    j = jpre.preprocess(jnp.asarray(f), (64, 64), mode=mode,
                        dtype=jnp.float32)
    t = tpre.preprocess(torch.from_numpy(f), (64, 64), mode=mode,
                        dtype=torch.float32)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_preprocess_rejects_bad_input():
    with pytest.raises(ValueError, match="B,H,W,3"):
        tpre.preprocess(torch.zeros(4, 4, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="mode"):
        tpre.preprocess(torch.zeros(1, 4, 4, 3, dtype=torch.uint8),
                        (4, 4), mode="crop")


@pytest.mark.parametrize("mode", ["stretch", "letterbox"])
def test_boxes_to_frame_space(mode):
    b = np.random.default_rng(2).uniform(0, 640, (3, 5, 4)).astype(
        np.float32)
    assert tpre.letterbox_params((480, 640), (640, 640)) == \
        jpre.letterbox_params((480, 640), (640, 640))
    np.testing.assert_array_equal(
        tpre.boxes_to_frame_space(torch.from_numpy(b), (480, 640),
                                  mode=mode),
        jpre.boxes_to_frame_space(b, (480, 640), mode=mode))
