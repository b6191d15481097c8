"""The port's RGBD fusion (xrseg_tpu_torch/ops/depth_fusion.py) against the
JAX extract_points and the scalar numpy oracle on the same numpy-seeded
inputs, on the CPU.

Tolerances: `valid` must be EQUAL (threshold tests on the same float32
values); positions and depths within 1e-5 absolute: both sides compute in
float32 in the same order, XLA may fuse a multiply-add, and the numpy
oracle works in float64 between its float32 roundings. Depths are fp16
values and compare exactly against JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import depth_fusion as jdf
from xrseg_tpu_torch.ops import depth_fusion as tdf
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

ATOL = 1e-5
FOCAL = np.array([440.0, 440.0], np.float32)
PRINCIPAL = np.array([640.0, 480.0], np.float32)
SENSOR = np.array([1280.0, 960.0], np.float32)
IDENT = np.array([0, 0, 0, 1], np.float32)
ROTATED = np.array([0.1825742, 0.3651484, 0.5477226, 0.7302967], np.float32)


def _scene(seed, mask_hw=(32, 32), depth_hw=(32, 32)):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 1, mask_hw).astype(np.float32)
    depth = rng.uniform(0.05, 3.5, depth_hw).astype(np.float16)
    # depths AT both range limits (excluded: the tests are strict) and
    # beyond them
    depth.flat[:6] = [0.1, 3.0, 0.0999, 3.002, 0.1001, 2.998]
    box = np.array([300.0, 280.0, 400.0, 360.0], np.float32)
    pos = rng.uniform(-1, 1, 3).astype(np.float32)
    return depth.view(np.uint16), mask, box, pos


def _torch(depth, mask, box, pos, quat, **kw):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return tdf.extract_points(tdf.depth_bits(depth, "cpu"), t(mask), t(box),
                              t(FOCAL), t(PRINCIPAL), t(SENSOR), t(pos),
                              t(quat), mask_hw=mask.shape[-2:], **kw)


def _jax(depth, mask, box, pos, quat, **kw):
    return jdf.extract_points(jnp.asarray(depth), jnp.asarray(mask),
                              jnp.asarray(box), jnp.asarray(FOCAL),
                              jnp.asarray(PRINCIPAL), jnp.asarray(SENSOR),
                              jnp.asarray(pos), jnp.asarray(quat),
                              mask_hw=mask.shape, **kw)


@pytest.mark.parametrize("quat", [IDENT, ROTATED], ids=["identity", "rotated"])
@pytest.mark.parametrize("step", [4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_extract_points_equals_jax_and_numpy(seed, step, quat):
    depth, mask, box, pos = _scene(seed)
    got = _torch(depth, mask, box, pos, quat, sampling_step=step)
    want = _jax(depth, mask, box, pos, quat, sampling_step=step)
    ref = tdf.extract_points_numpy(depth, mask, box, FOCAL, PRINCIPAL, SENSOR,
                                   pos, quat, sampling_step=step)
    n = (32 // step) ** 2
    assert got["packed"].shape == (n, 5)
    valid = got["valid"].numpy()
    assert 0 < valid.sum() < n
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    np.testing.assert_array_equal(valid, ref["valid"])
    np.testing.assert_array_equal(got["depths"].numpy(),
                                  np.asarray(want["depths"]))
    for other in (want, ref):
        np.testing.assert_allclose(got["positions"].numpy(),
                                   np.asarray(other["positions"]), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got["depths"].numpy(),
                                   np.asarray(other["depths"]), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(got["packed"].numpy(),
                               np.asarray(want["packed"]), atol=ATOL, rtol=0)
    # rows that are not alive are zeroed, and the packed flag says so
    packed = got["packed"].numpy()
    assert (packed[~valid] == 0).all() and (packed[valid, 4] == 1).all()


def test_range_limits_are_strict_and_threshold_gates():
    mask = np.ones((8, 8), np.float32)
    box = np.array([320.0, 320.0, 640.0, 640.0], np.float32)
    for value, alive in ((0.1, False), (3.0, False), (0.1001, True),
                         (2.998, True), (0.05, False), (3.5, False)):
        depth = np.full((8, 8), value, np.float16).view(np.uint16)
        got = _torch(depth, mask, box, np.zeros(3), IDENT, sampling_step=4)
        want = _jax(depth, mask, box, np.zeros(3), IDENT, sampling_step=4)
        assert bool(got["valid"].all()) == alive, value
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(want["valid"]))
    depth = np.full((8, 8), 1.0, np.float16).view(np.uint16)
    got = _torch(depth, mask * 0.5, box, np.zeros(3), IDENT, sampling_step=4)
    assert not bool(got["valid"].any())        # mask == threshold: dropped


def test_depth_y_is_bottom_up():
    depth = np.full((8, 8), 1.0, np.float16)
    depth[0] = 2.0                              # row 0 = the image's BOTTOM
    mask = np.ones((8, 8), np.float32)
    box = np.array([320.0, 320.0, 640.0, 640.0], np.float32)
    got = _torch(depth.view(np.uint16), mask, box, np.zeros(3), IDENT,
                 sampling_step=1)["depths"].reshape(8, 8)
    assert float(got[7, 0]) == 2.0 and float(got[0, 0]) == 1.0


def test_for_target_and_batched_equal_the_single_call():
    depth, mask, box, pos = _scene(3)
    rng = np.random.default_rng(4)
    masks = rng.uniform(0, 1, (5, 32, 32)).astype(np.float32)
    masks[2] = mask
    boxes = np.tile(box, (5, 1)) + rng.uniform(-20, 20, (5, 4)).astype(
        np.float32)
    boxes[2] = box
    single = _torch(depth, mask, box, pos, ROTATED)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    cam = (t(FOCAL), t(PRINCIPAL), t(SENSOR), t(pos), t(ROTATED))
    bits = tdf.depth_bits(depth, "cpu")
    for index in (2, torch.tensor(2), torch.tensor(2, dtype=torch.int32)):
        one = tdf.extract_points_for_target(t(masks), index, bits, t(box),
                                            *cam)
        assert torch.equal(one["packed"], single["packed"])
    many = tdf.extract_points_batched(bits, t(masks), t(boxes), *cam,
                                      mask_hw=(32, 32))
    assert many["packed"].shape == (5, 64, 5)
    assert torch.equal(many["packed"][2], single["packed"])
    want = jdf.extract_points_batched(
        jnp.asarray(depth), jnp.asarray(masks), jnp.asarray(boxes),
        *(jnp.asarray(a.numpy()) for a in cam), mask_hw=(32, 32))
    np.testing.assert_array_equal(many["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(many["packed"].numpy(),
                               np.asarray(want["packed"]), atol=ATOL, rtol=0)


def test_depth_bits_keep_every_bit_and_other_types_are_refused():
    bits = np.array([[0x0000, 0x3C00, 0x8000, 0xFBFF]], np.uint16)
    t = tdf.depth_bits(bits, "cpu")
    assert t.dtype == torch.int16
    np.testing.assert_array_equal(t.numpy().view(np.uint16), bits)
    assert t.view(torch.float16)[0, 1] == 1.0
    with pytest.raises(TypeError, match="int16"):
        tdf.extract_points(torch.zeros(4, 4), torch.ones(8, 8),
                           torch.ones(4), *(torch.ones(2),) * 3,
                           torch.zeros(3), torch.tensor(IDENT), mask_hw=(8, 8))
