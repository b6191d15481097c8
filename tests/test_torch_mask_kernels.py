"""K4's plain version (xrseg_tpu_torch/ops/mask_kernels.py) against the JAX
package's mask_synth_crop_pallas in interpret mode, on the CPU.

Tolerance: atol 2e-5, rtol 1e-4, as the JAX package's own test of the
kernel (tests/test_pallas_kernels.py): both sides multiply the same float32
operands and sum 32 products in another order. The crop decision is a
comparison of identically computed float32 bounds, so which pixels are
zeroed must match exactly. The CUDA kernel itself is compared with the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import pallas_kernels as pk
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.ops import mask_kernels as mk
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()


def _inputs(seed, B, D, hw, input_size, nm=32):
    rng = np.random.default_rng(seed)
    H, W = input_size
    coefs = rng.standard_normal((B, D, nm)).astype(np.float32)
    protos = rng.standard_normal((B,) + hw + (nm,)).astype(np.float32)
    boxes = np.concatenate([
        rng.uniform(0.15, 0.85, (B, D, 1)) * W,
        rng.uniform(0.15, 0.85, (B, D, 1)) * H,
        rng.uniform(0.08, 0.5, (B, D, 1)) * W,
        rng.uniform(0.08, 0.5, (B, D, 1)) * H], -1).astype(np.float32)
    # a box whose edges fall exactly on mask pixel centres (inclusive)
    sx, sy = W / hw[1], H / hw[0]
    boxes[:, 0] = [8 * sx, 6 * sy, 4 * sx, 4 * sy]
    return coefs, protos, boxes


SHAPES = {
    "seg_640": dict(D=50, hw=(160, 160), input_size=(640, 640)),
    "odd_64x96": dict(D=13, hw=(16, 24), input_size=(64, 96)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_interpret(shape):
    kw = SHAPES[shape]
    coefs, protos, boxes = _inputs(0, 1, kw["D"], kw["hw"],
                                   kw["input_size"])
    j = np.asarray(pk.mask_synth_crop_pallas(
        jnp.asarray(coefs[0]), jnp.asarray(protos[0]), jnp.asarray(boxes[0]),
        mask_hw=kw["hw"], input_size=kw["input_size"], interpret=True))
    t = mk.mask_synth_crop_torch(torch.from_numpy(coefs[0]),
                                 torch.from_numpy(protos[0]),
                                 torch.from_numpy(boxes[0]), kw["hw"],
                                 kw["input_size"]).numpy()
    assert t.shape == (kw["D"],) + kw["hw"] and t.dtype == np.float32
    np.testing.assert_array_equal(t == 0, j == 0)      # the crop, exactly
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=1e-4)
    assert (t > 0).any() and (t == 0).any()


def test_batched_equals_per_image():
    """The leading batch dim (the JAX vmap) == one call per image."""
    coefs, protos, boxes = _inputs(1, 3, 7, (16, 24), (64, 96))
    args = [torch.from_numpy(a) for a in (coefs, protos, boxes)]
    out = mk.mask_synth_crop_torch(*args, (16, 24), (64, 96))
    assert out.shape == (3, 7, 16, 24)
    for b in range(3):
        one = mk.mask_synth_crop_torch(*(a[b] for a in args), (16, 24),
                                       (64, 96))
        torch.testing.assert_close(out[b], one, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_plain_and_does_not_count():
    coefs, protos, boxes = _inputs(2, 2, 5, (16, 24), (64, 96))
    args = [torch.from_numpy(a) for a in (coefs, protos, boxes)]
    n = launches.read()["mask_synth_crop_cuda"]
    got = mk.mask_synth_crop_cuda(*args, (16, 24), (64, 96))
    ref = mk.mask_synth_crop_torch(*args, (16, 24), (64, 96))
    assert torch.equal(got, ref)
    assert launches.read()["mask_synth_crop_cuda"] == n


@pytest.mark.parametrize("bad", ["mask_hw", "boxes", "rank"])
def test_shapes_refused(bad):
    coefs, protos, boxes = (torch.from_numpy(a) for a in
                            _inputs(3, 1, 5, (16, 24), (64, 96)))
    hw = (16, 24)
    if bad == "mask_hw":
        hw = (24, 16)
    elif bad == "boxes":
        boxes = boxes[:, :4]
    else:
        coefs = coefs[0]
    with pytest.raises(ValueError, match="mask_synth_crop takes"):
        mk.mask_synth_crop_cuda(coefs, protos, boxes, hw, (64, 96))
