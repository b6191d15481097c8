"""Port mask ops (xrseg_tpu_torch/ops/masks.py) against xrseg_tpu.ops.masks.

Tolerance for the synthesized masks: 2e-6 absolute on sigmoid outputs in
[0, 1]. Both sides multiply the same operands exactly and accumulate 32
products in float32; only the summation order differs. Crop and threshold
are comparisons of identically computed float32 values: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import masks as jm
from xrseg_tpu_torch.ops import masks as tm
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()


def _inputs(seed=0, B=2, D=6, H=12, W=16, nm=8):
    rng = np.random.default_rng(seed)
    coefs = rng.standard_normal((B, D, nm)).astype(np.float32)
    protos = rng.standard_normal((B, H, W, nm)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 64, (B, D, 2)),
                            rng.uniform(0, 40, (B, D, 2))], -1).astype(
        np.float32)
    boxes[:, 0] = [16.0, 12.0, 8.0, 8.0]       # edges on mask pixel centres
    return coefs, protos, boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthesize_masks(dtype):
    coefs, protos, _ = _inputs()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = tm.synthesize_masks(torch.from_numpy(coefs).to(tdt),
                            torch.from_numpy(protos).to(tdt))
    assert t.shape == (2, 6, 12, 16) and t.dtype == torch.float32
    for b in range(2):
        j = jm.synthesize_masks(jnp.asarray(coefs[b]).astype(jdt),
                                jnp.asarray(protos[b]).astype(jdt))
        np.testing.assert_allclose(t[b].numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6)


def test_crop_masks_inclusive_bounds():
    coefs, protos, boxes = _inputs(1)
    m = np.array(jm.synthesize_masks(jnp.asarray(coefs[0]),
                                     jnp.asarray(protos[0])))
    j = jm.crop_masks(jnp.asarray(m), jnp.asarray(boxes[0]), (48, 64))
    t = tm.crop_masks(torch.from_numpy(m), torch.from_numpy(boxes[0]),
                      (48, 64))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # batched call == per-image calls
    mb = torch.from_numpy(np.stack([m, m]))
    tb = tm.crop_masks(mb, torch.from_numpy(boxes), (48, 64))
    np.testing.assert_array_equal(tb[0].numpy(), t.numpy())


def test_threshold_masks():
    m = np.random.default_rng(2).uniform(0, 1, (3, 5, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.threshold_masks(torch.from_numpy(m), 0.5).numpy(),
        np.asarray(jm.threshold_masks(jnp.asarray(m), 0.5)))


def test_synthesize_one_mask():
    coefs, protos, _ = _inputs(3)
    for i in (0, 4):
        j = jm.synthesize_one_mask(jnp.asarray(coefs[0]),
                                   jnp.asarray(protos[0]), jnp.int32(i))
        t = tm.synthesize_one_mask(torch.from_numpy(coefs[0]),
                                   torch.from_numpy(protos[0]),
                                   torch.tensor(i))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6)
