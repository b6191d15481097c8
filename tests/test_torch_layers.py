"""Port layers (xrseg_tpu_torch/models/layers.py) against xrseg_tpu.models.layers.

Each block's params take the JAX init's pytree structure, with every leaf
(biases included) drawn from a numpy seed so no path hides behind a zero;
they cross through io/bridge.py, and both sides run the same NHWC input in
float32. Tolerance: relative max error 2e-5 of the output's scale; both
sides compute in float32 and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.models import layers as JL
from xrseg_tpu_torch.io.bridge import state_dict_from_jax
from xrseg_tpu_torch.models import layers as TL

F32 = torch.float32


def _params(init, *args, seed=1):
    """The JAX init's pytree structure (traced with eval_shape, not run),
    every leaf drawn from a numpy seed."""
    tree = jax.eval_shape(lambda k: init(JL.KeyGen(k), *args),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        tree)


def _load(module, tree):
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module


def _run(module, x):
    with torch.no_grad():
        y = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _close(t, j, tol=2e-5):
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-6)
    assert err < tol, f"relative max error {err}"


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k,s,hw", [(1, 1, 8), (3, 1, 8), (3, 2, 8),
                                    (3, 2, 9)])
def test_conv(k, s, hw):
    p = _params(JL.conv_init, 6, 10, k)
    x = _x(2, (2, hw, hw, 6))
    j = JL.conv_apply(p, jnp.asarray(x), stride=s, dtype=jnp.float32)
    _close(_run(_load(TL.Conv(6, 10, k, s, dtype=F32), p), x), j)


def test_dwconv():
    p = _params(JL.dwconv_init, 8, 3)
    x = _x(2, (1, 7, 7, 8))
    j = JL.dwconv_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.dwconv(8, 3, dtype=F32), p), x), j)


def test_head_conv():
    p = _params(JL.head_conv_init, 8, 12)
    x = _x(2, (1, 5, 5, 8))
    j = JL.head_conv_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.HeadConv(8, 12, dtype=F32), p), x), j)


@pytest.mark.parametrize("shortcut", [True, False])
def test_bottleneck(shortcut):
    p = _params(JL.bottleneck_init, 8, 8, (3, 3), 0.5)
    x = _x(2, (1, 8, 8, 8))
    j = JL.bottleneck_apply(p, jnp.asarray(x), shortcut=shortcut,
                            dtype=jnp.float32)
    m = TL.Bottleneck(8, 8, (3, 3), 0.5, shortcut, dtype=F32)
    _close(_run(_load(m, p), x), j)


def test_c3k():
    p = _params(JL.c3k_init, 8, 8, 2)
    x = _x(2, (1, 8, 8, 8))
    j = JL.c3k_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.C3k(8, 8, 2, dtype=F32), p), x), j)


@pytest.mark.parametrize("c3k", [False, True])
def test_c3k2(c3k):
    p = _params(JL.c3k2_init, 16, 32, 1, c3k, 0.25)
    x = _x(2, (2, 8, 8, 16))
    j = JL.c3k2_apply(p, jnp.asarray(x), shortcut=True, dtype=jnp.float32)
    _close(_run(_load(TL.C3k2(16, 32, 1, c3k, 0.25, dtype=F32), p), x), j)


def test_sppf_pads_with_neg_inf():
    """All-negative input: a zero-padded max pool would differ at the
    border; -inf padding matches the JAX reduce_window."""
    p = _params(JL.sppf_init, 16, 16)
    x = -np.abs(_x(2, (1, 6, 6, 16))) - 1.0
    j = JL.sppf_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.SPPF(16, 16, dtype=F32), p), x), j)


@pytest.mark.parametrize("dim,heads", [(64, 1), (128, 2)])
def test_attention_qkv_split(dim, heads):
    """The per-head qkv split of the channels-last [B,N,nh,2kd+hd] view."""
    p = _params(JL.attention_init, dim, heads)
    x = _x(2, (2, 4, 5, dim))
    j = JL.attention_apply(p, jnp.asarray(x), num_heads=heads,
                           dtype=jnp.float32)
    _close(_run(_load(TL.Attention(dim, heads, dtype=F32), p), x), j)


def test_c2psa():
    p = _params(JL.c2psa_init, 128, 1)
    x = _x(2, (1, 4, 4, 128))
    j = JL.c2psa_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.C2PSA(128, 1, dtype=F32), p), x), j)


def test_transposed_conv_weight_layout():
    """up_w [kH,kW,I,O] through the bridge's (2,3,0,1) permutation is
    torch's ConvTranspose2d weight: the JAX transpose_kernel=True call and
    F.conv_transpose2d agree (non-square I/O, asymmetric kernel)."""
    rng = np.random.default_rng(3)
    up_w = rng.standard_normal((2, 2, 6, 4)).astype(np.float32)
    y = rng.standard_normal((1, 3, 5, 6)).astype(np.float32)
    j = JL.convT2x_f32acc(jnp.asarray(y), jnp.swapaxes(jnp.asarray(up_w),
                                                       2, 3))
    w = state_dict_from_jax({"up_w": up_w})["up_w"]
    t = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(y).permute(0, 3, 1, 2), w, stride=2)
    _close(t.permute(0, 2, 3, 1).numpy(), j)


def test_proto():
    p = _params(JL.proto_init, 16, 24, 8)
    x = _x(2, (1, 6, 6, 16))
    j = JL.proto_apply(p, jnp.asarray(x), dtype=jnp.float32)
    _close(_run(_load(TL.Proto(16, 24, 8, dtype=F32), p), x), j)


def test_upsample_nearest():
    x = _x(2, (1, 3, 4, 5))
    j = JL.upsample2x_nearest(jnp.asarray(x))
    t = TL.upsample2x_nearest(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j))


def test_bridge_rejects_unknown_leaf():
    with pytest.raises(KeyError, match="gamma"):
        state_dict_from_jax({"bn": {"gamma": np.zeros(3)}})
