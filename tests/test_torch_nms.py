"""Port NMS (xrseg_tpu_torch/ops/nms*.py) against the JAX package.

Greedy NMS is discrete, so every comparison here is EXACT: indices, ok
flags, counts, and the gathered boxes/scores/labels. The plain torch
versions of kernels K1/K2 are held against the Pallas kernels run in
interpret mode, and nms_fixed / nms_fixed_batched against the JAX scan
path. The CUDA kernels themselves are compared with the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import nms as jnms
from xrseg_tpu.ops import pallas_kernels as pk
from xrseg_tpu_torch.ops import nms as tnms
from xrseg_tpu_torch.ops import nms_kernels as tk


def _scene(seed, B, K, *, ties=False, zero_area=False, empty_rows=(),
           classes=8):
    """Boxes [B,K,4] xywh, scores [B,K], labels [B,K] from a numpy seed."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(50, 600, (B, K, 2))
    wh = rng.uniform(10, 120, (B, K, 2))
    if zero_area:
        wh[:, ::7, 0] = 0.0                      # zero width
        wh[:, 3::11, 1] = 0.0                    # zero height
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    if ties:    # a handful of distinct values: exact ties everywhere
        scores = (rng.integers(0, 12, (B, K)) / 12.0).astype(np.float32)
    else:
        scores = rng.uniform(0, 1, (B, K)).astype(np.float32)
    for b in empty_rows:
        scores[b] = 0.0
    labels = rng.integers(0, classes, (B, K)).astype(np.int32)
    return boxes, scores, labels


def _kernel_inputs(boxes, scores, labels, thr):
    corners = np.asarray(jnms.xywh_to_corners(jnp.asarray(boxes)))
    corners = corners + labels[..., None].astype(np.float32) * 8192.0
    masked = np.where(scores > np.float32(thr), scores,
                      pk._NEG).astype(np.float32)
    return corners.astype(np.float32), masked


CASES = {
    "random": dict(),
    "ties": dict(ties=True),
    "zero_area": dict(zero_area=True),
    "empty_row": dict(empty_rows=(1,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_batched_matches_pallas_interpret(case):
    """K1's plain version == nms_select_batched_pallas, all max_det slots."""
    boxes, scores, labels = _scene(11, 3, 300, **CASES[case])
    corners, masked = _kernel_inputs(boxes, scores, labels, 0.3)
    ji, jo = pk.nms_select_batched_pallas(jnp.asarray(corners),
                                          jnp.asarray(masked), 0.45,
                                          max_det=30, block_b=2,
                                          interpret=True)
    ti, to = tk.nms_select_batched_torch(torch.from_numpy(corners),
                                         torch.from_numpy(masked), 0.45, 30)
    assert ti.dtype == torch.int32 and to.dtype == torch.bool
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_single_matches_pallas_interpret(case):
    """K2's plain version == nms_select_pallas, all max_det slots."""
    boxes, scores, labels = _scene(12, 2, 300, **CASES[case])
    corners, masked = _kernel_inputs(boxes, scores, labels, 0.25)
    for b in range(2):
        ji, jo = pk.nms_select_pallas(jnp.asarray(corners[b]),
                                      jnp.asarray(masked[b]), 0.5,
                                      max_det=25, interpret=True)
        ti, to = tk.nms_select_torch(torch.from_numpy(corners[b]),
                                     torch.from_numpy(masked[b]), 0.5, 25)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _assert_slate_equal(t, j):
    j = jax.device_get(j)
    for k in ("indices", "labels", "valid", "count", "boxes_xywh", "scores"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["scan", "cuda"])
@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("pre_topk", [0, 64])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_fixed_matches_jax_scan(backend, class_aware, pre_topk, ties):
    """nms_fixed (either backend; "cuda" runs the plain version for CPU
    tensors) == the JAX scan path, including pre_topk compaction."""
    boxes, scores, labels = _scene(21, 1, 300, ties=ties, classes=4)
    kw = dict(iou_threshold=0.45, score_threshold=0.8, max_det=20,
              pre_topk=pre_topk, class_aware=class_aware)
    j = jnms.nms_fixed(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                       jnp.asarray(labels[0]), backend="scan", **kw)
    t = tnms.nms_fixed(torch.from_numpy(boxes[0]),
                       torch.from_numpy(scores[0]),
                       torch.from_numpy(labels[0]), backend=backend, **kw)
    _assert_slate_equal(t, j)


def test_nms_fixed_pre_topk_overflow_drops_in_anchor_order():
    """More than pre_topk anchors above the gate: the excess is dropped in
    anchor order, exactly as the JAX compaction's mode="drop"."""
    boxes, scores, labels = _scene(22, 1, 300)
    kw = dict(iou_threshold=0.5, score_threshold=0.1, max_det=30,
              pre_topk=40)
    j = jnms.nms_fixed(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                       jnp.asarray(labels[0]), **kw)
    t = tnms.nms_fixed(torch.from_numpy(boxes[0]),
                       torch.from_numpy(scores[0]),
                       torch.from_numpy(labels[0]), **kw)
    _assert_slate_equal(t, j)
    assert int(t["indices"].max()) < 120     # only early anchors survive


def test_nms_fixed_empty():
    boxes, scores, labels = _scene(23, 1, 64, empty_rows=(0,))
    t = tnms.nms_fixed(torch.from_numpy(boxes[0]),
                       torch.from_numpy(scores[0]),
                       torch.from_numpy(labels[0]), iou_threshold=0.5,
                       score_threshold=0.2, max_det=10)
    assert int(t["count"]) == 0 and not t["valid"].any()
    assert not t["boxes_xywh"].any() and not t["indices"].any()


@pytest.mark.parametrize("backend", ["scan", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_fixed_batched_matches_jax(backend, case):
    boxes, scores, labels = _scene(31, 3, 257, **CASES[case])
    kw = dict(iou_threshold=0.5, score_threshold=0.3, max_det=20)
    j = jnms.nms_fixed_batched(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels), backend="scan", **kw)
    t = tnms.nms_fixed_batched(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(labels), backend=backend,
                               **kw)
    _assert_slate_equal(t, j)


def test_wrappers_on_cpu_run_plain_and_do_not_count():
    boxes, scores, labels = _scene(41, 2, 100)
    corners, masked = _kernel_inputs(boxes, scores, labels, 0.3)
    c, m = torch.from_numpy(corners), torch.from_numpy(masked)
    n1 = tk.nms_select_batched_cuda.launches
    n2 = tk.nms_select_cuda.launches
    got = tk.nms_select_batched_cuda(c, m, 0.5, 10)
    ref = tk.nms_select_batched_torch(c, m, 0.5, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = tk.nms_select_cuda(c[0], m[0], 0.5, 10)
    ref = tk.nms_select_torch(c[0], m[0], 0.5, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tk.nms_select_batched_cuda.launches == n1
    assert tk.nms_select_cuda.launches == n2


def test_resolve_backend():
    x = torch.zeros(3)
    assert tnms.resolve_backend("auto", x) == "scan"
    assert tnms.resolve_backend("cuda", x) == "cuda"
    with pytest.raises(ValueError, match="pallas"):
        tnms.resolve_backend("pallas", x)
