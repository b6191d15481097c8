"""Weighted box fusion in the port (xrseg_tpu_torch/ops/wbf.py: the plain
scans behind K5 and K6, and merge="wbf" through the pipelines) against the
JAX package's xrseg_tpu/ops/wbf.py, on the CPU.

Candidate sets are seeded with numpy: jittered clusters of boxes around
fewer centres than max_det can hold, bf16-quantised (tied) scores, three
labels and an image whose every score is below the gate. Compared per
slate: indices, labels, valid and count EQUAL; boxes and scores within
1e-5 relative (reached: 0 for axis-aligned boxes, whose arithmetic is the
JAX scan's op for op; under 1e-9 for rotated ones, where cos, sin and
atan2 round differently in the two libraries). The pipelines (segment,
detect and obb, with and without TTA, the fused tick) use
tests/torch_parity.detecting_tree weights, so every anchor is a live
candidate, and hold the tolerances of tests/test_torch_tta.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.ops import wbf as jwbf
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.ops import wbf as twbf
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree

limit_cpu_threads()

REL = 1e-5
EXACT = dict(dtype="float32", matmul_precision="highest")
POST = dict(iou_threshold=0.55, score_threshold=0.3, merge="wbf")


def candidates(seed, B, K, rotated=False, n_labels=3, gate=0.3):
    """Jittered clusters (K // 8 centres), bf16-tied scores in [0, 1],
    mixed labels; the last image's scores all lie below `gate`."""
    r = np.random.default_rng(seed)
    nc = max(K // 8, 1)
    ctr = r.uniform(20, 300, (B, nc, 2))
    wh = r.uniform(8, 60, (B, nc, 2))
    pick = r.integers(0, nc, (B, K))
    take = pick[..., None].repeat(2, -1)
    xy = np.take_along_axis(ctr, take, 1) + r.normal(0, 2, (B, K, 2))
    size = np.take_along_axis(wh, take, 1) * r.uniform(0.9, 1.1, (B, K, 2))
    boxes = np.concatenate([xy, size], -1)
    if rotated:
        ang = np.take_along_axis(r.uniform(-np.pi / 2, np.pi / 2, (B, nc)),
                                 pick, 1) + r.normal(0, 0.05, (B, K))
        boxes = np.concatenate([boxes, ang[..., None]], -1)
    scores = torch.from_numpy(r.uniform(0, 1, (B, K)).astype(np.float32))
    scores = scores.bfloat16().float().numpy()
    scores[-1] = np.minimum(scores[-1], gate * 0.9)
    labels = r.integers(0, n_labels, (B, K)).astype(np.int32)
    return boxes.astype(np.float32), scores, labels


def assert_slate_close(t, j, key):
    j = jax.device_get(j)
    for k in ("indices", "labels", "valid", "count"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k in (key, "scores"):
        want = np.asarray(j[k], np.float32)
        np.testing.assert_allclose(t[k].numpy(), want, rtol=REL,
                                   atol=REL * np.abs(want).max(), err_msg=k)


CASES = [(rot, ca, pre, K) for rot, K in ((False, 2000), (True, 600))
         for ca in (True, False) for pre in (0, 256)]


@pytest.mark.parametrize("rotated,class_aware,pre_topk,K", CASES,
                         ids=[f"{'rot' if r else 'axis'}-"
                              f"{'aware' if c else 'agnostic'}-pre{p}-K{k}"
                              for r, c, p, k in CASES])
def test_wbf_matches_jax(rotated, class_aware, pre_topk, K):
    boxes, scores, labels = candidates(K + pre_topk, 3, K, rotated)
    kw = dict(iou_threshold=0.55, score_threshold=0.3, max_det=40,
              class_aware=class_aware, pre_topk=pre_topk)
    jf = jwbf.wbf_rotated_fixed_batched if rotated else \
        jwbf.wbf_fixed_batched
    tf = twbf.wbf_rotated_fixed_batched if rotated else \
        twbf.wbf_fixed_batched
    j = jf(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), **kw)
    t = tf(torch.from_numpy(boxes), torch.from_numpy(scores),
           torch.from_numpy(labels), **kw)
    key = "boxes_xywhr" if rotated else "boxes_xywh"
    assert_slate_close(t, j, key)
    # more clusters than max_det: the cap drops candidates; the last image
    # has nothing above the gate
    assert t["count"].tolist()[:2] == [40, 40] and int(t["count"][2]) == 0
    assert not bool(t["valid"][2].any())


@pytest.mark.parametrize("seed", range(3))
def test_wbf_matches_numpy_oracle(seed):
    """The port's plain scan against its own host oracle, and the oracle
    against the JAX package's."""
    r = np.random.default_rng(seed)
    A = 64
    boxes = np.stack([r.uniform(10, 54, A), r.uniform(10, 54, A),
                      r.uniform(6, 16, A), r.uniform(6, 16, A)],
                     -1).astype(np.float32)
    scores = r.uniform(0, 1, A).astype(np.float32)
    labels = r.integers(0, 3, A).astype(np.int32)
    d = twbf.wbf_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(labels), iou_threshold=0.5,
                       score_threshold=0.2, max_det=64)
    ref = twbf.wbf_reference_numpy(boxes, scores, labels,
                                   iou_threshold=0.5, score_threshold=0.2)
    jref = jwbf.wbf_reference_numpy(boxes, scores, labels,
                                    iou_threshold=0.5, score_threshold=0.2)
    assert len(ref) == len(jref)
    for a, b in zip(ref, jref):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    n = int(d["count"])
    assert n == len(ref)
    np.testing.assert_allclose(d["scores"][:n].numpy(),
                               [x[1] for x in ref], rtol=1e-5)
    np.testing.assert_allclose(d["boxes_xywh"][:n].numpy(),
                               np.stack([x[0] for x in ref]), rtol=1e-4)
    assert d["indices"][:n].tolist() == [x[3] for x in ref]


def test_wbf_hand_cases():
    """The fusion arithmetic of tests/test_wbf.py's hand cases."""
    boxes = torch.tensor([[10.0, 10, 8, 8], [11.0, 10, 8, 8],
                          [50.0, 50, 8, 8]])
    d = twbf.wbf_fixed(boxes, torch.tensor([0.8, 0.6, 0.7]),
                       torch.tensor([3, 3, 3], dtype=torch.int32),
                       iou_threshold=0.5, max_det=5)
    assert int(d["count"]) == 2
    np.testing.assert_allclose(float(d["boxes_xywh"][0, 0]),
                               (0.8 * 10 + 0.6 * 11) / 1.4, rtol=1e-6)
    np.testing.assert_allclose(d["scores"][:2].numpy(), [0.7, 0.7],
                               rtol=1e-6)
    assert d["indices"][:2].tolist() == [0, 2] and not bool(d["valid"][2])
    same = torch.tensor([[10.0, 10, 8, 8]] * 3)
    kw = dict(iou_threshold=0.5, max_det=5, score_threshold=0.1)
    s, lab = torch.tensor([0.9, 0.8, 0.05]), torch.tensor(
        [1, 2, 1], dtype=torch.int32)
    assert int(twbf.wbf_fixed(same, s, lab, **kw)["count"]) == 2
    assert int(twbf.wbf_fixed(same, s, lab, class_aware=False,
                              **kw)["count"]) == 1


def test_wbf_rotated_fuses_angles_circularly():
    """tests/test_wbf.py's wrap case: boxes at +-(pi/2 - 0.05) fuse to an
    angle of +-pi/2, not 0; a singleton keeps its angle."""
    boxes = np.asarray([[20.0, 20, 16, 6, np.pi / 2 - 0.05],
                        [20.0, 20, 16, 6, -np.pi / 2 + 0.05],
                        [60.0, 60, 16, 6, 0.3]], np.float32)
    scores = np.asarray([0.8, 0.8, 0.7], np.float32)
    labels = np.zeros(3, np.int32)
    kw = dict(iou_threshold=0.4, max_det=4)
    d = twbf.wbf_rotated_fixed(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(labels), **kw)
    assert int(d["count"]) == 2
    assert abs(abs(float(d["boxes_xywhr"][0, 4])) - np.pi / 2) < 1e-5
    np.testing.assert_allclose(float(d["boxes_xywhr"][0, 0]), 20.0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(d["boxes_xywhr"][1, 4]), 0.3, atol=1e-6)
    j = jwbf.wbf_rotated_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels), **kw)
    assert_slate_close({k: v[None] for k, v in d.items()},
                       {k: np.asarray(v)[None] for k, v in j.items()},
                       "boxes_xywhr")


def test_backends_agree_and_the_wrapper_counts_nothing_on_cpu():
    boxes, scores, labels = candidates(7, 2, 300)
    args = [torch.from_numpy(a) for a in (boxes, scores, labels)]
    kw = dict(iou_threshold=0.55, score_threshold=0.3, max_det=30)
    before = twbf.wbf_scan_cuda.launches
    auto = twbf.wbf_fixed_batched(*args, **kw)
    scan = twbf.wbf_fixed_batched(*args, backend="scan", **kw)
    for k in auto:
        assert torch.equal(auto[k], scan[k]), k
    assert twbf.wbf_scan_cuda.launches == before
    with pytest.raises(ValueError, match="backend"):
        twbf.wbf_fixed_batched(*args, backend="pallas", **kw)


# ---------------------------------------------------------------------------
# merge="wbf" through the pipelines
# ---------------------------------------------------------------------------

def _configs(task, **post):
    kw = dict(EXACT, task=task, input_size=(64, 64))
    p = dict(POST, **post)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**kw),
                                   post=jconfig.PostprocessConfig(**p)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**kw),
                                   post=tconfig.PostprocessConfig(**p)))


PIPES = [(task, tta) for task in ("segment", "detect", "obb")
         for tta in (False, True)]


@pytest.mark.parametrize("task,tta", PIPES,
                         ids=[f"{t}-{'tta' if a else 'plain'}"
                              for t, a in PIPES])
def test_pipeline_wbf_matches_jax(task, tta):
    jcfg, tcfg = _configs(task)
    p = detecting_tree(jcfg.model)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    kw = dict(frame_hw=(48, 64), batch=2, tta=tta)
    j = jax.device_get(jcompile.build_pipeline(jcfg, p, **kw)(
        jnp.asarray(frames)))
    t = tcompile.build_pipeline(tcfg, params_from_jax(p, tcfg.model),
                                device="cpu", **kw)(frames)
    assert set(t) == set(j)
    key = "boxes_xywhr" if task == "obb" else "boxes_xywh"
    assert_slate_close(t, j, key)
    assert int(t["count"].min()) > 0
    np.testing.assert_allclose(t["slate"].numpy(), j["slate"], atol=1e-3,
                               rtol=0)
    if task == "segment":
        np.testing.assert_allclose(t["masks"].numpy(), j["masks"], atol=1e-4,
                                   rtol=0)


def test_pose_under_wbf_runs_nms_as_jax_does():
    """JAX's pose decode never reads merge: merge="wbf" gives its NMS
    slate, and so must the port's."""
    jcfg, tcfg = _configs("pose")
    p = detecting_tree(jcfg.model)
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    j = jax.device_get(jcompile.build_pipeline(jcfg, p, batch=2)(
        jnp.asarray(frames)))
    t = tcompile.build_pipeline(tcfg, params_from_jax(p, tcfg.model),
                                batch=2, device="cpu")(frames)
    nms_cfg = dataclasses.replace(tcfg, post=dataclasses.replace(
        tcfg.post, merge="nms"))
    n = tcompile.build_pipeline(nms_cfg, params_from_jax(p, tcfg.model),
                                batch=2, device="cpu")(frames)
    assert_slate_close(t, j, "boxes_xywh")
    np.testing.assert_allclose(t["kpts"].numpy(), j["kpts"], atol=1e-3,
                               rtol=0)
    for k in n:
        assert torch.equal(t[k], n[k]), k


def test_b1_postprocess_runs_nms_under_wbf():
    """The b=1 postprocess() entry point: JAX rebuilds its config without
    `merge`, so it runs NMS under merge="wbf"; so does the port."""
    from xrseg_tpu.ops import postprocess as jpost
    from xrseg_tpu_torch.ops import postprocess as tpost
    rng = np.random.default_rng(3)
    A, nc, nm = 84, 3, 8
    preds = np.concatenate([
        rng.uniform(8, 56, (1, A, 2)), rng.uniform(4, 20, (1, A, 2)),
        rng.uniform(0, 1, (1, A, nc)), rng.normal(0, 1, (1, A, nm))],
        -1).astype(np.float32)
    protos = rng.normal(0, 1, (1, 16, 16, nm)).astype(np.float32)
    kw = dict(iou_threshold=0.5, score_threshold=0.3, max_detections=20)
    j = jax.device_get(jpost.postprocess(
        jnp.asarray(preds), jnp.asarray(protos),
        jconfig.PostprocessConfig(merge="wbf", **kw), num_classes=nc,
        input_size=(64, 64)))
    t = tpost.postprocess(preds, protos,
                          tconfig.PostprocessConfig(merge="wbf", **kw),
                          num_classes=nc, input_size=(64, 64), device="cpu")
    n = tpost.postprocess(preds, protos, tconfig.PostprocessConfig(**kw),
                          num_classes=nc, input_size=(64, 64), device="cpu")
    assert int(t["count"][0]) > 0
    assert_slate_close(t, j, "boxes_xywh")
    for k in n:
        assert torch.equal(t[k], n[k]), k


def test_fused_tick_wbf_matches_jax():
    jcfg, tcfg = _configs("segment", max_detections=10, pre_nms_topk=64)
    p = detecting_tree(jcfg.model, seed=3)
    kw = dict(frame_hw=(48, 64), depth_hw=(32, 32))
    jpipe = jcompile.build_xr_tick_pipeline(jcfg, p, **kw)
    tpipe = tcompile.build_xr_tick_pipeline(
        tcfg, params_from_jax(p, tcfg.model), device="cpu", **kw)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (1, 48, 64, 3), np.uint8)
    depth = np.full((32, 32), 1.5, np.float16).view(np.uint16)
    quat = np.array([0.1825742, 0.3651484, 0.5477226, 0.7302967], np.float32)

    def aux(prev):
        return tcompile.XRTickPipeline.pack_aux(
            (440.0, 440.0), (640.0, 480.0), (1280, 960), (0.1, -0.2, 0.3),
            quat, prev, (1.0, 0.75))

    first = tpipe.unpack(tpipe(frame, depth, aux((0.0, 0.0, -1.0, 0.0)))
                         ["packed"])
    assert first["count"] > 3 and not first["matched"]
    prev = (*first["boxes_xywh"][3, :2], float(first["labels"][3]), 1.0)
    jp = np.asarray(jpipe(jnp.asarray(frame), jnp.asarray(depth),
                          jnp.asarray(aux(prev)))["packed"])
    tp = tpipe(frame, depth, aux(prev))["packed"].numpy()
    hj, ht = jpipe.unpack(jp), tpipe.unpack(tp)
    assert bool(ht["matched"]) and bool(hj["matched"])
    assert ht["matched_index"] == hj["matched_index"]
    assert ht["count"] == hj["count"]
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
    L = tpipe.slate_len
    np.testing.assert_allclose(tp[:L], jp[:L], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tp[L + 2:], jp[L + 2:], atol=1e-4, rtol=0)


def test_unknown_merge_refused():
    _, tcfg = _configs("detect", merge="nmw")
    with pytest.raises(ValueError, match="unknown merge"):
        tcompile.build_pipeline(tcfg, tcompile.yolo11.YOLO11(tcfg.model),
                                device="cpu")
