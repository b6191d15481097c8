"""The port's OBB task (YOLO11-obb head, rotated probIoU NMS, the obb
pipeline) against the JAX package, on the CPU.

Tolerances:
- forward in float32: 2e-5 of each output's scale, as tests/
  test_torch_model.py (summation orders of the conv stacks differ);
- decode_rbox: 1e-6 of the output's scale (boxes reach hundreds of
  pixels, where one float32 ulp is 1.5e-5); the covariance terms and
  probIoU: 1e-6 absolute (the same float32 formulas; cos/sin/log/exp may
  differ by an ulp between the two libraries);
- rotated NMS: EXACT indices, ok flags, counts and gathered boxes. The
  ulp-level differences above cannot flip a decision because every scene
  is checked to hold no probIoU within 1e-6 of the threshold;
- postprocess and pipeline: those of tests/test_torch_pipeline.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrseg_tpu.testing as jtesting
from xrseg_tpu import compile as jcompile
from xrseg_tpu import config as jconfig
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.ops import nms as jnms
from xrseg_tpu.ops import pallas_kernels as pk
from xrseg_tpu.ops import postprocess as jpost
from xrseg_tpu_torch import compile as tcompile
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import yolo11 as ty
from xrseg_tpu_torch.ops import launches
from xrseg_tpu_torch.ops import nms as tnms
from xrseg_tpu_torch.ops import nms_kernels as tk
from xrseg_tpu_torch.ops import postprocess as tpost
from xrseg_tpu_torch.testing import detection_params, limit_cpu_threads

limit_cpu_threads()

SIZE = (64, 96)
MODEL = dict(task="obb", num_classes=15, input_size=SIZE, dtype="float32")
POST = dict(iou_threshold=0.6, score_threshold=0.3)
_jax_forward = jax.jit(jy.forward, static_argnames=("cfg", "concat_preds"))


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

def _fan_in_params(cfg, seed=0):
    """The JAX init's pytree structure with leaves drawn from a numpy seed
    at fan-in scale (as tests/test_torch_model.py)."""
    tree = jax.eval_shape(lambda k: jy.init_params(k, cfg),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if a.ndim == 4:
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            std = (1.0 / fan_in) ** 0.5 * 1.5
        else:
            std = 0.1
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def forward_pair():
    jcfg, tcfg = jconfig.ModelConfig(**MODEL), tconfig.ModelConfig(**MODEL)
    p = _fan_in_params(jcfg)
    x = np.random.default_rng(7).uniform(0, 1, (2,) + SIZE + (3,)).astype(
        np.float32)
    j = jax.device_get(_jax_forward(p, jnp.asarray(x), cfg=jcfg,
                                    concat_preds=True))
    with torch.no_grad():
        t = params_from_jax(p, tcfg)(torch.from_numpy(x), concat_preds=True)
    return t, j


def test_obb_forward_f32_matches_jax(forward_pair):
    t, j = forward_pair
    assert set(t) == set(j) == {"boxes_xywh", "scores", "cls_logits",
                                "boxes_xywhr", "angle", "preds"}
    A = tconfig.ModelConfig(**MODEL).num_anchors
    assert t["boxes_xywhr"].shape == (2, A, 5)
    assert t["preds"].shape == (2, A, 4 + 15 + 1)
    for k in sorted(j):
        a = np.asarray(j[k]).astype(np.float32)
        b = t[k].float().numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-6)
        assert err < 2e-5, (k, err)
    assert t["angle"].std() > 1e-3             # the angle branch is live
    assert float(t["angle"].min()) >= -np.pi / 4 - 1e-6
    assert float(t["angle"].max()) <= 3 * np.pi / 4 + 1e-6


def test_obb_param_count_matches_jax():
    jcfg = jconfig.ModelConfig(task="obb", num_classes=15)
    tree = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                          jax.random.key(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    model = ty.YOLO11(tconfig.ModelConfig(task="obb", num_classes=15))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert len(model.obb_cv4) == 3 and not hasattr(model, "proto")


def test_decode_rbox_matches_jax():
    rng = np.random.default_rng(3)
    ltrb = rng.uniform(0, 6, (2, 126, 4)).astype(np.float32)
    angle = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 126)).astype(
        np.float32)
    anchors, strides = jy.make_anchors(SIZE)
    j = jy.decode_rbox(jnp.asarray(ltrb), jnp.asarray(angle),
                       jnp.asarray(anchors), jnp.asarray(strides))
    t = ty.decode_rbox(torch.from_numpy(ltrb), torch.from_numpy(angle),
                       torch.from_numpy(anchors), torch.from_numpy(strides))
    j = np.asarray(j)
    assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()
    np.testing.assert_array_equal(t[..., 4].numpy(), angle)


def test_obb_init_and_detection_params():
    cfg = tconfig.ModelConfig(**MODEL)
    model = detection_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    with torch.no_grad():
        out = model(torch.zeros((1,) + SIZE + (3,)), concat_preds=False)
    assert bool((out["scores"][..., 0] > 0.5).all())   # every anchor fires
    assert bool(out["boxes_xywhr"].isfinite().all())


# ---------------------------------------------------------------------------
# probIoU
# ---------------------------------------------------------------------------

def _rboxes(rng, B, K, *, zero_area=False, thin=False):
    """Rotated boxes [B,K,5] drawn from `rng` as the JAX package's
    rotated-kernel test draws them, with optional zero-width and
    zero-height boxes, and thin near-parallel pairs."""
    boxes = np.concatenate([
        rng.uniform(40, 600, (B, K, 2)),
        rng.uniform(10, 80, (B, K, 2)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, K, 1)),
    ], -1).astype(np.float32)
    if zero_area:
        boxes[:, ::7, 2] = 0.0
        boxes[:, 3::11, 3] = 0.0
    if thin:
        # pairs of 64x0.5 px lines, 0.3 px and 1e-3 rad apart
        boxes[:, 1::2, :2] = boxes[:, 0::2, :2] + np.float32(0.3)
        boxes[:, :, 2:4] = np.float32([64.0, 0.5])
        boxes[:, 1::2, 4] = boxes[:, 0::2, 4] + np.float32(1e-3)
    return boxes


def test_rbox_covariance_matches_jax():
    b = _rboxes(np.random.default_rng(1), 1, 200, zero_area=True)[0]
    j = jnms._rbox_covariance(jnp.asarray(b))
    t = tk.rbox_covariance(torch.from_numpy(b))
    for tj, tt in zip(j, t):
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["random", "zero_area", "thin"])
def test_probiou_matches_jax(case):
    """probIoU of every pair of a scene. For degenerate boxes (zero width,
    64x0.5 px lines) the covariance terms are ill-conditioned: an ulp of
    cos/sin moves ab - c^2 by up to 1e-3 relative on either side. So there
    the port's probIoU arithmetic is held to JAX's on JAX's own covariance
    terms, and end to end only where the inputs are well conditioned."""
    b = _rboxes(np.random.default_rng(2), 1, 120,
                zero_area=case == "zero_area", thin=case == "thin")[0]
    jb = jnp.asarray(b)
    j = np.asarray(jnms.probiou(jb[:, None], jb[None]))
    tb = torch.from_numpy(b)
    t = tnms.probiou(tb[:, None], tb[None]).numpy()
    assert np.isfinite(t).all() and (t >= 0).all() and (t <= 1).all()
    if case == "random":
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    a, bb, c = (torch.from_numpy(np.array(v))
                for v in jnms._rbox_covariance(jb))
    det = (a * bb - c * c).clamp_min(0)
    g = (tb[:, 0], tb[:, 1], a, bb, c, det)
    tg = tk.probiou_gauss(*(v[:, None] for v in g), *(v[None] for v in g))
    np.testing.assert_allclose(tg.numpy(), j, rtol=0, atol=1e-6)
    row = tnms.probiou_row(tb[5], tb)
    np.testing.assert_array_equal(row.numpy(), t[5])


# ---------------------------------------------------------------------------
# rotated NMS
# ---------------------------------------------------------------------------

CASES = {"random": {}, "ties": dict(ties=True),
         "zero_area": dict(zero_area=True), "thin": dict(thin=True),
         "empty_row": dict(empty_row=True)}


def _scene(case, seed=9, B=5, K=300):
    """The seed of tests/test_pallas_kernels.py's rotated-kernel test, plus
    the hard cases: bf16-tied scores, degenerate boxes, thin pairs, and an
    image entirely below the gate."""
    kw = CASES[case]
    rng = np.random.default_rng(seed)
    boxes = _rboxes(rng, B, K, zero_area=kw.get("zero_area", False),
                    thin=kw.get("thin", False))
    scores = rng.uniform(0, 1, (B, K)).astype(np.float32)
    labels = rng.integers(0, 3, (B, K)).astype(np.int32)
    if kw.get("ties"):
        scores = np.array(jnp.asarray(scores).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    if kw.get("empty_row"):
        scores[1] = 0.1
    return boxes, scores, labels


def _assert_clear_of_threshold(boxes, scores, labels, score_thr, iou_thr):
    """No probIoU between two above-gate candidates of one image lies
    within 1e-6 of the threshold (so ulp differences flip nothing)."""
    shifted = tnms.class_shifted(torch.from_numpy(boxes),
                                 torch.from_numpy(labels), True)
    for b in range(boxes.shape[0]):
        live = shifted[b][torch.from_numpy(scores[b] > score_thr)]
        if len(live):
            iou = tnms.probiou(live[:, None], live[None])
            assert float((iou - iou_thr).abs().min()) > 1e-6


KW = dict(iou_threshold=0.4, score_threshold=0.3, max_det=20)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rotated_plain_matches_pallas_interpret(case):
    """K3's plain version == nms_rotated_batched_pallas, all max_det slots,
    on the same class-shifted boxes and masked scores."""
    boxes, scores, labels = _scene(case)
    _assert_clear_of_threshold(boxes, scores, labels, 0.3, 0.4)
    off = labels.astype(np.float32) * 8192.0
    shifted = boxes.copy()
    shifted[..., 0] += off
    shifted[..., 1] += off
    masked = np.where(scores > np.float32(0.3), scores,
                      pk._NEG).astype(np.float32)
    ji, jo = pk.nms_rotated_batched_pallas(jnp.asarray(shifted),
                                           jnp.asarray(masked), 0.4,
                                           max_det=20, block_b=2,
                                           interpret=True)
    rows = tk.rotated_gaussian_rows(torch.from_numpy(shifted))
    assert rows.shape == (5, 6, 300) and rows.is_contiguous()
    ti, to = tk.nms_rotated_batched_torch(rows, torch.from_numpy(masked),
                                          0.4, 20)
    assert ti.dtype == torch.int32 and to.dtype == torch.bool
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _assert_slate_equal(t, j):
    j = jax.device_get(j)
    for k in ("indices", "labels", "valid", "count", "boxes_xywhr",
              "scores"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["scan", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_fixed_rotated_batched_matches_jax_scan(backend, case):
    """Either backend ("cuda" runs K3's plain version for CPU tensors) ==
    the JAX scan path."""
    boxes, scores, labels = _scene(case)
    args = [jnp.asarray(a) for a in (boxes, scores, labels)]
    j = jnms.nms_fixed_rotated_batched(*args, backend="scan", **KW)
    t = tnms.nms_fixed_rotated_batched(
        *(torch.from_numpy(a) for a in (boxes, scores, labels)),
        backend=backend, **KW)
    _assert_slate_equal(t, j)
    if case == "empty_row":
        assert int(t["count"][1]) == 0 and not t["boxes_xywhr"][1].any()


@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_fixed_rotated_matches_jax(class_aware):
    boxes, scores, labels = _scene("random", seed=10, B=1)
    kw = dict(KW, class_aware=class_aware)
    j = jnms.nms_fixed_rotated(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                               jnp.asarray(labels[0]), **kw)
    t = tnms.nms_fixed_rotated(torch.from_numpy(boxes[0]),
                               torch.from_numpy(scores[0]),
                               torch.from_numpy(labels[0]), **kw)
    _assert_slate_equal(t, j)


def test_rotated_wrapper_on_cpu_runs_plain_and_does_not_count():
    boxes, scores, _ = _scene("random", B=2, K=100)
    rows = tk.rotated_gaussian_rows(torch.from_numpy(boxes))
    masked = torch.where(torch.from_numpy(scores) > 0.3,
                         torch.from_numpy(scores), tk.NEG)
    n = launches.read()["nms_rotated_batched_cuda"]
    got = tk.nms_rotated_batched_cuda(rows, masked, 0.4, 10)
    ref = tk.nms_rotated_batched_torch(rows, masked, 0.4, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert launches.read()["nms_rotated_batched_cuda"] == n


# ---------------------------------------------------------------------------
# postprocess and pipeline
# ---------------------------------------------------------------------------

def _assert_det_close(t, j):
    j = jax.device_get(j)
    for k in ("labels", "valid", "count", "indices"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(t["boxes_xywhr"].numpy(), j["boxes_xywhr"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"].numpy(), j["scores"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(t["slate"].numpy(), j["slate"], atol=1e-3,
                               rtol=0)


def test_postprocess_obb_batch_matches_jax():
    boxes, _, _ = _scene("random", B=2, K=126)
    logits = np.random.default_rng(4).normal(-1, 1.5, (2, 126, 15)).astype(
        np.float32)
    pcfg = dict(POST, max_detections=30)
    j = jpost.postprocess_obb_batch(jnp.asarray(boxes), jnp.asarray(logits),
                                    jconfig.PostprocessConfig(**pcfg),
                                    scores_are_logits=True)
    t = tpost.postprocess_obb_batch(torch.from_numpy(boxes),
                                    torch.from_numpy(logits),
                                    tconfig.PostprocessConfig(**pcfg),
                                    scores_are_logits=True)
    assert int(t["count"].min()) > 0
    _assert_det_close(dict(t, slate=tcompile.pack_slate(t, 30)),
                      dict(j, slate=jcompile.pack_slate(j, 30)))


def test_postprocess_obb_wbf_refused():
    """Once refused (the name is kept): merge="wbf" runs rotated WBF on the
    probabilities, as JAX's postprocess_obb_batch does."""
    rng = np.random.default_rng(5)
    boxes = _rboxes(rng, 2, 400)
    logits = rng.normal(0, 2, (2, 400, 15)).astype(np.float32)
    pcfg = dict(iou_threshold=0.5, score_threshold=0.4, max_detections=30,
                merge="wbf")
    j = jpost.postprocess_obb_batch(jnp.asarray(boxes), jnp.asarray(logits),
                                    jconfig.PostprocessConfig(**pcfg),
                                    scores_are_logits=True)
    t = tpost.postprocess_obb_batch(torch.from_numpy(boxes),
                                    torch.from_numpy(logits),
                                    tconfig.PostprocessConfig(**pcfg),
                                    scores_are_logits=True)
    assert int(t["count"].min()) > 0
    _assert_det_close(dict(t, slate=tcompile.pack_slate(t, 30)),
                      dict(j, slate=jcompile.pack_slate(j, 30)))


@pytest.fixture(scope="module")
def obb_weights():
    jcfg = jconfig.ModelConfig(**MODEL)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        p = jtesting.detection_params(jax.random.key(0), jcfg)
    finally:
        mp.undo()
    return jax.device_get(p)


def _pipelines(weights, **post):
    kw = dict(POST, **post)
    jcfg = jconfig.ExecutorConfig(model=jconfig.ModelConfig(**MODEL),
                                  post=jconfig.PostprocessConfig(**kw))
    tcfg = tconfig.ExecutorConfig(model=tconfig.ModelConfig(**MODEL),
                                  post=tconfig.PostprocessConfig(**kw))
    j = jcompile.build_pipeline(jcfg, weights, frame_hw=(48, 64), batch=2)
    t = tcompile.build_pipeline(tcfg, params_from_jax(weights, tcfg.model),
                                frame_hw=(48, 64), batch=2, device="cpu")
    return j, t


def test_obb_pipeline_matches_jax(obb_weights):
    jpipe, tpipe = _pipelines(obb_weights)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    j, t = jpipe(jnp.asarray(frames)), tpipe(frames)
    assert set(t) == set(jax.device_get(j))
    assert int(t["count"].min()) == 50          # the fixture always detects
    assert t["slate"].shape == (2, 50 * 8 + 1)
    _assert_det_close(t, j)


def test_obb_pipeline_backends_agree_on_cpu(obb_weights):
    """The pipeline's "auto" NMS and the explicit scan comparison
    (postprocess_obb_batch(backend="scan") on the same raw outputs) give
    the same slate."""
    _, tpipe = _pipelines(obb_weights)
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    det = tpipe(frames)
    x = tcompile.pre_ops.preprocess(torch.from_numpy(frames), SIZE,
                                    dtype=torch.float32)
    with torch.no_grad():
        out = tpipe.params(x, concat_preds=False)
    ref = tpost.postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                      tpipe.cfg.post, scores_are_logits=True,
                                      backend="scan")
    assert torch.equal(det["slate"], tcompile.pack_slate(ref, 50))


def test_unpack_slate_box_dim5_round_trip(obb_weights):
    _, tpipe = _pipelines(obb_weights)
    det = tpipe(np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3),
                                                  np.uint8))
    h = tcompile.unpack_slate(det["slate"][1], 50, box_dim=5)
    np.testing.assert_array_equal(h["boxes_xywhr"],
                                  det["boxes_xywhr"][1].numpy())
    np.testing.assert_array_equal(h["scores"], det["scores"][1].numpy())
    np.testing.assert_array_equal(h["labels"], det["labels"][1].numpy())
    np.testing.assert_array_equal(h["valid"], det["valid"][1].numpy())
    assert h["count"] == int(det["count"][1]) and "boxes_xywh" not in h
