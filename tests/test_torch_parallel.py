"""The port's parallel/ package (xrseg_tpu_torch/parallel) on the CPU, case
by case against tests/test_parallel.py.

Torch has one CPU device, so the meshes repeat it ([cpu] * n); JAX's side
uses conftest's 8 virtual devices. Held against JAX: the mesh shapes, the
TP and FSDP rules leaf by leaf on the same tree (each port dim mapped to
the JAX dim the bridge gives it: the depthwise [C,1,3,3] weights and the
FSDP tie-break included), and DP+TP against JAX's build_sharded_pipeline
(the module's one JAX compile; scores atol 1e-4, counts equal). Held
against the port's own unsharded pipeline, which the earlier slices hold
against JAX: DP (each shard bit-equal to build_pipeline at the shard's
batch, the whole batch within atol 1e-4), MultiStreamRunner, SP at
256x256 over 4 bands, PP with run_stream over 5 frames, and the task
family (obb through DP, classify through DP, pose through PP and SP; obb,
classify and YOLOv8 detect through SP).
Weights: tests/torch_parity.detecting_tree, float32, 64x64 unless said.
"""
import jax
import numpy as np
import pytest
import torch

from xrseg_tpu import config as jconfig
from xrseg_tpu.parallel import batch as jbatch
from xrseg_tpu.parallel import mesh as jmesh
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.io.bridge import jax_dims, params_from_jax
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.parallel import batch as tbatch
from xrseg_tpu_torch.parallel import mesh as tmesh
from xrseg_tpu_torch.parallel.pipeline import PipelinedRunner
from xrseg_tpu_torch.parallel.spatial import build_spatial_pipeline
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree, seeded_tree

limit_cpu_threads()

CPU = torch.device("cpu")
MODEL = dict(scale="n", input_size=(64, 64), dtype="float32")
POST = dict(pre_nms_topk=64, max_detections=10)
LEAF = {"w": "weight", "b": "bias"}


def _cfgs(post=POST, **model):
    kw = dict(MODEL, **model)
    return (jconfig.ExecutorConfig(model=jconfig.ModelConfig(**kw),
                                   post=jconfig.PostprocessConfig(**post)),
            tconfig.ExecutorConfig(model=tconfig.ModelConfig(**kw),
                                   post=tconfig.PostprocessConfig(**post)))


def _weights(seed=0, post=POST, **model):
    jcfg, tcfg = _cfgs(post, **model)
    jp = detecting_tree(jcfg.model, seed=seed)
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg.model)


def _frames(n, seed, hw=(64, 64)):
    return np.random.default_rng(seed).integers(
        0, 255, (n,) + tuple(hw) + (3,)).astype(np.uint8)


def _mesh(shape):
    return tmesh.make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


def _np(x):
    return x.detach().float().numpy()


def _jax_leaves(tree):
    """{port state-dict name: JAX leaf} for a JAX params-shaped tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        keys[-1] = LEAF.get(keys[-1], keys[-1])
        out[".".join(keys)] = leaf
    return out


def _as_jax_spec(sh: tmesh.Sharding, name: str, ndim: int) -> tuple:
    """The port's spec, each dim moved to the JAX dim the bridge maps it
    to (what JAX's PartitionSpec names for the same leaf)."""
    if sh.axis is None:
        return ()
    out = [None] * ndim
    out[jax_dims(name.rsplit(".", 1)[-1], ndim)[sh.dim]] = sh.axis
    return tuple(out)


def test_mesh_construction():
    assert tmesh.make_mesh((8, 1), devices=[CPU] * 8).shape == \
        dict(jmesh.make_mesh((8, 1)).shape) == {"data": 8, "model": 1}
    assert _mesh((4, 2)).shape == dict(jmesh.make_mesh((4, 2)).shape)
    assert tmesh.make_mesh(devices=[CPU] * 3).shape == {"data": 3,
                                                        "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_mesh((3, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jmesh.make_mesh((3, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


@pytest.mark.parametrize("task,tp", [("segment", 64), ("segment", 256),
                                     ("obb", 64), ("classify", 64)])
def test_tp_rule_matches_jax(task, tp):
    """Leaf by leaf: the port's TP spec, mapped through the layout, is
    JAX's. The port reads a conv's output channels at OIHW dim 0 (and the
    Proto's up_w at dim 1); the depthwise [C,1,3,3] weights shard C."""
    jcfg, tcfg = _cfgs(task=task, num_classes=7 if task == "classify"
                       else 80)
    tree = seeded_tree(jcfg.model)
    want = _jax_leaves(jmesh.param_shardings(
        tree, jmesh.make_mesh((4, 2)), tp))
    model = params_from_jax(tree, tcfg.model)
    got = tmesh.param_shardings(model, _mesh((4, 2)), tp)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert set(got) == set(want)
    for name, sh in got.items():
        assert _as_jax_spec(sh, name, len(shapes[name])) == \
            tuple(want[name].spec), name
    sharded = {n for n, s in got.items() if s.axis == "model"}
    assert sharded
    if task == "segment" and tp == 64:
        assert got["det.cv3.0.dw0.weight"] == tmesh.Sharding("model", 0)
        assert shapes["det.cv3.0.dw0.weight"] == (64, 1, 3, 3)
        assert got["proto.up_w"] == tmesh.Sharding("model", 1)


@pytest.mark.parametrize("shape,axis,min_size", [((8, 1), "data", 65536),
                                                 ((4, 2), "data", 1024),
                                                 ((2, 4), "model", 512)])
def test_fsdp_rule_matches_jax(shape, axis, min_size):
    """Leaf by leaf, FSDP picks the same JAX dim: ties go to JAX's last
    (output) dim, which is the port's dim 0 of an OIHW weight, not its
    last (a literal port of the sort would shard the input channels)."""
    jcfg, tcfg = _cfgs()
    tree = seeded_tree(jcfg.model)
    want = _jax_leaves(jmesh.fsdp_param_shardings(
        tree, jmesh.make_mesh(shape), axis, min_size))
    model = params_from_jax(tree, tcfg.model)
    got = tmesh.fsdp_param_shardings(model, _mesh(shape), axis, min_size)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    for name, sh in got.items():
        assert _as_jax_spec(sh, name, len(shapes[name])) == \
            tuple(want[name].spec), name
    if shape == (4, 2):
        # b3: Conv(64, 64, 3, s2), [64, 64, 3, 3] ties O with I
        assert shapes["b3.weight"] == (64, 64, 3, 3)
        assert got["b3.weight"] == tmesh.Sharding("data", 0)
        assert shapes["proto.up_w"] == (64, 64, 2, 2)
        assert got["proto.up_w"] == tmesh.Sharding("data", 1)


def test_sliced_convs_equal_the_conv():
    """TP's channel slices: a plain conv over 3 devices (ragged 64 = 22 +
    21 + 21), a depthwise one (input channels sliced too) and the Proto's
    transposed conv equal the unsliced modules bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 8, 8, generator=g)
    for conv in (L.Conv(64, 64, 3), L.dwconv(64, 3), L.Conv(64, 64, 3, 2)):
        conv.dtype = torch.float32
        conv.reset_parameters(g)
        with torch.no_grad():
            conv.bias.uniform_(-1, 1, generator=g)
            sliced = tbatch._SlicedConv(conv, [CPU] * 3)
            assert [hi - lo for lo, hi in sliced.bounds] == [22, 21, 21]
            np.testing.assert_array_equal(_np(sliced(x)), _np(conv(x)))
    proto = L.Proto(64, 64, 8, torch.float32)
    L.reset_parameters(proto, g)
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(tbatch._SlicedProto(proto, [CPU] * 2)(x)), _np(proto(x)))


def test_dp_inference_matches_single_device():
    """Each data shard bit-equal to build_pipeline at the shard's batch;
    the gathered batch within atol 1e-4 of the unsharded b=8 pipeline."""
    _, tcfg, _, model = _weights(seed=0)
    frames = _frames(8, 0)
    mesh = _mesh((4, 1))
    fn, sp = tbatch.build_sharded_pipeline(tcfg, model, mesh, batch=8)
    det = fn(sp, frames)
    shard = build_pipeline(tcfg, model, batch=2, device="cpu")
    for i in range(4):
        ref = shard(frames[2 * i:2 * i + 2])
        for k in ref:
            np.testing.assert_array_equal(_np(det[k][2 * i:2 * i + 2]),
                                          _np(ref[k]), err_msg=k)
    ref = build_pipeline(tcfg, model, batch=8, device="cpu")(frames)
    assert int(det["count"].min()) > 0
    np.testing.assert_allclose(_np(det["boxes_xywh"]),
                               _np(ref["boxes_xywh"]), atol=1e-4)
    np.testing.assert_array_equal(_np(det["count"]), _np(ref["count"]))


def test_dp_tp_matches_jax_sharded_pipeline():
    """(4, 2) mesh, TP on every conv of >= 64 output channels: the port's
    slate against JAX's sharded pipeline on the same weights."""
    jcfg, tcfg, jp, model = _weights(seed=1)
    frames = _frames(4, 1)
    fn, sp = jbatch.build_sharded_pipeline(
        jcfg, jp, jmesh.make_mesh((4, 2)), batch=4, frame_hw=(64, 64),
        tp_min_channels=64)
    want = jax.device_get(fn(sp, frames))
    tfn, tsp = tbatch.build_sharded_pipeline(
        tcfg, model, _mesh((4, 2)), batch=4, tp_min_channels=64)
    kinds = {type(m).__name__ for m in tsp[0].modules()}
    assert {"_SlicedConv", "_SlicedProto"} <= kinds
    assert all(r is tsp[0] for r in tsp)      # one row's devices: one copy
    got = tfn(tsp, frames)
    assert int(np.asarray(want["count"]).min()) > 0
    np.testing.assert_array_equal(_np(got["count"]), want["count"])
    np.testing.assert_array_equal(_np(got["labels"]), want["labels"])
    np.testing.assert_allclose(_np(got["scores"]), want["scores"],
                               atol=1e-4)
    np.testing.assert_allclose(_np(got["boxes_xywh"]), want["boxes_xywh"],
                               atol=1e-3)


def test_batch_divisibility_check():
    _, tcfg, _, model = _weights()
    with pytest.raises(ValueError, match="not divisible"):
        tbatch.build_sharded_pipeline(tcfg, model, _mesh((8, 1)), batch=5)
    fn, sp = tbatch.build_sharded_pipeline(tcfg, model, _mesh((2, 1)),
                                           batch=2)
    with pytest.raises(ValueError, match="built for 2"):
        fn(sp, _frames(4, 0))


def test_multistream_runner_and_serving_pipeline():
    _, tcfg, _, model = _weights(seed=2)
    mesh = _mesh((2, 1))
    runner = tbatch.MultiStreamRunner(tcfg, model, mesh, n_streams=2)
    frames = _frames(2, 3)
    det = runner(frames)
    assert det["count"].shape == (2,)
    ref = build_pipeline(tcfg, model, batch=2, device="cpu")(frames)
    np.testing.assert_allclose(_np(det["slate"]), _np(ref["slate"]),
                               atol=1e-4)
    assert tbatch._split_streams(np.zeros((4, 8, 8, 3)), 2).shape == \
        (2, 2, 8, 8, 3)
    # the serving adapter: warmup, one readback, reshard to new weights
    pipe = tbatch.build_serving_pipeline(tcfg, model, mesh,
                                         batch=2).warmup()
    pipe.readback.start(pipe(frames)["slate"])
    np.testing.assert_allclose(pipe.readback.host().reshape(2, -1),
                               _np(ref["slate"]), atol=1e-4)
    _, _, _, new = _weights(seed=3)
    swapped = tbatch.ShardedPipeline(**{**pipe.__dict__,
                                        "params": pipe.reshard(new)})
    ref_new = build_pipeline(tcfg, new, batch=2, device="cpu")(frames)
    np.testing.assert_allclose(_np(swapped(frames)["slate"]),
                               _np(ref_new["slate"]), atol=1e-4)


def test_spatial_partitioning_matches_single_device():
    """SP at 256x256 over 4 bands (P5 has 2 rows a band: SPPF's 5x5
    pools take their halo from two bands); an H that does not divide
    raises."""
    _, tcfg, _, model = _weights(seed=2, input_size=(256, 256))
    frames = _frames(1, 3, (256, 256))
    fn, rp = build_spatial_pipeline(tcfg, model, _mesh((4, 1)), batch=1,
                                    frame_hw=(256, 256))
    det = fn(rp, frames)
    ref = build_pipeline(tcfg, model, batch=1, device="cpu")(frames)
    assert int(ref["count"][0]) > 0
    np.testing.assert_allclose(_np(det["scores"]), _np(ref["scores"]),
                               atol=1e-4)
    np.testing.assert_array_equal(_np(det["count"]), _np(ref["count"]))
    np.testing.assert_allclose(_np(det["masks"]), _np(ref["masks"]),
                               atol=1e-4)
    with pytest.raises(ValueError, match="multiple-of-32"):
        build_spatial_pipeline(tcfg, model, _mesh((3, 1)))


@pytest.mark.parametrize("model", [
    dict(task="obb"), dict(task="classify", num_classes=7),
    dict(arch="yolov8", task="detect")],
    ids=["obb", "classify", "yolov8-detect"])
def test_spatial_partitioning_runs_every_block_family(model):
    """SP over 2 bands runs each block's own forward on its widened band:
    the obb and classify heads and YOLOv8's C2f backbone (no C2PSA) equal
    the unsharded pipeline, every output (integers exactly)."""
    post = dict(score_threshold=0.05, max_detections=5)
    _, tcfg, _, tmodel = _weights(seed=3, post=post, **model)
    frames = _frames(1, 9)
    fn, rp = build_spatial_pipeline(tcfg, tmodel, _mesh((2, 1)), batch=1)
    det = fn(rp, frames)
    ref = build_pipeline(tcfg, tmodel, batch=1, device="cpu")(frames)
    assert set(det) == set(ref)
    if "count" in ref:
        assert int(ref["count"][0]) > 0
    for k, want in ref.items():
        if want.dtype.is_floating_point:
            np.testing.assert_allclose(_np(det[k]), _np(want), atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(det[k].numpy(), want.numpy(),
                                          err_msg=k)


def test_pipeline_parallel_matches_single_device():
    """PP: the two stages equal the direct pipeline; run_stream gives one
    result per input batch, in order, with more frames than in flight."""
    _, tcfg, _, model = _weights(seed=4)
    runner = PipelinedRunner(tcfg, model, devices=[CPU, CPU], batch=2)
    runner.warmup()
    assert not any(n.startswith("h") for n, _ in
                   runner.stage_a_model.named_children())
    assert not any(n.startswith("b") for n, _ in
                   runner.stage_b_model.named_children())
    frames = _frames(2, 5)
    ref = build_pipeline(tcfg, model, batch=2, device="cpu")(frames)
    det = runner(frames)
    np.testing.assert_allclose(_np(det["scores"]), _np(ref["scores"]),
                               atol=1e-4)
    stream = [_frames(2, 5 + i) for i in range(5)]
    outs = runner.run_stream(iter(stream), max_inflight=2)
    assert len(outs) == 5
    direct = build_pipeline(tcfg, model, batch=2, device="cpu")
    for f, o in zip(stream, outs):
        np.testing.assert_allclose(_np(o["slate"]), _np(direct(f)["slate"]),
                                   atol=1e-4)


def test_pipeline_parallel_needs_two_devices():
    _, tcfg, _, model = _weights()
    with pytest.raises(ValueError, match=">= 2 devices"):
        PipelinedRunner(tcfg, model, devices=[CPU])


def test_sharded_pipeline_speaks_task_family():
    """obb (K3's plain version per shard) and classify over DP (8, 1)
    equal the unsharded pipeline."""
    mesh = _mesh((8, 1))
    frames = _frames(8, 5)
    post = dict(score_threshold=0.05, max_detections=5)
    _, ocfg, _, omodel = _weights(seed=3, post=post, task="obb")
    fn, sp = tbatch.build_sharded_pipeline(ocfg, omodel, mesh, batch=8)
    det = fn(sp, frames)
    ref = build_pipeline(ocfg, omodel, batch=8, device="cpu")(frames)
    assert int(det["count"].min()) > 0
    np.testing.assert_array_equal(_np(det["count"]), _np(ref["count"]))
    np.testing.assert_allclose(_np(det["boxes_xywhr"]),
                               _np(ref["boxes_xywhr"]), atol=1e-4)
    _, ccfg, _, cmodel = _weights(task="classify", num_classes=7)
    cfn, csp = tbatch.build_sharded_pipeline(ccfg, cmodel, mesh, batch=8)
    cref = build_pipeline(ccfg, cmodel, batch=8, device="cpu")(frames)
    np.testing.assert_allclose(_np(cfn(csp, frames)["probs"]),
                               _np(cref["probs"]), atol=1e-5)


def test_pp_and_sp_speak_tasks():
    """Pose keypoints through PP and through SP ((2, 4) mesh: 64 rows = 2
    bands of 32) equal the unsharded pipeline; classify through PP
    raises."""
    post = dict(score_threshold=0.05, max_detections=5)
    _, pcfg, _, model = _weights(seed=3, post=post, task="pose",
                                 kpt_shape=(5, 3))
    frames = _frames(2, 7)
    ref = build_pipeline(pcfg, model, batch=2, device="cpu")(frames)
    det = PipelinedRunner(pcfg, model, devices=[CPU, CPU], batch=2)(frames)
    np.testing.assert_array_equal(_np(det["count"]), _np(ref["count"]))
    np.testing.assert_allclose(_np(det["kpts"]), _np(ref["kpts"]), atol=1e-4)
    spfn, spp = build_spatial_pipeline(pcfg, model, _mesh((2, 4)), batch=2)
    spdet = spfn(spp, frames)
    np.testing.assert_array_equal(_np(spdet["count"]), _np(ref["count"]))
    np.testing.assert_allclose(_np(spdet["kpts"]), _np(ref["kpts"]),
                               atol=1e-4)
    _, ccfg, _, cmodel = _weights(task="classify")
    with pytest.raises(ValueError, match="classify"):
        PipelinedRunner(ccfg, cmodel, devices=[CPU, CPU])
