"""Card-only tests of the port's CUDA kernels (marker `cuda`).

A CUDA kernel has no interpret mode, so these skip on a host without a
card. The file imports neither JAX nor the JAX package, so it also runs
on the card's machine, which has no JAX; tests/conftest.py imports JAX,
hence --noconftest there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The NMS kernels (K1-K3) must give the plain versions' idx/ok exactly, under
the launch plan's own cluster size and under every forced one (1, 2, 4, 8
blocks per image; a size whose blocks cannot hold K must be refused). K4
must zero exactly the pixels its plain version zeroes, with values within
1e-5 (the dot products are summed in another order than cuBLAS's). The
WBF scans (K5, K6) must give every output of their plain versions exactly,
at 1 to 80 labels and max_det up to the 1024 a block holds, without a host
synchronisation.
"""
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from xrseg_tpu_torch.compile import build_pipeline, decode_task_outputs, pack_slate
from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig, PostprocessConfig
from xrseg_tpu_torch.ops import mask_kernels as mk
from xrseg_tpu_torch.ops import nms as tnms
from xrseg_tpu_torch.ops import nms_kernels as tk
from xrseg_tpu_torch.ops import wbf
from xrseg_tpu_torch.ops.postprocess import postprocess_obb_batch
from xrseg_tpu_torch.ops.preprocess import preprocess
from xrseg_tpu_torch.testing import detection_params, limit_cpu_threads

limit_cpu_threads()

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


CLUSTERS = [None, 1, 2, 4, 8]         # None: launch_plan's own choice


def _check_nms(what, kernel, plain, args, B, K, cluster, card, thr):
    """kernel == plain under `cluster`; a forced size that cannot hold K
    must raise instead of launching."""
    try:
        tk.launch_plan(what, B, K, *tk.device_limits(what, card),
                       cluster=cluster)
    except ValueError:
        with pytest.raises(ValueError, match="cannot hold"):
            kernel(*args, thr, 50, cluster=cluster)
        return
    before = kernel.launches
    got = kernel(*args, thr, 50, cluster=cluster)
    ref = plain(*args, thr, 50)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kernel.launches == before + 1


CASES = {"random": {}, "ties": dict(ties=True),
         "zero_area": dict(zero_area=True), "empty": dict(empty_last=True)}


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B,K", [(1, 8400), (5, 8400), (5, 8399), (3, 257),
                                 (2, 1), (1, 21504), (3, 21504), (40, 8400)])
def test_k1_equals_plain(card, case, B, K, cluster):
    c, m = (t.to(card) for t in _inputs(B * K, B, K, **CASES[case]))
    _check_nms("nms_select", tk.nms_select_batched_cuda,
               tk.nms_select_batched_torch, (c, m), B, K, cluster, card, 0.45)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("K", [8400, 1024, 33])
def test_k2_equals_plain(card, case, K, cluster):
    c, m = (t.to(card) for t in _inputs(K, 1, K, **CASES[case]))
    _check_nms("nms_select", tk.nms_select_cuda, tk.nms_select_torch,
               (c[0], m[0]), 1, K, cluster, card, 0.6)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    c, m = (t.to(card) for t in _inputs(0, 1, 64))
    with pytest.raises(TypeError, match="float32"):
        tk.nms_select_batched_cuda(c.double(), m, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tk.nms_select_batched_cuda(c[:, ::2], m[:, ::2], 0.5)
    with pytest.raises(ValueError, match="aligned"):
        tk.nms_select_cuda(torch.zeros(64 * 4 + 1, device=card)[1:]
                           .view(64, 4), m[0], 0.5)
    with pytest.raises(ValueError, match="the sizes that can are"):
        tk.nms_select_batched_cuda(c, m, 0.5, cluster=3)
    # the largest K is what 8 blocks' shared memory holds: 92160 candidates
    # of 20 bytes, 65824 of 28 bytes on an H100
    big = tk.max_candidates("nms_select", card) + 1
    assert big > 21504
    mb = torch.zeros((1, big), device=card)
    with pytest.raises(ValueError, match=f"shared-memory limit of {big - 1}"):
        tk.nms_select_batched_cuda(torch.zeros((1, big, 4), device=card), mb,
                                   0.5)
    big = tk.max_candidates("nms_rotated", card) + 1
    assert big > 21504
    rows, mb = torch.zeros((1, 6, big), device=card), mb[:, :big]
    with pytest.raises(ValueError, match=f"shared-memory limit of {big - 1}"):
        tk.nms_rotated_batched_cuda(rows, mb, 0.5)
    with pytest.raises(ValueError, match="does not match"):
        tk.nms_rotated_batched_cuda(rows[:, :5], mb, 0.5)


@pytest.mark.parametrize("what", ["nms_select", "nms_rotated"])
def test_device_limits(card, what):
    """What the launch plan is made from, as the card answers: its SMs, a
    block's opt-in shared memory, and the clusters of each size that run at
    once with an SM to each block (at most SMs // size, at least one)."""
    sm_count, smem_optin, room = tk.device_limits(what, card)
    props = torch.cuda.get_device_properties(card)
    assert sm_count == props.multi_processor_count
    assert smem_optin > 48 * 1024
    assert sorted(room) == list(tk.CLUSTER_SIZES)
    assert all(1 <= room[c] <= sm_count // c for c in room)


@pytest.mark.parametrize("what", ["nms_select", "nms_rotated"])
def test_largest_k_runs(card, what):
    """The plan's largest K fills the shared memory of 8 blocks an image;
    the card must place that cluster and the kernel equal the plain loop."""
    K = tk.max_candidates(what, card)
    if what == "nms_select":
        args = [t.to(card) for t in _inputs(7, 2, K, ties=True)]
        kernel, plain = tk.nms_select_batched_cuda, tk.nms_select_batched_torch
    else:
        args = [t.to(card) for t in _rotated_inputs(7, 2, K, ties=True)]
        kernel, plain = (tk.nms_rotated_batched_cuda,
                         tk.nms_rotated_batched_torch)
    assert tk.launch_plan(what, 2, K, *tk.device_limits(what, card))[0] == 8
    _check_nms(what, kernel, plain, args, 2, K, None, card, 0.45)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("what", ["K1", "K2", "K3"])
def test_all_below_gate_leaves_at_step_0(card, what, cluster):
    """Every candidate below the gate: ok is false from step 0 on and every
    step repeats index 0, whatever the cluster size; blocks with an empty
    slice (K = 33 on 8 blocks) included."""
    for B, K in ((3, 8199), (2, 33)):   # 8199: K3's rows fit one block
        if what == "K3":
            rows, _ = _rotated_inputs(3, B, K)
            args, kernel = (rows.to(card),), tk.nms_rotated_batched_cuda
        else:
            corners, _ = _inputs(3, B, K)
            args, kernel = (corners.to(card),), tk.nms_select_batched_cuda
        m = torch.full((B, K), tk.NEG, device=card)
        if what == "K2":
            args, m, kernel = (args[0][0],), m[0], tk.nms_select_cuda
        idx, ok = kernel(*args, m, 0.45, 50, cluster=cluster)
        torch.cuda.synchronize()
        assert not bool(ok.any()) and not bool(idx.any())
        assert ok.shape == idx.shape == m.shape[:-1] + (50,)


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


def _rotated_inputs(seed, B, K, ties=False, zero_area=False, thin=False,
                    empty_last=False):
    """K3's inputs on the CPU: Gaussian rows [B,6,K] of class-shifted
    rotated boxes and masked scores [B,K]."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0, 1024, (B, K, 2)),
                            rng.uniform(4, 120, (B, K, 2)),
                            rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, K, 1))],
                           -1).astype(np.float32)
    if zero_area:
        boxes[:, ::7, 2] = 0.0
    if thin:
        boxes[:, 1:64:2, :2] = boxes[:, 0:64:2, :2] + np.float32(0.3)
        boxes[:, :64, 2:4] = np.float32([64.0, 0.5])
        boxes[:, 1:64:2, 4] = boxes[:, 0:64:2, 4] + np.float32(1e-3)
    scores = torch.from_numpy(rng.normal(0, 1.5, (B, K)).astype(np.float32))
    if ties:
        scores = scores.bfloat16().float()
    if empty_last:
        scores[-1] = -10.0
    labels = torch.from_numpy(rng.integers(0, 15, (B, K)))
    shifted = tnms.class_shifted(torch.from_numpy(boxes), labels, True)
    return (tk.rotated_gaussian_rows(shifted),
            torch.where(scores > -1.2, scores, tk.NEG))


ROTATED_CASES = {"random": {}, "ties": dict(ties=True),
                 "zero_area": dict(zero_area=True), "thin": dict(thin=True),
                 "empty": dict(empty_last=True)}


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", sorted(ROTATED_CASES))
@pytest.mark.parametrize("B,K", [(1, 21504), (4, 21504), (5, 8399), (3, 300),
                                 (3, 257), (2, 1), (40, 8400)])
def test_k3_equals_plain(card, case, B, K, cluster):
    rows, m = (t.to(card) for t in _rotated_inputs(
        B * K + 1, B, K, **ROTATED_CASES[case]))
    _check_nms("nms_rotated", tk.nms_rotated_batched_cuda,
               tk.nms_rotated_batched_torch, (rows, m), B, K, cluster, card,
               0.45)


# test-time augmentation concatenates the views' candidates: K1 at
# 2 x 8400 (640x640, 2 views), K3 at 2 x 21504 and 3 x 21504 (1024x1024,
# 2 views and ULTRALYTICS_TTA_VIEWS), the last just under K3's limit
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B", [1, 8])
def test_k1_at_the_tta_width_equals_plain(card, case, B):
    K = 16800
    c, m = (t.to(card) for t in _inputs(B * K + 2, B, K, **CASES[case]))
    _check_nms("nms_select", tk.nms_select_batched_cuda,
               tk.nms_select_batched_torch, (c, m), B, K, None, card, 0.45)


@pytest.mark.parametrize("case", sorted(ROTATED_CASES))
@pytest.mark.parametrize("B,K", [(1, 43008), (2, 43008), (1, 64512),
                                 (2, 64512)])
def test_k3_at_the_tta_width_equals_plain(card, case, B, K):
    assert K <= tk.max_candidates("nms_rotated", card)
    rows, m = (t.to(card) for t in _rotated_inputs(
        B * K + 3, B, K, **ROTATED_CASES[case]))
    _check_nms("nms_rotated", tk.nms_rotated_batched_cuda,
               tk.nms_rotated_batched_torch, (rows, m), B, K, None, card,
               0.45)


FLIP17 = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


@pytest.mark.parametrize("task,tta", [("pose", False), ("pose", True),
                                      ("segment", True), ("obb", True)])
def test_task_and_tta_pipelines_go_through_the_kernels(card, task, tta,
                                                       monkeypatch):
    """The pose pipeline launches K1 once a batch, and so do segment and
    pose with 2-view TTA (K = 2A); obb TTA launches K3 once. Each slate
    equals the plain NMS's on the same pipeline."""
    model_cfg = ModelConfig(task=task, input_size=(128, 128),
                            num_classes=15 if task == "obb" else 80)
    cfg = ExecutorConfig(model=model_cfg)
    model = detection_params(torch.Generator().manual_seed(0), model_cfg,
                             device=card)
    kw = dict(frame_hw=(96, 128), batch=2, tta=tta,
              tta_kpt_flip_idx=FLIP17 if task == "pose" and tta else None)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3),
                                               np.uint8)
    kernel = (tk.nms_rotated_batched_cuda if task == "obb"
              else tk.nms_select_batched_cuda)
    before = kernel.launches
    got = build_pipeline(cfg, model, **kw)(frames)
    assert kernel.launches == before + 1
    # the plain NMS: pose and obb postprocess take their own backend
    # argument ("auto"), so the reference forces "scan" underneath
    for name in ("nms_fixed_batched", "nms_fixed_rotated_batched"):
        real = getattr(tnms, name)
        monkeypatch.setattr(tnms, name, lambda *a, _f=real, **k: _f(
            *a, **dict(k, backend="scan")))
    ref = build_pipeline(cfg, model, **kw)(frames)
    assert kernel.launches == before + 1
    assert torch.equal(got["slate"], ref["slate"])
    assert torch.equal(got["indices"], ref["indices"])
    assert int(got["count"].min()) == 50
    if tta:
        assert bool((got["indices"] >= model_cfg.num_anchors).any())


def _mask_inputs(seed, B, D, hw, input_size):
    rng = np.random.default_rng(seed)
    H, W = input_size
    coefs = rng.standard_normal((B, D, 32)).astype(np.float32)
    protos = rng.standard_normal((B,) + hw + (32,)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 1, (B, D, 2)) * [W, H],
                            rng.uniform(0, 0.6, (B, D, 2)) * [W, H]],
                           -1).astype(np.float32)
    boxes[:, 0] = [8 * W / hw[1], 6 * H / hw[0], 4 * W / hw[1],
                   4 * H / hw[0]]             # edges on pixel centres
    return [torch.from_numpy(a) for a in (coefs, protos, boxes)]


@pytest.mark.parametrize("B,D,hw,input_size", [
    (8, 50, (160, 160), (640, 640)), (1, 50, (160, 160), (640, 640)),
    (2, 13, (17, 23), (68, 92)), (None, 3, (16, 24), (64, 96))])
def test_k4_equals_plain(card, B, D, hw, input_size):
    args = _mask_inputs(D, B or 1, D, hw, input_size)
    if B is None:
        args = [a[0] for a in args]
    args = [a.to(card) for a in args]
    before = mk.mask_synth_crop_cuda.launches
    got = mk.mask_synth_crop_cuda(*args, hw, input_size)
    ref = mk.mask_synth_crop_torch(*args, hw, input_size)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got == 0, ref == 0)
    assert float((got - ref).abs().max()) <= 1e-5
    assert mk.mask_synth_crop_cuda.launches == before + 1


def test_obb_pipeline_goes_through_k3(card):
    cfg = ExecutorConfig(model=ModelConfig(task="obb", num_classes=15,
                                           input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3),
                                               np.uint8)
    pipe = build_pipeline(cfg, model, frame_hw=(96, 128), batch=2)
    before = tk.nms_rotated_batched_cuda.launches
    got = pipe(frames)
    assert tk.nms_rotated_batched_cuda.launches == before + 1
    assert int(got["count"].min()) == 50 and got["slate"].shape == (2, 401)
    # the scan comparison on the same raw outputs
    x = preprocess(torch.from_numpy(frames).to(card), (128, 128),
                   dtype=model.dtype)
    with torch.inference_mode():
        out = model(x, concat_preds=False)
    kern = decode_task_outputs(out, cfg.model, cfg.post)
    ref = postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                cfg.post, scores_are_logits=True,
                                backend="scan")
    assert torch.equal(kern["slate"], pack_slate(ref, 50))
    assert torch.equal(got["slate"], kern["slate"])


# K4 at ragged sizes: mask widths that are no multiple of the warp's tile
# (32 pixels of a row), tile counts that are no multiple of a block's
# warps, one instance and fifty, and boxes wholly outside the mask.
@pytest.mark.parametrize("D", [1, 50])
@pytest.mark.parametrize("hw,input_size", [
    ((17, 23), (68, 92)), ((33, 65), (132, 260)), ((7, 160), (28, 640)),
    ((5, 31), (20, 124)), ((160, 160), (640, 640))])
def test_k4_ragged_sizes_and_outside_boxes(card, hw, input_size, D):
    coefs, protos, boxes = _mask_inputs(7 + D, 2, D, hw, input_size)
    H, W = input_size
    boxes[0, -1] = torch.tensor([-3.0 * W, 0.5 * H, 0.2 * W, 0.2 * H])
    boxes[1, -1] = torch.tensor([0.5 * W, 2.0 * H, 0.2 * W, 0.2 * H])
    args = [a.to(card) for a in (coefs, protos, boxes)]
    got = mk.mask_synth_crop_cuda(*args, hw, input_size)
    ref = mk.mask_synth_crop_torch(*args, hw, input_size)
    torch.cuda.synchronize()
    assert torch.equal(got == 0, ref == 0)
    assert float((got - ref).abs().max()) <= 1e-5
    assert not bool(got[:, -1].any())         # the boxes outside the mask


def test_k4_refuses_misaligned_inputs(card):
    coefs, protos, boxes = [a.to(card) for a in
                            _mask_inputs(3, 1, 4, (16, 16), (64, 64))]
    before = mk.mask_synth_crop_cuda.launches
    shifted = torch.empty(coefs.numel() + 1, device=card)[1:].view_as(coefs)
    with pytest.raises(ValueError, match="16-byte"):
        mk.mask_synth_crop_cuda(shifted.copy_(coefs), protos, boxes, (16, 16),
                                (64, 64))
    assert mk.mask_synth_crop_cuda.launches == before


# ---------------------------------------------------------------------------
# the pinned side-stream readback
# ---------------------------------------------------------------------------

def _tick_inputs(cfg, frame_hw, seed):
    from xrseg_tpu_torch.testing import xr_frames
    f = xr_frames(1, frame_hw, (32, 32), seed=seed)[0]
    aux = np.zeros(19, np.float32)
    aux[0:6] = (*f.intrinsics.focal_length, *f.intrinsics.principal_point,
                *f.intrinsics.resolution)
    aux[12] = 1.0                              # identity rotation
    aux[13:17] = (32.0, 32.0, 0.0, 1.0)        # a locked target of class 0
    aux[17:19] = (frame_hw[1] / cfg.model.input_size[1],
                  frame_hw[0] / cfg.model.input_size[0])
    return f.rgb[None], f.depth_fp16, aux


def test_pinned_readback_equals_packed_and_results_survive(card):
    from xrseg_tpu_torch.compile import build_xr_tick_pipeline
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    pipe = build_xr_tick_pipeline(cfg, model, frame_hw=(96, 128),
                                  depth_hw=(32, 32)).warmup()
    assert pipe.readback.buffer.is_pinned()
    assert pipe.readback.buffer.numel() == pipe.packed_len
    out = pipe(*_tick_inputs(cfg, (96, 128), 0))
    pipe.readback.start(out["packed"])
    pipe.readback.wait()
    assert pipe.readback.computed() and pipe.readback.copied()
    want = out["packed"].cpu().numpy()
    np.testing.assert_array_equal(pipe.readback.host(), want)
    first = pipe.unpack(pipe.readback.host())
    assert first["matched"]
    kept = {k: np.array(v) for k, v in first.items()}
    # a second dispatch overwrites the buffer, not what unpack returned
    out2 = pipe(*_tick_inputs(cfg, (96, 128), 1))
    pipe.readback.start(out2["packed"])
    pipe.readback.wait()
    assert not np.array_equal(pipe.readback.host(), want)
    for k, v in first.items():
        np.testing.assert_array_equal(np.asarray(v), kept[k], err_msg=k)


def test_executor_on_the_card_polls_events(card):
    import time

    from xrseg_tpu_torch.runtime.executor import ExecState, Executor
    from xrseg_tpu_torch.testing import xr_frames
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)),
                         fused_tick=True, emit_masks="none")
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    ex = Executor(cfg, params=model, frame_hw=(96, 128))
    frames = xr_frames(3, (96, 128), (32, 32))
    seen = []
    for f in frames:
        assert ex.run_inference(f) and not ex.run_inference(f)
        deadline = time.monotonic() + 60.0
        while ex.state != ExecState.COMPLETED:
            assert time.monotonic() < deadline
            if not seen or seen[-1] != ex.state:
                seen.append(ex.state)
            ex.update()
        assert ex.last_result.count == 50
    assert ExecState.REQUESTING_OUTPUTS in seen and ExecState.SUCCESS in seen
    assert tk.nms_select_batched_cuda.launches > 0


# ---------------------------------------------------------------------------
# serving: readback slots, micro-batch buckets, bf16 weight storage
# ---------------------------------------------------------------------------

def test_readback_slots_never_overwrite_frames_in_flight(card):
    """Two frames started back to back on one pipeline, each into its own
    slot of a ring, both land intact; a third start on a slot whose frame
    was not read raises."""
    from xrseg_tpu_torch.runtime.streaming import ReadbackSlots
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    pipe = build_pipeline(cfg, model, frame_hw=(96, 128), batch=1).warmup()
    numel = pipe.readback.buffer.numel()
    ring = ReadbackSlots(card, 2)
    rng = np.random.default_rng(0)
    outs, slots = [], []
    for _ in range(2):
        out = pipe(rng.integers(0, 256, (1, 96, 128, 3), np.uint8))["slate"]
        slot = ring.next(numel)
        slot.start(out)
        outs.append(out)
        slots.append(slot)
    with pytest.raises(RuntimeError, match="overwrite"):
        ring.next(numel).start(outs[0])
    assert slots[0].buffer.is_pinned() and slots[0] is not slots[1]
    for out, slot in zip(outs, slots):
        np.testing.assert_array_equal(slot.host(), out.cpu().numpy().ravel())
    assert not torch.equal(outs[0], outs[1])


def test_streaming_runner_on_the_card_equals_direct_calls(card):
    from xrseg_tpu_torch.compile import unpack_slate
    from xrseg_tpu_torch.runtime.streaming import StreamingRunner
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    pipe = build_pipeline(cfg, model, frame_hw=(96, 128), batch=2).warmup()
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, 96, 128, 3), np.uint8)
               for _ in range(6)]
    want = [[unpack_slate(r, 50) for r in pipe(x)["slate"].cpu()]
            for x in batches]
    for depth in (1, 2, 3):
        got = list(StreamingRunner(pipe, depth=depth).run(iter(batches)))
        assert [r.frame_id for r in got] == list(range(6))
        for r, w in zip(got, want):
            for j in range(2):
                for k in w[j]:
                    np.testing.assert_array_equal(r.slate[k][j], w[j][k])


def test_b8_bucket_equals_eight_b1_calls(card):
    """In float32 without TF32 (the exact-parity mode) a batch of 8 gives
    each frame the slate of its own b=1 call (boxes within 1e-3 px: cuDNN
    may sum in another order at another batch size). In the default bf16
    compute, counts and labels stay equal."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (8, 96, 128, 3), np.uint8)
    for dtype, precision in (("float32", "highest"),
                             ("bfloat16", "default")):
        cfg = ExecutorConfig(model=ModelConfig(
            input_size=(128, 128), dtype=dtype, matmul_precision=precision))
        model = detection_params(torch.Generator().manual_seed(0),
                                 cfg.model, device=card)
        b8 = build_pipeline(cfg, model, frame_hw=(96, 128), batch=8)(frames)
        b1 = build_pipeline(cfg, model, frame_hw=(96, 128), batch=1)
        for j in range(8):
            one = b1(frames[j:j + 1])
            assert torch.equal(one["count"][0], b8["count"][j])
            assert torch.equal(one["labels"][0], b8["labels"][j])
            if dtype == "float32":
                assert torch.equal(one["indices"][0], b8["indices"][j])
                torch.testing.assert_close(one["boxes_xywh"][0],
                                           b8["boxes_xywh"][j], rtol=0,
                                           atol=1e-3)


class CastCounter(TorchDispatchMode):
    """Counts the ops that turn a CUDA float32 tensor into a bfloat16 one
    (aten._to_copy, which .to(dtype) dispatches to), as they are
    dispatched: no profiler event can be lost or added."""

    def __init__(self):
        super().__init__()
        self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten._to_copy.default,
                    torch.ops.aten.to.dtype):
            src = args[0]
            dtype = kwargs.get("dtype", args[1] if len(args) > 1 else None)
            if (src.is_cuda and src.dtype == torch.float32
                    and dtype == torch.bfloat16):
                self.casts += 1
        return func(*args, **kwargs)


def test_bf16_storage_launches_no_weight_cast(card):
    """bf16 compute: f32 storage casts every weight at every call (one
    float32 -> bfloat16 copy each); bf16 storage makes none of them. The
    casts are counted as ops are dispatched (CastCounter): the other
    casts (the input, the activations) are the same in both runs, so the
    difference is exactly the number of weights."""
    from xrseg_tpu_torch.io.weights import cast_params
    from xrseg_tpu_torch.models import layers as L
    cfg = ModelConfig(input_size=(128, 128))
    f32 = detection_params(torch.Generator().manual_seed(0), cfg,
                           device=card)
    bf16 = cast_params(f32, "bfloat16")
    n_weights = sum(isinstance(m, (L.Conv, L.Proto)) for m in f32.modules())
    x = torch.rand(1, 128, 128, 3, device=card)
    casts = []
    for model in (f32, bf16):
        with torch.inference_mode():
            model(x)
            with CastCounter() as counter:
                model(x)
        casts.append(counter.casts)
    print(f"weight casts: f32 storage {casts[0]}, bf16 storage {casts[1]}, "
          f"{n_weights} weights")
    assert casts[0] - casts[1] == n_weights, (casts, n_weights)


# ---------------------------------------------------------------------------
# K5 and K6: the WBF scan (ops/wbf.py, csrc/wbf.cu)
# ---------------------------------------------------------------------------

def _wbf_stream(seed, B, K, rotated=False, n_labels=3, gate=0.3,
                empty_last=False, device="cpu"):
    """A score-sorted stream of jittered clusters (K // 8 centres) with
    bf16-tied scores and mixed labels, as ops/wbf._topk_candidates gives
    it to the scan."""
    rng = np.random.default_rng(seed)
    nc = max(K // 8, 1)
    pick = rng.integers(0, nc, (B, K))
    take = pick[..., None].repeat(2, -1)
    xy = np.take_along_axis(rng.uniform(20, 600, (B, nc, 2)), take, 1) \
        + rng.normal(0, 2, (B, K, 2))
    wh = np.take_along_axis(rng.uniform(8, 80, (B, nc, 2)), take, 1) \
        * rng.uniform(0.9, 1.1, (B, K, 2))
    boxes = np.concatenate([xy, wh], -1)
    if rotated:
        ang = np.take_along_axis(rng.uniform(-np.pi / 2, np.pi / 2, (B, nc)),
                                 pick, 1) + rng.normal(0, 0.05, (B, K))
        boxes = np.concatenate([boxes, ang[..., None]], -1)
    scores = torch.from_numpy(rng.uniform(0, 1, (B, K)).astype(
        np.float32)).bfloat16().float()
    if empty_last:
        scores[-1] = scores[-1].clamp_max(gate * 0.9)
    labels = torch.from_numpy(rng.integers(0, n_labels, (B, K)).astype(
        np.int32))
    stream = wbf._topk_candidates(torch.from_numpy(boxes.astype(np.float32)),
                                  scores, labels, 0)
    return tuple(t.to(device) for t in stream)


# (B, K, D, class_aware, labels): one label is one chain (the worst case of
# the split); 15 and 80 labels are the obb and segment heads' classes; D = 3
# at 80 labels hits the cap at the first opens (pass B reruns nearly every
# chain); D = 32, 33, 64 and 65 are the two sides of K6's and K5's
# warp/block team boundaries
WBF_CASES = [(1, 8400, 50, True, 3), (3, 2000, 50, True, 3),
             (3, 2000, 50, False, 3), (2, 2000, 1024, True, 3),
             (4, 600, 7, True, 3), (1, 1, 50, True, 3),
             (1, 4000, 50, True, 1), (1, 4000, 50, True, 15),
             (1, 4000, 50, True, 80), (3, 2000, 3, True, 80),
             (3, 2000, 1, True, 15), (2, 2000, 1024, True, 80),
             (8, 2000, 50, True, 80), (3, 2000, 32, True, 15),
             (3, 2000, 33, True, 15), (3, 2000, 64, True, 15),
             (3, 2000, 65, True, 15), (3, 2000, 50, False, 80)]


@pytest.mark.parametrize("rotated", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("B,K,D,class_aware,n_labels", WBF_CASES)
def test_wbf_scan_equals_plain(card, rotated, B, K, D, class_aware,
                               n_labels):
    """Every output of the kernels EQUAL to the plain scan's on the card:
    the clusters' sums, counts, top members, labels, the open slots and
    n_open; at 1, 3, 15 and 80 labels, with D = 1024 (a chain a full
    block), D that the clusters overflow early and late, and an image whose
    every score is below the gate; one launch counted a call."""
    if rotated and K == 8400:
        K = 21504
    stream = _wbf_stream(K + D + n_labels, B, K, rotated, n_labels,
                         empty_last=B > 1, device=card)
    kernel = wbf.wbf_rotated_scan_cuda if rotated else wbf.wbf_scan_cuda
    plain = wbf.wbf_rotated_scan_plain if rotated else wbf.wbf_scan_plain
    before = kernel.launches
    got = kernel(*stream, 0.55, 0.3, D, class_aware)
    ref = plain(*stream, 0.55, 0.3, D, class_aware)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), i
    if B > 1:
        assert int(got[-1][-1]) == 0               # all below the gate


@pytest.mark.parametrize("rotated", [False, True], ids=["K5", "K6"])
def test_wbf_scan_does_not_synchronise(card, rotated):
    """A call under torch's sync debug mode "error" raises nothing: the
    wrapper sizes its scratch on the host and issues its launches without
    reading anything back."""
    stream = _wbf_stream(7, 2, 2000, rotated, 15, device=card)
    kernel = wbf.wbf_rotated_scan_cuda if rotated else wbf.wbf_scan_cuda
    kernel(*stream, 0.55, 0.3, 50)              # built and loaded
    torch.cuda.synchronize()
    before = kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel(*stream, 0.55, 0.3, 50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernel.launches == before + 1
    ref = kernel(*stream, 0.55, 0.3, 50)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_wbf_wrapper_refuses_what_the_kernel_does_not_take(card):
    stream = _wbf_stream(0, 1, 64, device=card)
    before = wbf.wbf_scan_cuda.launches
    with pytest.raises(ValueError, match="1 to 1024 clusters"):
        wbf.wbf_scan_cuda(*stream, 0.55, 0.3, 1025)
    with pytest.raises(TypeError, match="int32"):
        wbf.wbf_scan_cuda(stream[0], stream[1], stream[2].long(), stream[3],
                          0.55, 0.3, 50)
    with pytest.raises(ValueError, match=r"boxes \[B,K,5\]"):
        wbf.wbf_rotated_scan_cuda(*stream, 0.55, 0.3, 50)
    assert wbf.wbf_scan_cuda.launches == before


@pytest.mark.parametrize("task", ["segment", "obb"])
def test_wbf_pipeline_goes_through_the_kernels(card, task):
    """merge="wbf": one K5 (K6 for obb) launch per batch, and the slate of
    the same pipeline with the plain scan (nms_backend="scan")."""
    cfg = ExecutorConfig(model=ModelConfig(task=task, num_classes=3,
                                           input_size=(128, 128)),
                         post=PostprocessConfig(merge="wbf"))
    scan = ExecutorConfig(model=cfg.model, post=PostprocessConfig(
        merge="wbf", nms_backend="scan"))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3),
                                               np.uint8)
    kernel = wbf.wbf_rotated_scan_cuda if task == "obb" else \
        wbf.wbf_scan_cuda
    before = kernel.launches
    got = build_pipeline(cfg, model, frame_hw=(96, 128), batch=2)(frames)
    assert kernel.launches == before + 1
    if task == "obb":
        # decode_task_outputs leaves the obb backend to its own "auto"
        x = preprocess(torch.from_numpy(frames).to(card), (128, 128),
                       dtype=model.dtype)
        with torch.inference_mode():
            out = model(x, concat_preds=False)
            ref = postprocess_obb_batch(out["boxes_xywhr"],
                                        out["cls_logits"], cfg.post,
                                        scores_are_logits=True,
                                        backend="scan")
        assert torch.equal(got["slate"], pack_slate(ref, 50))
    else:
        ref = build_pipeline(scan, model, frame_hw=(96, 128),
                             batch=2)(frames)
        assert torch.equal(got["slate"], ref["slate"])
        assert torch.equal(got["masks"], ref["masks"])
    assert int(got["count"].min()) > 0


@pytest.mark.parametrize("merge", ["wbf", "nms"])
def test_ensemble_goes_through_k5_or_k1(card, merge):
    from xrseg_tpu_torch.compile import build_ensemble_pipeline
    cfgs = [ModelConfig(scale=s, num_classes=3, input_size=(128, 128))
            for s in ("n", "s")]
    cfg = ExecutorConfig(model=cfgs[0], post=PostprocessConfig(merge=merge))
    scan = ExecutorConfig(model=cfgs[0], post=PostprocessConfig(
        merge=merge, nms_backend="scan"))
    models = [detection_params(torch.Generator().manual_seed(i), c,
                               device=card) for i, c in enumerate(cfgs)]
    frames = np.random.default_rng(1).integers(0, 256, (1, 96, 128, 3),
                                               np.uint8)
    kernel = wbf.wbf_scan_cuda if merge == "wbf" else \
        tk.nms_select_batched_cuda
    before = kernel.launches
    got = build_ensemble_pipeline(cfg, models, cfgs, frame_hw=(96, 128),
                                  batch=1)(frames)
    assert kernel.launches == before + 1
    ref = build_ensemble_pipeline(scan, models, cfgs, frame_hw=(96, 128),
                                  batch=1)(frames)
    for k in ("slate", "indices", "masks"):
        assert torch.equal(got[k], ref[k]), k


def test_compiled_artifact_holds_the_kernels(card, tmp_path):
    """export_compiled on the card: the program calls the custom ops, whose
    CUDA implementation is the kernel (each launch counted), and gives the
    pipeline's slate."""
    from xrseg_tpu_torch.compile import export_compiled, load_compiled
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    frames = np.random.default_rng(2).integers(0, 256, (1, 96, 128, 3),
                                               np.uint8)
    for merge, kernel in (("nms", tk.nms_select_batched_cuda),
                          ("wbf", wbf.wbf_scan_cuda)):
        c = ExecutorConfig(model=cfg.model,
                           post=PostprocessConfig(merge=merge))
        pipe = build_pipeline(c, model, frame_hw=(96, 128), batch=1)
        path = str(tmp_path / f"{merge}.xrseg")
        export_compiled(pipe, path)
        run = load_compiled(path)
        before = kernel.launches
        got = run(frames)
        assert kernel.launches == before + 1
        want = pipe(frames)
        assert torch.equal(got["slate"], want["slate"])


# ---------------------------------------------------------------------------
# dataset evaluation and the deploy check on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["segment", "obb"])
def test_dataset_eval_on_the_card_equals_scan(card, task, monkeypatch):
    """evaluate_dataset / evaluate_task_dataset through the card's
    pipeline: K1 (segment) or K3 (obb) once per batch, and every image's
    detections and the result equal to the same eval with the plain NMS."""
    from xrseg_tpu_torch.eval import dataset_eval as de
    from xrseg_tpu_torch.train import data as data_lib
    mcfg = ModelConfig(task=task, num_classes=3, input_size=(128, 128))
    model = detection_params(torch.Generator().manual_seed(0), mcfg,
                             device=card)
    calls = []
    real = de.evaluate

    def capture(per_image, *a, **k):
        calls.append(per_image)
        return real(per_image, *a, **k)
    monkeypatch.setattr(de, "evaluate", capture)
    kernel = tk.nms_rotated_batched_cuda if task == "obb" \
        else tk.nms_select_batched_cuda
    before = kernel.launches
    if task == "segment":
        ds = data_lib.SyntheticShapesDataset(n=6, hw=(96, 128))
        got = de.evaluate_dataset(mcfg, model, ds, batch=4)
        scan = ExecutorConfig(model=mcfg, post=PostprocessConfig(
            score_threshold=0.05, nms_backend="scan"))
        pipe = build_pipeline(scan, model, crop_masks=True,
                              frame_hw=(128, 128), batch=4)
    else:
        ds = data_lib.SyntheticOBBDataset(n=6, hw=(128, 128))
        got = de.evaluate_task_dataset(mcfg, model, ds, batch=4)
        auto = build_pipeline(ExecutorConfig(model=mcfg, post=PostprocessConfig(
            score_threshold=0.05)), model, frame_hw=(128, 128), batch=4)

        def pipe(frames):          # obb's decode takes its own backend
            x = preprocess(torch.from_numpy(frames).to(card), (128, 128),
                           dtype=model.dtype)
            with torch.inference_mode():
                out = model(x, concat_preds=False)
                return postprocess_obb_batch(
                    out["boxes_xywhr"], out["cls_logits"], auto.cfg.post,
                    scores_are_logits=True, backend="scan")
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = (de.evaluate_dataset(mcfg, model, ds, batch=4, pipe=pipe)
            if task == "segment" else
            de.evaluate_task_dataset(mcfg, model, ds, batch=4, pipe=pipe))
    assert got == want
    for (dg, _), (dw, _) in zip(calls[0], calls[-1], strict=True):
        assert len(dg) == len(dw) > 0
        for a, b in zip(dg, dw):
            assert (a.label, a.score) == (b.label, b.score)
            np.testing.assert_array_equal(a.box_xywh, b.box_xywh)
            for f in ("mask", "box_xywhr"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


def test_deploy_check_on_the_card(card):
    from xrseg_tpu_torch.runtime.deploy_check import check_environment
    res = check_environment(ExecutorConfig(), require_cuda=True,
                            mesh_shape=(1, 1))
    assert res.ok, res.checks
    by = {n: (p, d) for n, p, d in res.checks}
    assert by["cuda_platform"][0] and by["cuda_kernels"][0]
    assert by["devices_present"][1].startswith("1 device(s)") or \
        torch.cuda.device_count() > 1


def test_train_step_on_the_card_equals_cpu(card):
    """One float32 "highest" train step at b=2 (remat on) on the card and
    on the CPU from the same weights and batch: metrics within rtol 1e-4,
    the clipped gradient (the first moment / 0.1) within 1e-3 of each
    leaf's max abs, params and moments within rtol 1e-4, atol 1e-5 (the
    CPU tests' tolerances x10: cuDNN sums in another order)."""

    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.train import data as data_lib
    from xrseg_tpu_torch.train import train_step as ts
    cfg = ModelConfig(input_size=(96, 96), num_classes=3, dtype="float32",
                      matmul_precision="highest")
    host = yolo11.init_params(torch.Generator().manual_seed(3), cfg)
    ds = data_lib.SyntheticShapesDataset(n=2, hw=(96, 96))
    batch = next(data_lib.Loader(ds, cfg, 2, max_gt=4,
                                 device="cpu")._host_batches(0))
    opt = ts.make_optimizer(lr=1e-6, warmup_steps=0, total_steps=10)
    runs = []
    for dev in (card, "cpu"):
        model = copy.deepcopy(host).to(dev)
        state = ts.TrainState(model, opt.init(model), 0)
        state, m = ts.make_train_step(cfg, opt, device=dev)(state, batch)
        runs.append(({k: float(v) for k, v in m.items()}, state))
    (mc, sc), (mh, sh) = runs
    assert set(mc) == set(mh)
    for k in mh:
        assert mc[k] == pytest.approx(mh[k], rel=1e-4, abs=1e-7), k
    for name, mu in sh.opt_state["mu"].items():
        g_h = mu / 0.1
        g_c = sc.opt_state["mu"][name].cpu() / 0.1
        assert float((g_c - g_h).abs().max()) <= 1e-3 * max(
            float(g_h.abs().max()), 1e-30), name
    cpu_params = dict(sh.params.named_parameters())
    for name, p in sc.params.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), cpu_params[name].detach(),
                                   rtol=1e-4, atol=1e-5)
    for key in ("mu", "nu"):
        for name, t in sc.opt_state[key].items():
            torch.testing.assert_close(t.cpu(), sh.opt_state[key][name],
                                       rtol=1e-4, atol=1e-5)


def test_trainer_validation_on_the_card_equals_scan(card, monkeypatch):
    """Trainer.fit on the card validates through K1 (once per validation
    batch, at B=8), and the validation equals the same eval through the
    plain NMS, image for image."""
    from xrseg_tpu_torch.eval import dataset_eval as de
    from xrseg_tpu_torch.train import data as data_lib
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer
    mcfg = ModelConfig(num_classes=3, input_size=(128, 128))
    weights = detection_params(torch.Generator().manual_seed(0), mcfg,
                               device=card)
    ds = data_lib.SyntheticShapesDataset(n=8, hw=(96, 128))
    tr = Trainer(mcfg, TrainConfig(epochs=1, batch=4, max_gt=8,
                                   warmup_steps=1, log_every=0,
                                   val_max_images=8), params=weights,
                 device=card)
    before = tk.nms_select_batched_cuda.launches
    hist = tr.fit(ds, val_dataset=ds, verbose=False)
    torch.cuda.synchronize()
    assert tk.nms_select_batched_cuda.launches == before + 1
    assert np.isfinite(hist[-1]["loss"]) and tr.preflight_bytes > 0
    calls = []
    real = de.evaluate

    def capture(per_image, *a, **k):
        calls.append(per_image)
        return real(per_image, *a, **k)
    monkeypatch.setattr(de, "evaluate", capture)
    got = tr.evaluate(ds, max_images=8)
    scan = build_pipeline(ExecutorConfig(model=mcfg, post=PostprocessConfig(
        score_threshold=0.05, nms_backend="scan")), tr._val_model,
        crop_masks=True, frame_hw=(128, 128), batch=8)
    want = de.evaluate_dataset(mcfg, tr._val_model, ds, max_images=8,
                               batch=8, pipe=scan)
    assert got == {"val_box_mAP": want["box_mAP"],
                   "val_box_AP50": want["box_AP50"],
                   "val_mask_mAP": want["mask_mAP"]}
    for (dg, _), (dw, _) in zip(calls[0], calls[-1], strict=True):
        assert len(dg) == len(dw) > 0
        for a, b in zip(dg, dw):
            assert (a.label, a.score) == (b.label, b.score)
            np.testing.assert_array_equal(a.box_xywh, b.box_xywh)
            np.testing.assert_array_equal(a.mask, b.mask)


# ---------------------------------------------------------------------------
# the label-efficiency path (transfer, distill, pseudo-labels, active)
# ---------------------------------------------------------------------------

def _label_frames(n, hw=(96, 128), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), np.uint8) for _ in range(n)]


def test_pseudo_labels_launch_k1_once_a_frame(card):
    """generate_pseudo_samples on the card: K1 once a frame at B=1, and the
    samples equal the same run through the plain NMS."""
    from xrseg_tpu_torch.train.pseudo import generate_pseudo_samples
    mcfg = ModelConfig(num_classes=3, input_size=(128, 128))
    model = detection_params(torch.Generator().manual_seed(0), mcfg,
                             device=card)
    frames = _label_frames(4)
    before = tk.nms_select_batched_cuda.launches
    got = generate_pseudo_samples(ExecutorConfig(model=mcfg), model, frames,
                                  score_gate=0.3)
    torch.cuda.synchronize()
    assert tk.nms_select_batched_cuda.launches == before + len(frames)
    want = generate_pseudo_samples(
        ExecutorConfig(model=mcfg, post=PostprocessConfig(
            nms_backend="scan")), model, frames, score_gate=0.3)
    for g, w in zip(got, want, strict=True):
        assert len(g["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        for a, b in zip(g["polys"], w["polys"], strict=True):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_flip_ranking_launches_k1_twice_a_frame(card):
    """rank_frames(strategy="flip") on the card: K1 twice a frame (the
    frame and its negative-stride mirror), the ranking equal to the plain
    NMS's; a mirrored frame gives the slate of its contiguous copy."""
    from xrseg_tpu_torch.train.active import rank_frames
    mcfg = ModelConfig(num_classes=3, input_size=(128, 128))
    model = detection_params(torch.Generator().manual_seed(1), mcfg,
                             device=card)
    frames = _label_frames(3, seed=1)
    before = tk.nms_select_batched_cuda.launches
    got = rank_frames(ExecutorConfig(model=mcfg), model, frames,
                      strategy="flip")
    torch.cuda.synchronize()
    assert tk.nms_select_batched_cuda.launches == before + 2 * len(frames)
    want = rank_frames(ExecutorConfig(model=mcfg, post=PostprocessConfig(
        nms_backend="scan")), model, frames, strategy="flip")
    assert got == want
    pipe = build_pipeline(ExecutorConfig(model=mcfg), model,
                          frame_hw=(96, 128), batch=1)
    mirrored = frames[0][:, ::-1][None]
    assert torch.equal(pipe(mirrored)["slate"],
                       pipe(np.ascontiguousarray(mirrored))["slate"])


def test_distill_step_on_the_card_equals_cpu(card):
    """One float32 "highest" distill step at b=2 (remat on) on the card
    and on the CPU: metrics within rtol 1e-4, the clipped gradient within
    1e-3 of each leaf's max abs (the train step's card test)."""
    import dataclasses

    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.train import distill as td
    from xrseg_tpu_torch.train import train_step as ts
    cfg = ModelConfig(input_size=(96, 96), num_classes=3, dtype="float32",
                      matmul_precision="highest")
    student = yolo11.init_params(torch.Generator().manual_seed(3), cfg)
    teacher = detection_params(torch.Generator().manual_seed(4),
                               dataclasses.replace(cfg, scale="s"),
                               device="cpu")
    batch = {"images": np.random.default_rng(2).uniform(
        0, 1, (2, 96, 96, 3)).astype(np.float32)}
    opt = ts.make_optimizer(lr=1e-6, warmup_steps=0, total_steps=10)
    runs = []
    for dev in (card, "cpu"):
        model = copy.deepcopy(student).to(dev)
        state = ts.TrainState(model, opt.init(model), 0)
        step = td.make_distill_step(cfg, teacher.cfg, opt, device=dev)
        state, m = step(state, copy.deepcopy(teacher).to(dev), batch)
        runs.append(({k: float(v) for k, v in m.items()}, state))
    (mc, sc), (mh, sh) = runs
    assert set(mc) == set(mh)
    for k in mh:
        assert mc[k] == pytest.approx(mh[k], rel=1e-4, abs=1e-7), k
    for name, mu in sh.opt_state["mu"].items():
        g_h = mu / 0.1
        g_c = sc.opt_state["mu"][name].cpu() / 0.1
        assert float((g_c - g_h).abs().max()) <= 1e-3 * max(
            float(g_h.abs().max()), 1e-30), name


def test_transfer_from_a_card_donor(card):
    """transfer_params on a donor on the card returns a CPU model with the
    report of the same donor on the CPU, and the same numbers."""
    from xrseg_tpu_torch.io.weights import transfer_params
    donor = detection_params(torch.Generator().manual_seed(0),
                             ModelConfig(input_size=(128, 128)), device=card)
    new = ModelConfig(num_classes=3, input_size=(128, 128))
    got, rep = transfer_params(donor, new, torch.Generator().manual_seed(1))
    want, rep_cpu = transfer_params(donor.cpu(), new,
                                    torch.Generator().manual_seed(1))
    assert rep == rep_cpu and rep["reinit"]
    assert next(got.parameters()).device.type == "cpu"
    for a, b in zip(got.parameters(), want.parameters(), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# parallel/ on the card: a mesh over [cuda:0] * n (one card)
# ---------------------------------------------------------------------------

def test_dp_shards_equal_per_shard_pipelines(card):
    """DP over [cuda:0] * 2 at b=4: K1 once a shard, and each shard's rows
    bit-equal to build_pipeline at the shard's own batch (2)."""
    from xrseg_tpu_torch.parallel import batch as pbatch
    from xrseg_tpu_torch.parallel.mesh import make_mesh
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    frames = np.random.default_rng(0).integers(0, 256, (4, 96, 128, 3),
                                               np.uint8)
    mesh = make_mesh((2, 1), devices=[card] * 2)
    fn, sp = pbatch.build_sharded_pipeline(cfg, model, mesh, batch=4,
                                           frame_hw=(96, 128))
    fn(sp, frames)                       # warm: cuDNN picks its algorithms
    before = tk.nms_select_batched_cuda.launches
    det = fn(sp, frames)
    torch.cuda.synchronize()
    assert tk.nms_select_batched_cuda.launches == before + 2
    shard = build_pipeline(cfg, model, frame_hw=(96, 128), batch=2)
    for i in range(2):
        ref = shard(frames[2 * i:2 * i + 2])
        for k in ref:
            assert torch.equal(det[k][2 * i:2 * i + 2], ref[k]), k
    assert int(det["count"].min()) == 50


def test_pp_run_stream_equals_direct(card):
    """PP over [cuda:0, cuda:0]: run_stream over 6 frames equals the direct
    pipeline frame for frame, K1 once a frame."""
    from xrseg_tpu_torch.parallel.pipeline import PipelinedRunner
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=card)
    runner = PipelinedRunner(cfg, model, devices=[card, card],
                             frame_hw=(96, 128)).warmup()
    direct = build_pipeline(cfg, model, frame_hw=(96, 128), batch=1)
    frames = [np.random.default_rng(i).integers(0, 256, (1, 96, 128, 3),
                                                np.uint8) for i in range(6)]
    before = tk.nms_select_batched_cuda.launches
    outs = runner.run_stream(iter(frames), max_inflight=2)
    assert tk.nms_select_batched_cuda.launches == before + 6
    for f, o in zip(frames, outs, strict=True):
        assert torch.equal(o["slate"], direct(f)["slate"])


def test_mesh_of_more_cards_than_there_are_raises(card):
    """A server mesh of data*model distinct cards, one more than the
    machine has, is refused; so is PP on one device."""
    from xrseg_tpu_torch.parallel.pipeline import PipelinedRunner
    from xrseg_tpu_torch.runtime.server import InferenceServer
    n = torch.cuda.device_count()
    data = 1 << n.bit_length()                   # a power of two > n
    with pytest.raises(ValueError, match="needs"):
        InferenceServer(ExecutorConfig(), port=0,
                        mesh_shape={"data": data})
    with pytest.raises(ValueError, match=">= 2 devices"):
        PipelinedRunner(ExecutorConfig(), detection_params(
            torch.Generator().manual_seed(0), ModelConfig(), device=card),
            devices=[card])


@pytest.mark.parametrize("kind", ["dp", "tp", "fsdp"])
def test_mesh_train_step_on_the_card_equals_unsharded(card, kind):
    """The train step over a mesh that repeats the card (DP (2,1), TP (1,2)
    with tp_min_channels=64, FSDP (2,1) with fsdp_min_size=1024) against
    the unsharded step on the card, float32 "highest", 2 steps with
    sample weights unequal across the shards: loss and grad norm within
    rtol 1e-4, params within atol 2e-5, rtol 2e-4 (tests/test_train.py's
    bounds); FSDP's large leaves still split afterwards."""

    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.parallel.mesh import make_mesh
    from xrseg_tpu_torch.train import data as data_lib
    from xrseg_tpu_torch.train import train_step as ts
    cfg = ModelConfig(input_size=(96, 96), num_classes=3, dtype="float32",
                      matmul_precision="highest")
    host = yolo11.init_params(torch.Generator().manual_seed(4), cfg)
    loader = data_lib.Loader(data_lib.SyntheticShapesDataset(n=8, hw=(96, 96)),
                             cfg, 4, max_gt=4, device="cpu")
    batches = list(loader._host_batches(0))
    for b in batches:
        b["sample_weight"] = np.float32([1.0, 0.25, 2.0, 0.0])
    shape, kw = {"dp": ((2, 1), {}), "tp": ((1, 2), {"tp_min_channels": 64}),
                 "fsdp": ((2, 1), {"fsdp": True, "fsdp_min_size": 1024})}[kind]
    mesh = make_mesh(shape, devices=[card] * 2)
    opt = ts.make_optimizer(lr=1e-5, warmup_steps=0, total_steps=10)
    runs = []
    for m, args in ((None, {}), (mesh, kw)):
        model = copy.deepcopy(host).to(card)
        state = ts.TrainState(model, opt.init(model), 0)
        step = ts.make_train_step(cfg, opt, mesh=m, use_remat=False,
                                  device=card, **args)
        rows = []
        for b in batches:
            state, out = step(state, b)
            rows.append({k: float(v) for k, v in out.items()})
        runs.append((state, rows))
    (want_s, want), (got_s, got) = runs
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
    for a, b in zip(ts.full_parameters(got_s), ts.full_parameters(want_s)):
        torch.testing.assert_close(a.detach(), b.detach(), atol=2e-5,
                                   rtol=2e-4)
    if kind == "fsdp":
        split = got_s.placement.split
        assert split and all(len(sh.parts) == 2 for sh in split.values())
        assert dict(got_s.params.named_parameters())[
            next(iter(split))].numel() == 0


# ---------------------------------------------------------------------------
# the .sentis route on the card
# ---------------------------------------------------------------------------

def test_sentis_model_on_the_card_equals_plain_and_npz(card, tmp_path):
    """A model loaded from a .sentis template (detection_params weights,
    uint8 on disk) and moved to the card: its slate through K1 equals the
    plain NMS's on the same model, and the slate of the same dequantized
    weights read back from save_npz, bit for bit."""
    from xrseg_tpu_torch.io.weights import load_params_auto, save_npz
    from xrseg_tpu_torch.testing import sentis_template
    cfg = ExecutorConfig(model=ModelConfig(input_size=(128, 128)))
    scan = ExecutorConfig(model=cfg.model,
                          post=PostprocessConfig(nms_backend="scan"))
    src = detection_params(torch.Generator().manual_seed(0), cfg.model,
                           device="cpu")
    path = sentis_template(cfg.model, src, str(tmp_path / "m.sentis"))
    model, _ = load_params_auto(path, cfg.model)
    save_npz(str(tmp_path / "m.npz"), model)
    twin, _ = load_params_auto(str(tmp_path / "m.npz"), cfg.model)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3),
                                               np.uint8)
    before = tk.nms_select_batched_cuda.launches
    got = build_pipeline(cfg, model.to(card), frame_hw=(96, 128),
                         batch=2)(frames)
    torch.cuda.synchronize()
    assert tk.nms_select_batched_cuda.launches == before + 1
    ref = build_pipeline(scan, model, frame_hw=(96, 128), batch=2)(frames)
    npz = build_pipeline(cfg, twin.to(card), frame_hw=(96, 128),
                         batch=2)(frames)
    assert int(got["count"].min()) == 50
    assert torch.equal(got["slate"], ref["slate"])
    assert torch.equal(got["slate"], npz["slate"])


def test_sentis_write_from_the_card_equals_the_cpu_write(card, tmp_path):
    """write_yolo11_sentis of a model on the card writes the bytes the same
    write of its CPU copy writes."""
    from xrseg_tpu_torch.io.sentis import write_yolo11_sentis
    from xrseg_tpu_torch.testing import sentis_template
    cfg = ModelConfig(input_size=(128, 128))
    src = detection_params(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    template = sentis_template(cfg, src, str(tmp_path / "t.sentis"))
    moved = copy.deepcopy(src)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1.01)
    on_card = copy.deepcopy(moved).to(card)
    for name, m in (("card", on_card), ("cpu", moved)):
        write_yolo11_sentis(str(tmp_path / f"{name}.sentis"), m, template,
                            cfg)
    a = (tmp_path / "card.sentis").read_bytes()
    assert a == (tmp_path / "cpu.sentis").read_bytes()
    assert a != (tmp_path / "t.sentis").read_bytes()
