"""A whole run (the harness's look for a card skipped, on the CPU at a
small size) with the timed path broken underneath reads correct=False;
the same run unbroken reads correct=True. The faults an inference cell
can have: an answer altered where it is produced (a box, the re-lock,
the target mask where the tick makes it, the point cloud; a batch's
scores or masks), the NMS run without suppression, the box branch
broken, and, in a batch, half of the rows answered from the other
half's frames. (The tick compares no score and no mask error of its
own: their readings do not separate the program from the fp8 control by
3x; the target mask is held through the point cloud the tick fuses from
it. PERF.md.)"""
import pytest
import torch

from benchmark import run as bench_run

SMALL = {"input_size": [64, 64], "frame_hw": [48, 64], "dtype": "float32"}
N_SCALE = {"scale": "n", "depth_multiple": 0.5, "width_multiple": 0.25,
           "max_channels": 1024}
SEED = 2 ** 31 + 7


# the tick cell is out of BENCHMARK.json (its end-to-end metrics did not
# hold still; PERF.md), so its runs here name the metric it would report
TICK_SPEC = {"end_to_end": [
    {"name": "tick_p95_ms", "unit": "ms",
     "workloads": ["yolo11n-seg.xr_tick"]},
    {"name": "setup_s", "unit": "s"}], "per_layer": []}


def run_cell(cell, override=SMALL):
    torch.set_num_threads(2)
    spec = TICK_SPEC if cell == "yolo11n-seg.xr_tick" else None
    return bench_run.execute(cell, SEED, 1.0, False, device="cpu",
                             t_start=0.0, cfg_override=override, spec=spec)


def _tick_fault(monkeypatch, alter):
    from xrseg_tpu_torch import compile as comp
    orig = comp.XRTickPipeline.unpack

    def unpack(self, packed):
        h = orig(self, packed)
        alter(h)
        return h

    monkeypatch.setattr(comp.XRTickPipeline, "unpack", unpack)


def test_tick_clean_is_correct():
    res = run_cell("yolo11n-seg.xr_tick")
    assert res["correct"], res["checks"]
    assert res["metrics"]["tick_p95_ms"]["value"] > 0


def _shift_box(h):
    h["boxes_xywh"][3, 0] += 5.0


def _wrong_lock(h):
    h["matched_index"] = (h["matched_index"] + 7) % max(h["count"], 1)


def _move_points(h):
    h["points_packed"][:, :3] += 0.1


@pytest.mark.parametrize("alter", [_shift_box, _wrong_lock, _move_points],
                         ids=lambda f: f.__name__)
def test_tick_fault_is_caught(monkeypatch, alter):
    _tick_fault(monkeypatch, alter)
    res = run_cell("yolo11n-seg.xr_tick")
    assert not res["correct"], res["checks"]


def _no_suppression(monkeypatch):
    """The program's NMS keeps the best candidates without suppressing
    their overlaps (a threshold no IoU reaches)."""
    from xrseg_tpu_torch.ops import nms
    orig = nms._select_and_suppress

    def select(corners, scores, alive0, iou_threshold, max_det):
        return orig(corners, scores, alive0, 2.0, max_det)

    monkeypatch.setattr(nms, "_select_and_suppress", select)


def _box_branch_broken(monkeypatch):
    """The detect head's box branch reads its features mirrored left to
    right (a layout fault), so every box moves by what the branch reads."""
    from xrseg_tpu_torch.models import yolo11
    orig = yolo11.Branch3.forward

    def forward(self, x):
        return orig(self, x.flip(-1)) if self.out.weight.shape[0] == \
            4 * 16 else orig(self, x)

    monkeypatch.setattr(yolo11.Branch3, "forward", forward)


@pytest.mark.parametrize("cell,override", [
    ("yolo11n-seg.xr_tick", SMALL),
    ("yolo11x-seg.batch32", {**SMALL, **N_SCALE})], ids=["tick", "stream"])
@pytest.mark.parametrize("fault", [_no_suppression, _box_branch_broken],
                         ids=lambda f: f.__name__)
def test_head_and_nms_faults_are_caught(monkeypatch, cell, override, fault):
    fault(monkeypatch)
    res = run_cell(cell, override)
    assert not res["correct"], res["checks"]


def test_tick_mask_dimmed_is_caught(monkeypatch):
    """The target mask halved where the fused tick makes it, before the
    point fusion reads it."""
    from xrseg_tpu_torch import compile as comp
    orig = comp.synthesize_one_mask

    def synth(*a, **k):
        return orig(*a, **k) * 0.5

    monkeypatch.setattr(comp, "synthesize_one_mask", synth)
    res = run_cell("yolo11n-seg.xr_tick")
    assert not res["correct"], res["checks"]


def _stream_fault(monkeypatch, alter_frames=None, alter_det=None):
    from xrseg_tpu_torch import compile as comp
    orig = comp.CompiledPipeline.run

    def run(self, *frames):
        if alter_frames is not None:
            frames = (alter_frames(frames[0]),) + frames[1:]
        det = orig(self, *frames)
        if alter_det is not None:
            alter_det(det)
        return det

    monkeypatch.setattr(comp.CompiledPipeline, "run", run)


def test_stream_clean_is_correct():
    res = run_cell("yolo11x-seg.batch32", {**SMALL, **N_SCALE})
    assert res["correct"], res["checks"]


def test_stream_half_batch_left_out(monkeypatch):
    def halve(x):
        h = x.shape[0] // 2
        return torch.cat([x[:h], x[:x.shape[0] - h]])
    _stream_fault(monkeypatch, alter_frames=halve)
    res = run_cell("yolo11x-seg.batch32", {**SMALL, **N_SCALE})
    assert not res["correct"], res["checks"]


def test_stream_scores_altered(monkeypatch):
    def alter(det):                    # the scores in the last row's slate
        d = det["boxes_xywh"].shape[1]
        det["slate"][-1, 4 * d:5 * d] *= 0.9
    _stream_fault(monkeypatch, alter_det=alter)
    res = run_cell("yolo11x-seg.batch32", {**SMALL, **N_SCALE})
    assert not res["correct"], res["checks"]


def test_stream_masks_altered(monkeypatch):
    def alter(det):
        det["masks"][-1] = 1.0 - det["masks"][-1]
    _stream_fault(monkeypatch, alter_det=alter)
    res = run_cell("yolo11x-seg.batch32", {**SMALL, **N_SCALE})
    assert not res["correct"], res["checks"]
