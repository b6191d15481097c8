"""The program against the benchmark's plain reference at a small size on
the CPU, both in float32: the preprocess, the raw heads, the slate and
the masks agree, so the comparison's numbers read near zero."""
import numpy as np
import pytest
import torch

from benchmark.harness import common, compare, port
from benchmark.harness.weights import make_weights
from benchmark.reference import pipeline, yolo

SMALL = {"input_size": [64, 64], "frame_hw": [48, 64], "dtype": "float32"}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfg = {**common.load_json("configs", "yolo11n-seg"), **SMALL}
    sd = make_weights(cfg, 2 ** 31 + 99, "cpu")
    model = port.build_model(cfg, sd, "cpu")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 48, 64, 3), np.uint8)
    return cfg, sd, model, frames


def test_weights_are_the_seeds():
    cfg = {**common.load_json("configs", "yolo11n-seg"), **SMALL}
    a = make_weights(cfg, 5, "cpu")
    b = make_weights(cfg, 5, "cpu")
    c = make_weights(cfg, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["b0.weight"], c["b0.weight"])


def test_preprocess_and_heads_agree(setup):
    from xrseg_tpu_torch.ops.preprocess import preprocess
    cfg, sd, model, frames = setup
    x = torch.as_tensor(frames)
    ours = pipeline.preprocess(x, cfg["input_size"])
    theirs = preprocess(x, tuple(cfg["input_size"]), dtype=torch.float32)
    assert torch.allclose(ours, theirs, atol=1e-6)
    with torch.no_grad():
        raw = yolo.forward(yolo.Ops(sd), cfg, ours)
        out = model(ours, concat_preds=False)
    for k in ("boxes_xywh", "cls_logits", "mask_coefs", "protos"):
        a, b = raw[k], out[k].float()
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(
            a.abs().max())), k


def test_slate_and_masks_agree(setup):
    from xrseg_tpu_torch.compile import build_pipeline
    cfg, sd, model, frames = setup
    pipe = build_pipeline(port.exec_config(cfg), model,
                          frame_hw=tuple(cfg["frame_hw"]), batch=2,
                          device="cpu")
    det = pipe(frames)
    refs = pipeline.run(sd, cfg, frames, "cpu")
    for i, ref in enumerate(refs):
        n = int(det["count"][i])
        # 84 anchors at 64x64: the slate is not full, and a pair at the
        # IoU threshold may keep one box more on one side
        assert n > 10 and abs(n - ref["count"]) <= 2
        res = compare.slate_numbers(ref, det["boxes_xywh"][i, :n].numpy(),
                                    det["scores"][i, :n].numpy(),
                                    det["labels"][i, :n].numpy())
        assert res["slate_miss"] == 0.0 and res["nms_miss"] == 0.0
        assert res["rank_gap"] == 0.0 and res["score_err"] < 1e-5
        assert res["box_err"] < 1e-4
        m = compare.mask_err(pipeline.masks_of(ref, res["anchor"]),
                             det["masks"][i, :n].numpy())
        assert m < 1e-4


def _ref_of_squares():
    """Nine class-0 anchors a stride apart in a row, boxes 6 strides
    wide (neighbours overlap by IoU 0.71, two apart by 0.5, three apart
    by 0.33), scores falling from the left."""
    n = 9
    boxes = np.array([[8.0 * k + 4, 4.0, 48.0, 48.0] for k in range(n)])
    scores = np.linspace(0.95, 0.75, n)
    return {"boxes": boxes, "scores": scores,
            "labels": np.zeros(n, np.int64), "strides": np.full(n, 8.0),
            "nms": (0.43, 0.3, 50)}


@pytest.mark.parametrize("kept,misses", [
    ([0, 3, 6], 0),            # what greedy NMS keeps
    ([1, 4, 7], 0),            # the scores' near-tie broken the other way
    ([0, 1, 2], 7),            # no suppression: 3 pairs; 5 to 8 left out
    ([0, 3], 3),               # cut short: 6 to 8 left out
    ([0, 4, 7], 1)],           # 3 left out, nothing covers it
    ids=["greedy", "near_tie", "no_suppression", "cut_short", "skipped"])
def test_nms_miss(kept, misses):
    ref = _ref_of_squares()
    if kept == [1, 4, 7]:
        ref["scores"][0] = ref["scores"][1] - 0.005
    kept = np.array(kept)
    got = compare.nms_numbers(ref, kept)["nms_miss"]
    assert got == misses
