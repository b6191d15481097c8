"""The port's device-side re-lock (xrseg_tpu_torch/ops/relock.py) against
the JAX relock_match and the host TargetTracker on the same numpy-seeded
scenes, on the CPU. Everything is compared EXACTLY: the match is a
comparison of float32 distances computed by the same operations in the
same order, and an index."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops.relock import relock_match as j_relock
from xrseg_tpu_torch.ops.relock import relock_match as t_relock
from xrseg_tpu_torch.perception.tracking import TargetTracker, parse_boxes
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

NAMES = [f"c{i}" for i in range(6)]
MODEL = (64.0, 64.0)
SCREEN = (96.0, 64.0)                  # non-square: per-axis scales differ
SCALE = (SCREEN[0] / MODEL[1], SCREEN[1] / MODEL[0])
GATE = 30.0


def _torch_match(boxes, labels, valid, prev, scale, gate=GATE):
    m, i = t_relock(torch.from_numpy(boxes), torch.from_numpy(labels),
                    torch.from_numpy(valid),
                    torch.tensor(prev, dtype=torch.float32),
                    torch.tensor(scale, dtype=torch.float32), gate_px=gate)
    assert m.dtype == torch.bool and m.dim() == 0
    assert i.dtype == torch.int32 and i.dim() == 0
    return bool(m), int(i)


def _jax_match(boxes, labels, valid, prev, scale, gate=GATE):
    m, i = j_relock(jnp.asarray(boxes), jnp.asarray(labels),
                    jnp.asarray(valid), jnp.asarray(prev, jnp.float32),
                    jnp.asarray(scale, jnp.float32), gate_px=gate)
    return bool(m), int(i)


def _host_match(boxes, labels, count, prev_xy, prev_label):
    D = len(boxes)
    host_boxes = parse_boxes(boxes, labels, np.ones(D, np.float32), count,
                             SCREEN, NAMES, max_boxes=D, model_size=MODEL)
    prev = parse_boxes(
        np.array([[prev_xy[0], prev_xy[1], 5.0, 5.0]], np.float32),
        np.array([prev_label], np.int32), np.ones(1, np.float32), 1,
        SCREEN, NAMES, model_size=MODEL)[0]
    tr = TargetTracker(gate_px=GATE)
    tr.locked_box, tr.is_tracking = prev, True
    return tr.update(host_boxes)


def test_relock_equals_jax_and_host_tracker_on_300_scenes():
    rng = np.random.default_rng(7)
    matches = 0
    for _ in range(300):
        D = 16
        k = int(rng.integers(0, D + 1))
        boxes = rng.uniform(0, 64, (D, 4)).astype(np.float32)
        labels = rng.integers(0, 6, D).astype(np.int32)
        valid = np.zeros(D, bool)
        valid[:k] = True
        prev_xy = rng.uniform(0, 64, 2).astype(np.float32)
        prev_label = int(rng.integers(0, 6))
        prev = [prev_xy[0], prev_xy[1], prev_label, 1.0]
        got = _torch_match(boxes, labels, valid, prev, SCALE)
        assert got == _jax_match(boxes, labels, valid, prev, SCALE)
        want = _host_match(boxes, labels, k, prev_xy, prev_label)
        if want is None:
            assert not got[0]
        else:
            assert got == (True, want.index)
            matches += 1
    assert matches > 30                # the sweep exercised real matches


def test_relock_ties_take_the_first_minimum():
    boxes = np.zeros((8, 4), np.float32)
    boxes[:, 0] = [40, 20, 30, 20, 30, 10, 50, 10]   # 10 twice, at 5 and 7
    boxes[:, 1] = 10.0
    labels = np.full(8, 2, np.int32)
    valid = np.ones(8, bool)
    prev = [10.0, 10.0, 2.0, 1.0]      # distance 0 to rows 5 and 7
    assert _torch_match(boxes, labels, valid, prev, (1.0, 1.0)) == (True, 5)
    assert _jax_match(boxes, labels, valid, prev, (1.0, 1.0)) == (True, 5)
    valid[5] = False                   # the first minimum leaves
    assert _torch_match(boxes, labels, valid, prev, (1.0, 1.0)) == (True, 7)


def test_relock_gate_is_strict():
    boxes = np.array([[40.0, 10.0, 4, 4]], np.float32)
    args = (np.zeros(1, np.int32), np.ones(1, bool), [10.0, 10.0, 0.0, 1.0],
            (1.0, 1.0))
    assert _torch_match(boxes, *args, gate=30.0) == (False, 0)   # d == gate
    assert _jax_match(boxes, *args, gate=30.0) == (False, 0)
    assert _torch_match(boxes, *args, gate=30.001) == (True, 0)


@pytest.mark.parametrize("case", ["empty_slate", "prev_invalid",
                                  "nothing_locked", "other_class"])
def test_relock_never_matches(case):
    boxes = np.full((8, 4), 10.0, np.float32)
    labels = np.zeros(8, np.int32)
    valid = np.ones(8, bool)
    prev = [10.0, 10.0, 0.0, 1.0]
    if case == "empty_slate":
        valid[:] = False
    elif case == "prev_invalid":
        prev[3] = 0.0
    elif case == "nothing_locked":
        prev = [0.0, 0.0, -1.0, 0.0]   # what the executor sends unlocked
    else:
        prev[2] = 3.0
    # the argmin of an all-inf row is 0 in both packages
    assert _torch_match(boxes, labels, valid, prev, (1.0, 1.0)) == (False, 0)
    assert _jax_match(boxes, labels, valid, prev, (1.0, 1.0)) == (False, 0)


def test_relock_takes_int64_labels():
    boxes = np.full((4, 4), 10.0, np.float32)
    m, i = t_relock(torch.from_numpy(boxes), torch.tensor([1, 2, 2, 1]),
                    torch.ones(4, dtype=torch.bool),
                    torch.tensor([10.0, 10.0, 2.0, 1.0]), torch.ones(2))
    assert bool(m) and int(i) == 1
