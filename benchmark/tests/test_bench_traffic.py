"""The frozen traffic: the same seed gives the same frames, poses,
batches and samples."""
import numpy as np

from benchmark.harness import traffic

BIG_SEED = 2 ** 31 + 12345


def test_scene_is_the_seeds():
    a = traffic.scene_frames(BIG_SEED, 4, (48, 64), (16, 16))
    b = traffic.scene_frames(BIG_SEED, 4, (48, 64), (16, 16))
    c = traffic.scene_frames(BIG_SEED + 1, 4, (48, 64), (16, 16))
    for (ra, da), (rb, db) in zip(a, b):
        assert np.array_equal(ra, rb) and np.array_equal(da, db)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    rgb, depth = a[0]
    assert rgb.dtype == np.uint8 and rgb.shape == (48, 64, 3)
    d = depth.view(np.float16).astype(np.float32)
    assert d.min() > 0.1 and d.max() < 3.0      # inside the fusion's range


def test_head_pose_orbits():
    p0, q0 = traffic.head_pose(0)
    p1, q1 = traffic.head_pose(40)
    assert np.allclose(np.linalg.norm(q1), 1.0, atol=1e-6)
    assert np.array_equal(q0, [0, 0, 0, 1]) and not np.allclose(p0, p1)


def test_sample_holds_the_last():
    ids = traffic.sample_ids(BIG_SEED, 100, 10)
    assert ids == traffic.sample_ids(BIG_SEED, 100, 10)
    assert len(ids) == 10 and ids[-1] == 99 and len(set(ids)) == 10
    assert traffic.sample_ids(3, 5, 10) == [0, 1, 2, 3, 4]


def test_batches_are_the_seeds():
    a = traffic.batch_pool(5, 2, 3, (16, 24))
    b = traffic.batch_pool(5, 2, 3, (16, 24))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (3, 16, 24, 3)
