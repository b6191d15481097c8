"""The port's binding of the C++ host runtime (xrseg_tpu_torch/io/native.py,
its own library built from native/src into build/kernels/) against the
JAX package's binding of the same sources (xrseg_tpu/io/native.py), on
the same inputs: depth_fusion_native, resize2tap_native and
hsv_jitter_native EQUAL; the frame ring's push, pop, pop_latest and drop
counting; PointCloudExtractor(backend="native") against the JAX
package's native extractor (EQUAL: the same C++ on the same host mask).
"""
import numpy as np
import pytest

from xrseg_tpu.config import DepthConfig as JDepthConfig
from xrseg_tpu.io import native as jnative
from xrseg_tpu.perception import camera as jcamera
from xrseg_tpu.perception.rgbd import PointCloudExtractor as JExtractor
from xrseg_tpu_torch._build import BUILD_DIR
from xrseg_tpu_torch.config import DepthConfig
from xrseg_tpu_torch.io import native as tnative
from xrseg_tpu_torch.perception.camera import CameraIntrinsics, Pose
from xrseg_tpu_torch.perception.rgbd import PointCloudExtractor
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()


def _scene(seed=1, dh=64, dw=96):
    """tests/test_depth_fusion.py's scenario."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.0, 4.0, (dh, dw)).astype(np.float16)
    mask = rng.uniform(0, 1, (160, 160)).astype(np.float32)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    return dict(depth=depth.view(np.uint16), mask=mask,
                box=np.array([300.0, 280.0, 200.0, 260.0], np.float32),
                focal=np.array([450.0, 452.0], np.float32),
                principal=np.array([640.0, 480.0], np.float32),
                sensor=np.array([1280.0, 960.0], np.float32),
                pos=np.array([0.2, 1.5, -0.3], np.float32), quat=q)


def test_library_builds_into_build_kernels():
    path = tnative.build_native()
    assert path.parent == BUILD_DIR and path.name.startswith(
        "libxrseg_native-") and path.exists()
    assert tnative.library_path() == path
    assert tnative.load_library() is tnative.load_library()


@pytest.mark.parametrize("step", [4, 5, 8])
def test_depth_fusion_equals_jax_binding(step):
    s = _scene()
    args = (s["depth"], s["mask"], s["box"], s["pos"], s["quat"], s["focal"],
            s["principal"], s["sensor"])
    kw = dict(confidence_threshold=0.4, min_depth=0.2, max_depth=3.5,
              sampling_step=step)
    got = tnative.depth_fusion_native(*args, **kw)
    want = jnative.depth_fusion_native(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and not got[2].all()


def test_resize_and_hsv_equal_jax_binding():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    for hw in ((64, 64), (20, 31), (37, 53)):
        np.testing.assert_array_equal(tnative.resize2tap_native(img, hw),
                                      jnative.resize2tap_native(img, hw))
    for gains in ((1.0, 1.0, 1.0), (1.2, 0.7, 1.3), (0.9, 1.4, 0.6)):
        np.testing.assert_array_equal(tnative.hsv_jitter_native(img, *gains),
                                      jnative.hsv_jitter_native(img, *gains))
    with pytest.raises(ValueError, match=r"\[H,W,3\]"):
        tnative.resize2tap_native(img[..., 0], (8, 8))


def test_frame_ring_push_pop_and_drops():
    ring = tnative.FrameRing(capacity=4, slot_bytes=16)
    for i in range(3):
        ring.push(np.full(16, i, np.uint8))
    assert len(ring) == 3
    assert ring.pop((16,))[0] == 0
    latest = ring.pop_latest((16,))
    assert latest[0] == 2 and len(ring) == 0
    assert ring.pop((16,)) is None and ring.pop_latest((16,)) is None
    for i in range(10):                         # overflow drops the oldest
        ring.push(np.full(16, i, np.uint8))
    assert len(ring) == 4 and ring.dropped == 6
    assert ring.pop((16,))[0] == 6
    assert ring.pop_latest((16,))[0] == 9
    with pytest.raises(ValueError, match="larger than ring slot"):
        ring.push(np.zeros(17, np.uint8))
    with pytest.raises(ValueError, match="slot size"):
        ring.pop((17,))
    frame = np.arange(8, dtype=np.float16)
    ring.push(frame)
    np.testing.assert_array_equal(ring.pop((8,), np.float16), frame)
    ring.close()
    ring.close()
    with pytest.raises(RuntimeError, match="allocation"):
        tnative.FrameRing(capacity=1, slot_bytes=16)


def test_point_cloud_extractor_native_equals_jax():
    s = _scene(seed=3)
    intr = CameraIntrinsics(focal_length=tuple(s["focal"]),
                            principal_point=tuple(s["principal"]),
                            resolution=tuple(int(v) for v in s["sensor"]))
    jintr = jcamera.CameraIntrinsics(focal_length=tuple(s["focal"]),
                                     principal_point=tuple(s["principal"]),
                                     resolution=tuple(int(v)
                                                      for v in s["sensor"]))
    pose = Pose(position=s["pos"], rotation=s["quat"])
    jpose = jcamera.Pose(position=s["pos"], rotation=s["quat"])
    t = PointCloudExtractor(DepthConfig(max_points=200), backend="native",
                            device="cpu")
    j = JExtractor(JDepthConfig(max_points=200), backend="native")
    for mask in (s["mask"], np.zeros_like(s["mask"])):
        tc = t.extract(s["depth"], mask, s["box"], intr, pose)
        jc = j.extract(s["depth"], mask, s["box"], jintr, jpose)
        for k in ("positions", "colors", "depths"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    # the empty mask fell back to the previous cloud, as in JAX
    assert len(t.current.positions) == 200
