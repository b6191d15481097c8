"""The port's HTTP inference server (xrseg_tpu_torch/runtime/server.py) on
the CPU (device="cpu"), with a stdlib client on an ephemeral port, and
against the JAX package's InferenceServer on the same weights.

Weights: xrseg_tpu.testing.detection_params at 64x64 in float32, carried
across by io/bridge.py, so every image detects. Compared with the JAX
server's answer to the same npy frame: count, labels and class names
equal; scores within 2e-4 and boxes within 2e-2 px (both are rounded to 4
and 2 decimals after float32 sums in another order, which can move a
value across a rounding edge by one unit).
"""
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

import xrseg_tpu.testing as jtesting
from xrseg_tpu import config as jconfig
from xrseg_tpu.io import weights as jw
from xrseg_tpu.models import yolo11 as jy
from xrseg_tpu.runtime import server as jserver
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.runtime.server import (InferenceServer, rle_decode,
                                            rle_encode)
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.viz.labels import COCO_LABELS
from torch_parity import detecting_tree

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(scale="n", input_size=(64, 64), dtype="float32")
POST = dict(score_threshold=0.05, max_detections=10)
DEADLINE_S = 60.0


def _cfg(mod=tconfig, **model):
    return mod.ExecutorConfig(model=mod.ModelConfig(**dict(MODEL, **model)),
                              post=mod.PostprocessConfig(**POST))


@pytest.fixture(scope="module")
def weights():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtesting.yolo11, "init_params",
               jax.jit(jy.init_params, static_argnums=1))
    try:
        jp = jax.device_get(jtesting.detection_params(
            jax.random.key(3), jconfig.ModelConfig(**MODEL), label=3))
    finally:
        mp.undo()
    return jp, params_from_jax(jp, tconfig.ModelConfig(**MODEL))


@pytest.fixture(scope="module")
def server(weights):
    srv = InferenceServer(_cfg(), params=weights[1], port=0,
                          device="cpu").start()
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def mb_server(weights):
    srv = InferenceServer(_cfg(), params=weights[1], port=0, micro_batch=4,
                          batch_window_ms=150.0, device="cpu").start()
    yield srv
    srv.close()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _img(seed):
    return np.random.default_rng(seed).integers(0, 255, (64, 64, 3),
                                                np.uint8)


def _post(srv, data: bytes, path="/infer"):
    req = urllib.request.Request(_url(srv, path), data=data, method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        return json.loads(r.read())


def _post_status(srv, data: bytes):
    """POST /infer; (status, headers, body json)."""
    req = urllib.request.Request(_url(srv, "/infer"), data=data,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=DEADLINE_S) as r:
        body = r.read()
    return json.loads(body) if path != "/metrics" else body.decode()


def _reload(srv, path):
    return _post(srv, json.dumps({"path": path}).encode(), "/reload")


def _boxes(out):
    return [(d["label"], d["box_xywh"]) for d in out["detections"]]


# ---------------------------------------------------------------------------

def test_healthz(server):
    h = _get(server, "/healthz")
    assert h == {"ok": True, "scale": "n", "task": "segment",
                 "frame_hw": [64, 64], "input_size": [64, 64]}


def test_infer_npy_and_png(server):
    out = _post(server, _npy(_img(0)))
    assert out["count"] == len(out["detections"]) == 10
    for d in out["detections"]:
        assert set(d) == {"label", "class_name", "score", "box_xywh"}
        assert (d["label"], d["class_name"]) == (3, "motorbike")
        assert len(d["box_xywh"]) == 4
    from PIL import Image
    buf = io.BytesIO()
    # another size: the server resizes to its frame geometry
    Image.fromarray(_img(0)).resize((48, 80)).save(buf, format="PNG")
    assert _post(server, buf.getvalue())["count"] == 10


def test_bad_payload_is_400_and_oversize_is_413(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, b"this is not an image")
    assert ei.value.code == 400 and "error" in json.loads(ei.value.read())
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, _npy(np.zeros((64, 64), np.float32)))
    assert ei.value.code == 400
    cap = server.max_request_bytes
    server.max_request_bytes = 100
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, _npy(_img(1)))
        assert ei.value.code == 413
    finally:
        server.max_request_bytes = cap


def test_stats_and_metrics(server):
    _post(server, _npy(_img(2)))
    s = _get(server, "/stats")
    assert s["requests"] >= 1 and s["shed"] == 0
    assert "infer" in s["stages"] and "decode" in s["stages"]
    m = _get(server, "/metrics")
    for name in ("xrseg_requests_total", "xrseg_errors_total",
                 "xrseg_shed_total", "xrseg_queue_depth",
                 "xrseg_uptime_seconds"):
        assert f"# TYPE {name}" in m
    assert 'xrseg_stage_latency_ms{stage="infer",quantile="p50"}' in m


def test_micro_batch_answers_equal_sequential(mb_server, server):
    imgs = [_img(10 + i) for i in range(4)]
    ref = [_post(server, _npy(im)) for im in imgs]         # b=1 server
    results = [None] * len(imgs)

    def worker(i):
        results[i] = _post(mb_server, _npy(imgs[i]))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    for a, b in zip(ref, results):
        assert _boxes(a) == _boxes(b)
        assert [d["score"] for d in a["detections"]] == \
            [d["score"] for d in b["detections"]]
    hist = _get(mb_server, "/stats")["batch_hist"]
    assert any(int(k) > 1 for k in hist), hist
    assert 'xrseg_batches_total{size=' in _get(mb_server, "/metrics")


def test_reload_from_a_jax_npz(weights, tmp_path):
    srv = InferenceServer(_cfg(), params=weights[1], port=0, micro_batch=2,
                          batch_window_ms=1.0, device="cpu").start()
    try:
        img = _npy(_img(20))
        before = _post(srv, img)
        # the same network detecting another class: label 3's bias moves
        # to label 1 in every class branch
        new = jax.tree.map(np.copy, weights[0])
        for branch in new["det"]["cv3"]:
            b = branch["out"]["b"]
            b[1], b[3] = b[3], b[1]
        path = str(tmp_path / "new.npz")
        jw.save_npz(path, new)
        out = _reload(srv, path)
        assert out["ok"] and out["n_params"] == jy.count_params(new)
        after = _post(srv, img)
        assert _boxes(after) != _boxes(before)
        fresh = InferenceServer(_cfg(), params=params_from_jax(
            new, tconfig.ModelConfig(**MODEL)), port=0, device="cpu")
        try:
            assert _boxes(after) == _boxes(fresh._format(
                fresh._run(fresh.pipeline, np.load(io.BytesIO(img))[None],
                           1)[0], 0.0))
        finally:
            fresh.close()
        # every bucket swapped: the b=2 bucket serves the new weights too
        assert all(p.params is srv.pipeline.params
                   for p in srv._pipelines.values())
        # mismatched weights and unported formats are refused with 400
        wrong = str(tmp_path / "wrong.npz")
        shapes = jax.eval_shape(lambda k: jy.init_params(
            k, jconfig.ModelConfig(**dict(MODEL, num_classes=3))),
            jax.random.key(0))
        jw.save_npz(wrong, jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), shapes))
        for bad, msg in ((wrong, "do not match"),
                         (str(tmp_path / "w.sentis"), "No such file"),
                         ("", "path")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _reload(srv, bad)
            assert ei.value.code == 400
            assert msg in json.loads(ei.value.read())["error"]
        assert _boxes(_post(srv, img)) == _boxes(after)
    finally:
        srv.close()


def test_reload_takes_pt_and_onnx(weights, tmp_path):
    """/reload reads .pt (an ultralytics fused-form state dict) and .onnx
    (the JAX package's export) through load_params_auto: the answers are
    those of a fresh server on the same weights."""
    from xrseg_tpu.io.onnx_export import export_onnx
    from test_pt_loader import make_state_dict
    import torch
    new = jax.tree.map(np.copy, weights[0])
    for branch in new["det"]["cv3"]:
        b = branch["out"]["b"]
        b[1], b[3] = b[3], b[1]
    jcfg = jconfig.ModelConfig(**MODEL)
    pt, onnx = str(tmp_path / "new.pt"), str(tmp_path / "new.onnx")
    torch.save(make_state_dict(new, jcfg, None, fused=True), pt)
    export_onnx(new, jcfg, onnx)
    srv = InferenceServer(_cfg(), params=weights[1], port=0, device="cpu")
    fresh = InferenceServer(_cfg(), params=params_from_jax(
        new, tconfig.ModelConfig(**MODEL)), port=0, device="cpu")
    try:
        srv.start()
        img = _npy(_img(21))
        want = _boxes(fresh._format(fresh._run(
            fresh.pipeline, np.load(io.BytesIO(img))[None], 1)[0], 0.0))
        assert _boxes(_post(srv, img)) != want
        for path in (pt, onnx):
            assert _reload(srv, path)["ok"]
            assert _boxes(_post(srv, img)) == want
    finally:
        srv.close()
        fresh.close()


def test_reload_takes_sentis(weights, tmp_path):
    """/reload reads a .sentis file (a synthetic template of new weights)
    through load_params_auto: the answers are those of a fresh server on
    the model load_params_auto gives for that file."""
    from xrseg_tpu_torch.io.weights import load_params_auto
    from xrseg_tpu_torch.testing import sentis_template
    new = jax.tree.map(np.copy, weights[0])
    for branch in new["det"]["cv3"]:
        b = branch["out"]["b"]
        b[1], b[3] = b[3], b[1]
    mcfg = tconfig.ModelConfig(**MODEL)
    path = sentis_template(mcfg, new, str(tmp_path / "new.sentis"))
    srv = InferenceServer(_cfg(), params=weights[1], port=0, device="cpu")
    fresh = InferenceServer(_cfg(), params=load_params_auto(path, mcfg)[0],
                            port=0, device="cpu")
    try:
        srv.start()
        img = _npy(_img(22))
        want = _boxes(fresh._format(fresh._run(
            fresh.pipeline, np.load(io.BytesIO(img))[None], 1)[0], 0.0))
        assert _boxes(_post(srv, img)) != want
        out = _reload(srv, path)
        assert out["ok"] and out["n_params"] == jy.count_params(new)
        assert _boxes(_post(srv, img)) == want
    finally:
        srv.close()
        fresh.close()


def test_overload_sheds_503_and_recovers(weights):
    """Micro-batch path: with the device lock held, the dispatcher stalls,
    the queue (cap 2) fills and the rest get 503 + Retry-After at once;
    after the stall the queued requests complete and the server serves."""
    srv = InferenceServer(_cfg(), params=weights[1], port=0, micro_batch=2,
                          batch_window_ms=30.0, max_pending=2,
                          device="cpu").start()
    try:
        img = _npy(_img(0))
        assert _post_status(srv, img)[0] == 200
        n = 8
        results = [None] * n

        def worker(i):
            results[i] = _post_status(srv, img)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        with srv._lock:
            for t in threads:
                t.start()
            deadline = time.monotonic() + DEADLINE_S
            while sum(r is not None and r[0] == 503
                      for r in results) < n - 4:
                assert time.monotonic() < deadline, results
                time.sleep(0.02)
            for st, hdr, body in (r for r in results if r is not None):
                assert st == 503 and hdr.get("Retry-After") == "1"
                assert "error" in body
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
        codes = [r[0] for r in results]
        assert codes.count(200) >= 2 and codes.count(503) >= n - 4, codes
        assert set(codes) == {200, 503}
        assert _post_status(srv, img)[0] == 200          # recovered
        s = _get(srv, "/stats")
        assert s["shed"] == codes.count(503) and s["queue_depth"] == 0
    finally:
        srv.close()


def test_overload_sheds_unbatched_path(weights):
    """micro_batch=1: with the device held, the dispatch thread holds one
    request and the queue (cap 1) one more; the rest get 503 at once."""
    srv = InferenceServer(_cfg(), params=weights[1], port=0, max_pending=1,
                          device="cpu").start()
    try:
        img = _npy(_img(0))
        n = 5
        results = [None] * n

        def worker(i):
            results[i] = _post_status(srv, img)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        with srv._lock:
            for t in threads:
                t.start()
            deadline = time.monotonic() + DEADLINE_S
            while sum(r is not None and r[0] == 503
                      for r in results) < n - 2:
                assert time.monotonic() < deadline, results
                time.sleep(0.02)
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert sorted(r[0] for r in results) == [200] * 2 + [503] * (n - 2)
        assert _post_status(srv, img)[0] == 200
        s = _get(srv, "/stats")
        assert s["shed"] == n - 2 and s["queue_depth"] == 0
    finally:
        srv.close()


def test_mesh_and_unported_tasks_refused(weights):
    """The mesh serves now (tests/test_torch_server_mesh.py); what it
    still refuses, as the JAX server does, is a data axis that is not a
    power of two. Pose and classify, refused until the task family was
    ported, serve."""
    for bad in ({"data": 3}, {"data": 0}):
        with pytest.raises(ValueError, match="power of two"):
            InferenceServer(_cfg(), params=weights[1], port=0,
                            mesh_shape=bad, device="cpu")
    for task in ("pose", "classify"):
        srv = InferenceServer(_cfg(task=task), port=0, device="cpu").start()
        try:
            out = _post(srv, _npy(_img(40)))
            assert _get(srv, "/healthz")["task"] == task
        finally:
            srv.close()
        if task == "pose":
            assert all(len(d["kpts"]) == 17 for d in out["detections"])
        else:
            assert len(out["probs"]) == 80
            assert out["class_name"] == COCO_LABELS[out["label"]]


@pytest.mark.parametrize("task", ["pose", "classify"])
def test_task_answers_equal_the_jax_server(task):
    """Pose and classify answers against the JAX server's on the same
    weights and frames (frame_hw 48x80, so the keypoints are scaled by
    the stretch's two factors), from a micro-batch-4 server under four
    concurrent clients: the keypoints of a batch come back in one copy.
    Pose: count, labels equal, scores 2e-4, boxes and keypoint xy 2e-2
    px, visibility 2e-3 (rounded to 4, 2 and 3 decimals). Classify: the
    label and class name equal, every prob within 2e-5 (5 decimals)."""
    tree = detecting_tree(jconfig.ModelConfig(**dict(MODEL, task=task)),
                          label=3)
    jsrv = jserver.InferenceServer(_cfg(jconfig, task=task), params=tree,
                                   frame_hw=(48, 80), port=0).start()
    tsrv = InferenceServer(_cfg(task=task),
                           params=params_from_jax(
                               tree, tconfig.ModelConfig(
                                   **dict(MODEL, task=task))),
                           frame_hw=(48, 80), port=0, micro_batch=4,
                           batch_window_ms=150.0, device="cpu").start()
    try:
        imgs = [_npy(np.random.default_rng(50 + i).integers(
            0, 255, (48, 80, 3), np.uint8)) for i in range(4)]
        want = [_post(jsrv, im) for im in imgs]
        got = [None] * len(imgs)

        def worker(i):
            got[i] = _post(tsrv, imgs[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
        assert any(int(k) > 1 for k in _get(tsrv, "/stats")["batch_hist"])
        for t, j in zip(got, want):
            assert set(t) == set(j)
            if task == "classify":
                assert (t["label"], t["class_name"]) == (j["label"],
                                                         j["class_name"])
                np.testing.assert_allclose(t["probs"], j["probs"],
                                           atol=2e-5, rtol=0)
                continue
            assert t["count"] == j["count"] == 10
            for a, b in zip(t["detections"], j["detections"]):
                assert set(a) == set(b)
                assert (a["label"], a["class_name"]) == (b["label"],
                                                         b["class_name"])
                assert abs(a["score"] - b["score"]) <= 2e-4
                np.testing.assert_allclose(a["box_xywh"], b["box_xywh"],
                                           atol=2e-2, rtol=0)
                ka, kb = np.asarray(a["kpts"]), np.asarray(b["kpts"])
                np.testing.assert_allclose(ka[:, :2], kb[:, :2], atol=2e-2,
                                           rtol=0)
                np.testing.assert_allclose(ka[:, 2], kb[:, 2], atol=2e-3,
                                           rtol=0)
    finally:
        jsrv.close()
        tsrv.close()


def test_rle_matches_jax():
    rng = np.random.default_rng(3)
    for shape, p in (((16, 16), 0.5), ((7, 9), 0.9), ((5, 4), 0.0),
                     ((3, 3), 1.0)):
        m = rng.uniform(0, 1, shape) < p
        assert rle_encode(m) == jserver.rle_encode(m)
        np.testing.assert_array_equal(rle_decode(rle_encode(m)), m)


def test_serves_display_res_masks(weights):
    srv = InferenceServer(_cfg(), params=weights[1], frame_hw=(48, 80),
                          port=0, serve_masks=True, mask_res="display",
                          device="cpu").start()
    try:
        frame = np.random.default_rng(5).integers(0, 255, (48, 80, 3),
                                                  np.uint8)
        out = _post(srv, _npy(frame))
        assert out["count"] == 10
        pipe = build_pipeline(_cfg(), weights[1], frame_hw=(48, 80),
                              mask_display_hw=(48, 80), device="cpu")
        want = pipe(frame[None])["masks"][0].numpy() > 0.5
        for i, d in enumerate(out["detections"]):
            assert d["mask_rle"]["size"] == [48, 80]
            np.testing.assert_array_equal(rle_decode(d["mask_rle"]), want[i])
    finally:
        srv.close()


def test_answer_equals_the_jax_server(weights):
    jsrv = jserver.InferenceServer(_cfg(jconfig), params=weights[0],
                                   port=0).start()
    tsrv = InferenceServer(_cfg(), params=weights[1], port=0,
                           device="cpu").start()
    try:
        img = _npy(_img(30))
        j, t = _post(jsrv, img), _post(tsrv, img)
        assert t["count"] == j["count"] == 10
        for a, b in zip(t["detections"], j["detections"]):
            assert (a["label"], a["class_name"]) == (b["label"],
                                                     b["class_name"])
            assert abs(a["score"] - b["score"]) <= 2e-4
            np.testing.assert_allclose(a["box_xywh"], b["box_xywh"],
                                       atol=2e-2, rtol=0)
    finally:
        jsrv.close()
        tsrv.close()


def test_cli_arch_flag_serves_yolov8_classify():
    """--arch yolov8 --task classify: the CLI builds v8-cls (no SPPF) and
    answers with a prob row."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "xrseg_tpu_torch.runtime.server",
         "--device", "cpu", "--port", "0", "--frame-hw", "64", "64",
         "--arch", "yolov8", "--task", "classify", "--classes", "10"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split()[2]
        with urllib.request.urlopen(url + "/healthz",
                                    timeout=DEADLINE_S) as r:
            assert json.loads(r.read())["task"] == "classify"
        req = urllib.request.Request(url + "/infer", data=_npy(_img(41)),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
            out = json.loads(r.read())
        assert len(out["probs"]) == 10 and 0 <= out["label"] < 10
        assert abs(sum(out["probs"]) - 1.0) < 1e-3
    finally:
        proc.terminate()
        proc.wait(timeout=DEADLINE_S)


def test_cli_serves_healthz_on_the_cpu():
    proc = subprocess.Popen(
        [sys.executable, "-m", "xrseg_tpu_torch.runtime.server",
         "--device", "cpu", "--port", "0", "--frame-hw", "64", "64"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split()[2]
        with urllib.request.urlopen(url + "/healthz",
                                    timeout=DEADLINE_S) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["frame_hw"] == [64, 64]
        assert h["input_size"] == [640, 640]
    finally:
        proc.terminate()
        proc.wait(timeout=DEADLINE_S)
