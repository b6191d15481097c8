"""The port's HTTP server over a device mesh (InferenceServer(mesh_shape=)
and the CLI's --mesh) on the CPU, case by case against the mesh tests of
tests/test_server.py: data=2 answers equal the single-device server's,
micro-batches coalesce over the mesh, display-resolution masks and
/reload (the new weights re-placed on the mesh) compose with it, pose
serves over it, and /healthz reports it. The mesh repeats the CPU device
(device="cpu"). Weights: tests/torch_parity.detecting_tree, float32,
64x64; the answers are held against the port's own single-device server
and build_pipeline.
"""
import concurrent.futures
import io
import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np

from xrseg_tpu import config as jconfig
from xrseg_tpu_torch import config as tconfig
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.io.weights import save_npz
from xrseg_tpu_torch.runtime.server import InferenceServer, rle_decode
from xrseg_tpu_torch.testing import limit_cpu_threads
from torch_parity import detecting_tree

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(scale="n", input_size=(64, 64), dtype="float32")
DEADLINE_S = 60.0


def _cfg(post=None, **model):
    kw = dict(MODEL, **model)
    return tconfig.ExecutorConfig(
        model=tconfig.ModelConfig(**kw), post=tconfig.PostprocessConfig(
            **(post or dict(score_threshold=0.05, max_detections=10))))


def _model(cfg, seed=7):
    kw = {f: getattr(cfg.model, f) for f in
          ("scale", "input_size", "dtype", "task", "kpt_shape")}
    return params_from_jax(detecting_tree(jconfig.ModelConfig(**kw),
                                          seed=seed), cfg.model)


def _npy(seed):
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 255, (64, 64, 3),
                                                      np.uint8))
    return buf.getvalue()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, data: bytes, path="/infer"):
    req = urllib.request.Request(_url(srv, path), data=data, method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=DEADLINE_S) as r:
        return json.loads(r.read())


def _same(a, b):
    assert a["count"] == b["count"] > 0
    for x, y in zip(a["detections"], b["detections"]):
        assert x["label"] == y["label"]
        np.testing.assert_allclose(x["box_xywh"], y["box_xywh"], atol=0.1)
        assert abs(x["score"] - y["score"]) < 1e-3


def test_mesh_server_matches_single_device():
    cfg = _cfg()
    model = _model(cfg)
    payload = _npy(4)
    single = InferenceServer(cfg, params=model, port=0, device="cpu").start()
    try:
        ref = _post(single, payload)
    finally:
        single.close()
    meshed = InferenceServer(cfg, params=model, port=0, device="cpu",
                             mesh_shape={"data": 2}).start()
    try:
        assert _get(meshed, "/healthz")["mesh"] == {"data": 2, "model": 1}
        _same(_post(meshed, payload), ref)
        assert set(meshed._pipelines) == {2}   # a request pads to data=2
    finally:
        meshed.close()


def test_mesh_server_micro_batch_concurrent():
    """Concurrent requests coalesce into the sharded batch (buckets start
    at the data axis: 2, 4) and every client gets its own answer; the
    buckets share the weights placed once on the mesh."""
    cfg = _cfg()
    srv = InferenceServer(cfg, params=_model(cfg), port=0, device="cpu",
                          mesh_shape={"data": 2}, micro_batch=4,
                          batch_window_ms=150.0).start()
    try:
        payloads = [_npy(10 + i) for i in range(8)]
        refs = [_post(srv, p) for p in payloads]
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda p: _post(srv, p), payloads))
        for o, r in zip(outs, refs):
            _same(o, r)
        hist = _get(srv, "/stats")["batch_hist"]
        assert any(int(k) > 1 for k in hist), hist
        assert set(srv._pipelines) <= {2, 4}, set(srv._pipelines)
        with srv._lock:                   # every bucket shares one placement
            srv._pipeline_for(4)
            assert all(p.params is srv.pipeline.params
                       for p in srv._pipelines.values())
    finally:
        srv.close()


def test_mesh_server_serves_masks_and_reload(tmp_path):
    """Display-resolution RLE masks over data=2 (model=2 with TP on the
    >= 64-channel convs), then /reload: the answers equal build_pipeline
    on the new weights."""
    cfg = _cfg(post=dict(score_threshold=1e-6, max_detections=5))
    srv = InferenceServer(cfg, params=_model(cfg, seed=3), port=0,
                          device="cpu", serve_masks=True, mask_res="display",
                          mesh_shape={"data": 2, "model": 2},
                          tp_min_channels=64).start()
    try:
        payload = _npy(3)
        out = _post(srv, payload)
        assert out["count"] > 0
        assert rle_decode(out["detections"][0]["mask_rle"]).shape == (64, 64)
        assert any(type(m).__name__ == "_SlicedConv"
                   for m in srv.pipeline.params[0].modules())
        new = _model(cfg, seed=99)
        path = str(tmp_path / "new.npz")
        save_npz(path, new)
        assert _post(srv, json.dumps({"path": path}).encode(),
                     "/reload")["ok"] is True
        out2 = _post(srv, payload)
        frame = np.load(io.BytesIO(payload))[None]
        ref = build_pipeline(cfg, new, batch=1, device="cpu")(frame)
        assert out2["count"] == int(ref["count"][0]) > 0
        np.testing.assert_allclose(
            [d["score"] for d in out2["detections"]],
            ref["scores"][0, :out2["count"]].numpy(), atol=1e-3)
    finally:
        srv.close()


def test_mesh_server_serves_pose():
    cfg = _cfg(post=dict(score_threshold=0.05, max_detections=5),
               task="pose", kpt_shape=(5, 3))
    srv = InferenceServer(cfg, params=_model(cfg, seed=3), port=0,
                          device="cpu", mesh_shape={"data": 2}).start()
    try:
        out = _post(srv, _npy(0))
        assert out["count"] > 0
        for d in out["detections"]:
            assert len(d["kpts"]) == 5 and len(d["kpts"][0]) == 3
    finally:
        srv.close()


def test_cli_mesh_serves_and_refuses_a_bad_spec():
    proc = subprocess.Popen(
        [sys.executable, "-m", "xrseg_tpu_torch.runtime.server",
         "--device", "cpu", "--port", "0", "--frame-hw", "64", "64",
         "--task", "classify", "--classes", "5", "--mesh", "data=2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        assert "mesh {'data': 2, 'model': 1}" in line
        url = line.split()[2]
        with urllib.request.urlopen(url + "/healthz",
                                    timeout=DEADLINE_S) as r:
            assert json.loads(r.read())["mesh"] == {"data": 2, "model": 1}
    finally:
        proc.terminate()
        proc.wait(timeout=DEADLINE_S)
    bad = subprocess.run(
        [sys.executable, "-m", "xrseg_tpu_torch.runtime.server",
         "--device", "cpu", "--mesh", "data=two"], cwd=ROOT,
        capture_output=True, text=True, timeout=DEADLINE_S)
    assert bad.returncode == 2 and "bad spec" in bad.stderr
