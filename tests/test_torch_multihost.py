"""Multi-process execution of the port (xrseg_tpu_torch/parallel/
multihost.py): two OS processes, one CPU device each, joined by
torch.distributed over gloo, run the SAME sharded pipeline over a global
(2, 1) mesh and must reproduce this process's single-process slate, then
the SAME train step over that mesh (and with grad_accum=2), whose loss
and grad norm must be within 1e-3 of this process's single-process step,
as tests/test_multihost.py does for the JAX package.

The workers (tests/torch_mh_worker.py) start with OMP_NUM_THREADS=1 and
have 120 s; both are killed when the time runs out.
"""
import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from xrseg_tpu import config as jconfig
from xrseg_tpu_torch.compile import build_pipeline
from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.io.weights import save_npz
from xrseg_tpu_torch.testing import limit_cpu_threads
from xrseg_tpu_torch.train import train_step as ts
from torch_mh_worker import train_batch
from torch_parity import detecting_tree

limit_cpu_threads()

TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_dp_matches_single_process(tmp_path):
    mcfg = ModelConfig(scale="n", input_size=(64, 64), dtype="float32")
    cfg = ExecutorConfig(model=mcfg, post=PostprocessConfig(
        pre_nms_topk=0, max_detections=10))
    model = params_from_jax(detecting_tree(jconfig.ModelConfig(
        scale="n", input_size=(64, 64), dtype="float32")), mcfg)
    frames = np.random.default_rng(0).integers(
        0, 255, (4, 64, 64, 3)).astype(np.uint8)
    ref = build_pipeline(cfg, model, batch=4, device="cpu")(frames)
    assert int(ref["count"].min()) > 0
    save_npz(str(tmp_path / "w.npz"), model)
    opt = ts.make_optimizer()
    refs = {}
    for accum, key in ((1, "train"), (2, "accum")):
        state = ts.TrainState(copy.deepcopy(model), opt.init(model), 0)
        _, m = ts.make_train_step(mcfg, opt, use_remat=False,
                                  grad_accum=accum, device="cpu")(
            state, train_batch(4))
        refs[f"{key}_loss"] = float(m["loss"])
        refs[f"{key}_grad_norm"] = float(m["grad_norm"])
    np.savez(tmp_path / "ref.npz", slate=ref["slate"].numpy(), **refs)

    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "torch_mh_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port),
         str(tmp_path / "w.npz"), str(tmp_path / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("multihost workers timed out\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-2000:]
        assert out.count("MULTIHOST_TRAIN_OK") == 2, out[-2000:]
