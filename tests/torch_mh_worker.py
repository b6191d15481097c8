"""Multi-process worker of tests/test_torch_multihost.py: one of N
processes running the SAME sharded pipeline of the port over a global
mesh of one CPU device per process (gloo), as tests/mh_worker.py does for
the JAX package. It imports no JAX.

argv: process_id num_processes port weights_npz ref_npz

Rank 0 loads the weights; the other ranks start from other random weights,
so the slate matches only if replicate_params broadcast rank 0's. Each
process feeds its own rows of the global batch; the all-gathered slate
must equal the single-process reference (counts and labels equal, values
within 1e-4, the JAX worker's tolerance).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROWS = 2                        # rows of the global batch per process


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    weights, ref_path = sys.argv[4], sys.argv[5]
    from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                        PostprocessConfig)
    from xrseg_tpu_torch.io.weights import load_npz
    from xrseg_tpu_torch.models import yolo11
    from xrseg_tpu_torch.parallel import multihost as mh
    from xrseg_tpu_torch.parallel.batch import build_sharded_pipeline

    mh.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid,
                  device="cpu")
    cfg = ExecutorConfig(
        model=ModelConfig(scale="n", input_size=(64, 64), dtype="float32"),
        post=PostprocessConfig(pre_nms_topk=0, max_detections=10))
    model = (load_npz(weights, cfg.model) if pid == 0 else
             yolo11.init_params(torch.Generator().manual_seed(pid),
                                cfg.model))
    mesh = mh.global_mesh()
    assert mesh.shape == {"data": nproc, "model": 1}, mesh.shape
    gb = ROWS * nproc
    fn, params = build_sharded_pipeline(
        cfg, mh.replicate_params(model, mesh), mesh, batch=gb)
    frames = np.random.default_rng(0).integers(
        0, 255, (gb, 64, 64, 3)).astype(np.uint8)
    local = mh.shard_host_batch(frames[pid * ROWS:(pid + 1) * ROWS], mesh,
                                global_batch=gb)
    assert local.start == pid * ROWS
    det = fn(params, local)
    slate = mh.gather_to_hosts(det["slate"])
    ref = np.load(ref_path)["slate"]
    assert slate.shape == ref.shape, (slate.shape, ref.shape)
    np.testing.assert_array_equal(slate[:, -1], ref[:, -1])        # counts
    np.testing.assert_allclose(slate, ref, atol=1e-4)
    print(f"[{pid}] MULTIHOST_OK count={slate[:, -1]}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
