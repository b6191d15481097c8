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

Then the train step across the processes (train_step.make_train_step
over the global mesh): each process starts from its own weights again,
shard_train_state gives every process rank 0's, each steps on its own
rows (with unequal sample weights), and the gradients and the loss's
denominator are all-reduced over gloo. Loss and grad norm must be within
1e-3 of the single-process step on the whole batch (tests/mh_worker.py's
bound), equal on every process; the same with grad_accum=2, whose
microbatches take rows from both processes.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROWS = 2                        # rows of the global batch per process


def train_batch(gb: int) -> dict:
    """The train step's global batch: seeded segment targets at 64x64 and
    sample weights that differ between the processes' rows."""
    rng = np.random.default_rng(1)
    return {
        "images": rng.uniform(0, 1, (gb, 64, 64, 3)).astype(np.float32),
        "boxes_xywh": rng.uniform(8, 56, (gb, 4, 4)).astype(np.float32),
        "labels": rng.integers(0, 80, (gb, 4)).astype(np.int32),
        "masks": (rng.uniform(0, 1, (gb, 4, 16, 16)) > 0.5
                  ).astype(np.float32),
        "sample_weight": np.linspace(0.25, 2.0, gb).astype(np.float32)}


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

    from xrseg_tpu_torch.train import train_step as ts
    opt = ts.make_optimizer()
    gbatch = train_batch(gb)
    local_b = {k: v[pid * ROWS:(pid + 1) * ROWS] for k, v in gbatch.items()}
    local = mh.shard_host_batch(local_b, mesh, global_batch=gb)
    ref = np.load(ref_path)
    for accum, key in ((1, "train"), (2, "accum")):
        # grad_accum=2: JAX's microbatches take rows of both processes
        own = (load_npz(weights, cfg.model) if pid == 0 else
               yolo11.init_params(torch.Generator().manual_seed(pid),
                                  cfg.model))
        state = ts.shard_train_state(ts.TrainState(own, opt.init(own), 0),
                                     mesh)
        step = ts.make_train_step(cfg.model, opt, mesh=mesh,
                                  use_remat=False, grad_accum=accum)
        _, metrics = step(state, local)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        assert abs(loss - float(ref[f"{key}_loss"])) < 1e-3, (key, loss)
        assert abs(gn - float(ref[f"{key}_grad_norm"])) < 1e-3, (key, gn)
        both = [None] * nproc
        torch.distributed.all_gather_object(both, (loss, gn))
        assert all(b == both[0] for b in both), both
        print(f"[{pid}] MULTIHOST_TRAIN_OK grad_accum={accum} "
              f"loss={loss:.4f} grad_norm={gn:.4f}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
