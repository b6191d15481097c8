"""Multi-process execution: one pipeline over devices of several processes
(counterpart of xrseg_tpu/parallel/multihost.py).

Every process runs the SAME code over a global mesh with one device per
process; each feeds its own rows of the global batch and computes them on
its own device, and the results are all-gathered so that every process
holds the whole batch:

    # in every process (same code, another process_id):
    mh.initialize("host0:1234", num_processes=N, process_id=i)
    mesh = mh.global_mesh()
    fn, params = build_sharded_pipeline(cfg, mh.replicate_params(model,
                                        mesh), mesh, batch=GLOBAL_B)
    local = mh.shard_host_batch(local_frames, mesh, global_batch=GLOBAL_B)
    det = fn(params, local)                  # this process's rows
    slates = mh.gather_to_hosts(det["slate"])   # every process: all rows

JAX's `jax.distributed` becomes `torch.distributed` over tcp:// with the
gloo backend on the CPU and nccl on CUDA; XLA's cross-host collectives
become a broadcast (replicate_params) and an all-gather
(gather_to_hosts). The train step over such a mesh
(train/train_step.make_train_step(mesh=global_mesh())) all-reduces the
gradients and the loss's denominator the same way. NCCL refuses two ranks on one GPU, so a one-card
machine runs world size 1 over nccl; two processes run over gloo on the
CPU (tests/test_torch_multihost.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class ProcessShard:
    """This process's rows [start, start + len(data)) of a batch of
    `global_batch` rows that spans processes (the port's stand-in for a
    global jax.Array's addressable shards)."""
    data: torch.Tensor
    global_batch: int
    start: int


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda") -> None:
    """torch.distributed.init_process_group over tcp://coordinator_address
    (host:port): nccl when `device` is CUDA (this process takes card
    process_id % device_count), gloo on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def local_device() -> torch.device:
    """This process's device: its card under nccl, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("multihost.initialize() has not run")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """2-D (data, model) mesh over every process's device, in rank order;
    `ranks` records the process of each position."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} global devices")
    names = [None] * world
    dist.all_gather_object(names, str(local_device()))
    devs = np.empty(world, dtype=object)
    devs[:] = [torch.device(n) for n in names]
    return Mesh(devs.reshape(data, model),
                ranks=np.arange(world).reshape(data, model))


def _data_row(mesh: Mesh) -> int:
    return int(np.argwhere(mesh.ranks == dist.get_rank())[0][0])


def shard_host_batch(local_batch, mesh: Mesh, *, global_batch: int):
    """This process's rows of the global batch, on its device. Its leading
    dim must be global_batch / data (global_batch / world size when the
    model axis is 1): the rows of its data-axis position. A dict of arrays
    (a train batch) gives a dict of ProcessShard."""
    if isinstance(local_batch, dict):
        return {k: shard_host_batch(v, mesh, global_batch=global_batch)
                for k, v in local_batch.items()}
    d = mesh.shape["data"]
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {d}")
    rows = global_batch // d
    x = torch.as_tensor(np.ascontiguousarray(local_batch))
    if len(x) != rows:
        raise ValueError(f"local batch of {len(x)} rows; this process "
                         f"holds {rows} of {global_batch}")
    return ProcessShard(x.to(local_device()), global_batch,
                        _data_row(mesh) * rows)


def replicate_params(params: torch.nn.Module, mesh: Mesh
                     ) -> torch.nn.Module:
    """Every process gets rank 0's weights on its own device (a
    broadcast of each parameter and buffer). Returns the caller's module,
    moved."""
    dev = local_device()
    params = params.to(dev)
    with torch.no_grad():
        for t in list(params.parameters()) + list(params.buffers()):
            dist.broadcast(t.data, src=0)
    return params


def gather_to_hosts(x) -> np.ndarray:
    """Every process's rows of an output, all-gathered in batch order
    (rows computed twice, by processes of one data row, count once), as
    numpy on every process. A plain tensor is returned as numpy."""
    if not isinstance(x, ProcessShard):
        return x.detach().cpu().numpy()
    world = dist.get_world_size()
    parts = [torch.empty_like(x.data) for _ in range(world)]
    dist.all_gather(parts, x.data.contiguous())
    starts = [None] * world
    dist.all_gather_object(starts, x.start)
    rows = {}
    for s, p in zip(starts, parts):
        rows.setdefault(s, p)
    out = torch.cat([rows[s] for s in sorted(rows)], 0)
    if len(out) != x.global_batch:
        raise RuntimeError(f"gathered {len(out)} of {x.global_batch} rows")
    return out.cpu().numpy()
