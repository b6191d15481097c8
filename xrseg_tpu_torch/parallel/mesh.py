"""Device mesh and sharding rules (counterpart of xrseg_tpu/parallel/mesh.py).

A `Mesh` is a 2-D array of torch devices with the axis names ("data",
"model"):

  data axis  -- batch / camera streams (DP): each data row runs its own
                slice of the batch
  model axis -- output channels of the widest convolutions (TP) for the
                wide scales

The JAX package annotates shardings and lets XLA insert the collectives.
PyTorch has no partitioner, so the port's "sharding" is a small spec (the
mesh axis and the tensor dimension it splits, or replicated) that the
parallel/ paths read to place and slice tensors themselves
(parallel/batch.py).

Torch has one CPU device and no virtual devices, while the JAX tests force
8 virtual CPU devices. So an explicit `devices` list may repeat a device:
the CPU tests build meshes over [torch.device("cpu")] * n, and a one-card
machine over [cuda:0] * n. Without `devices`, make_mesh takes every
visible CUDA device and raises when there is none.

A mesh that spans processes (parallel/multihost.global_mesh) records the
rank that owns each position in `ranks`; a single-process mesh owns all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from xrseg_tpu_torch.io.bridge import jax_dims

AXES = ("data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """devices: object array [data, model] of torch.device; ranks: int
    array of the same shape, the process that owns each position."""
    devices: np.ndarray
    axis_names: Tuple[str, str] = AXES
    ranks: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.devices.ndim} dims for axes "
                             f"{self.axis_names}")
        if self.ranks is None:
            self.ranks = np.full(self.devices.shape, process_rank(), np.int64)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """The device the gathered outputs land on: this process's first."""
        return self.devices[self.ranks == process_rank()].flat[0]

    @property
    def multiprocess(self) -> bool:
        return bool((self.ranks != self.ranks.flat[0]).any())

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` at index 0 of the other axis."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0)[:, 0])


def process_rank() -> int:
    """This process's rank (0 without torch.distributed)."""
    d = torch.distributed
    return d.get_rank() if d.is_available() and d.is_initialized() else 0


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D (data, model) mesh. Default: every visible CUDA device on the
    data axis, model unsharded. `devices` may repeat a device (module
    docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices (e.g. "
                "[torch.device('cpu')] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


def device_mesh(shape: Tuple[int, int], device="cuda") -> Mesh:
    """A (data, model) mesh for an entry point's `device` (the server's
    --mesh, the scripts' --mesh N as (N, 1)): on "cpu" the CPU repeated
    data * model times (the port's stand-in for JAX's virtual CPU
    devices), on CUDA the first data * model visible cards, and an error
    when there are fewer (a card is never repeated here)."""
    from xrseg_tpu_torch.device import resolve_device
    d, m = shape
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh((d, m), devices=[dev] * (d * m))
    have = torch.cuda.device_count()
    if d * m > have:
        raise ValueError(f"mesh {d}x{m} needs {d * m} devices, have {have}")
    return make_mesh((d, m), devices=[torch.device("cuda", i)
                                      for i in range(d * m)])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: split on tensor dimension `dim`
    over mesh axis `axis`, or replicated (axis None)."""
    axis: Optional[str] = None
    dim: Optional[int] = None


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis over the data axis."""
    return Sharding("data", 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding()


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _tp_dim(name: str, shape) -> Optional[int]:
    """The tensor-parallel rule for one parameter: JAX shards a 4-D leaf
    whose LAST dim (the output channels of [k,k,I,O]) reaches
    tp_min_channels; the port's dim holding those channels is the one the
    bridge maps to JAX's dim 3: 0 for an OIHW conv weight (a depthwise
    [C,1,k,k] included), 1 for the Proto's [in,out,2,2] up_w. None for
    anything not 4-D."""
    if len(shape) != 4:
        return None
    return jax_dims(name.rsplit(".", 1)[-1], 4).index(3)


def param_shardings(params, mesh: Mesh, tp_min_channels: int = 256
                    ) -> Dict[str, Sharding]:
    """Tensor-parallel rules for a module's parameters (or a name ->
    tensor dict), keyed by state-dict name: a 4-D weight whose output
    channels reach tp_min_channels splits them over the model axis;
    everything else replicates. Across processes everything replicates,
    as in the JAX package (TP does not span processes)."""
    out = {}
    for name, t in _named_tensors(params).items():
        d = _tp_dim(name, t.shape)
        if mesh.multiprocess or d is None or t.shape[d] < tp_min_channels:
            out[name] = Sharding()
        else:
            out[name] = Sharding("model", d)
    return out


def fsdp_param_shardings(tree, mesh: Mesh, axis: str = "data",
                         min_size: int = 65536) -> Dict[str, Sharding]:
    """FSDP / ZeRO-3-style rules for a param-shaped name -> tensor dict
    (or module): each leaf of at least min_size values shards ONE
    dimension over `axis`, the largest divisible by the axis size; small
    leaves and indivisible shapes replicate.

    Ties go to the JAX layout's LAST dim (its output channels): the port
    ranks each dim by its size, then by the JAX dim the bridge maps it to,
    so an OIHW weight ties to its dim 0, not to its last (kW). The rule
    only says where a leaf lives; train/train_step.shard_train_state
    places a train state by it."""
    n = mesh.shape[axis]
    out = {}
    for name, t in _named_tensors(tree).items():
        shape = tuple(t.shape)
        if not shape or int(np.prod(shape)) < min_size or n == 1:
            out[name] = Sharding()
            continue
        jd = jax_dims(name.rsplit(".", 1)[-1], len(shape))
        dims = sorted(range(len(shape)), key=lambda d: (shape[d], jd[d]),
                      reverse=True)
        out[name] = next((Sharding(axis, d) for d in dims
                          if shape[d] % n == 0), Sharding())
    return out


def shard_params(params, mesh: Mesh, tp_min_channels: int = 256) -> list:
    """Place a YOLO11 on the mesh with the TP rules applied: one module per
    data row (parallel/batch.place_row), rows on the same devices sharing
    one. Across processes, this process's rows only, replicated."""
    from xrseg_tpu_torch.parallel.batch import place_rows
    return place_rows(params, mesh, tp_min_channels)


def shard_batch(batch, mesh: Mesh) -> list:
    """Split a host batch (leading batch axis; an array or a dict of them,
    as the train step takes) into one shard per data row, each on its
    row's first device; across processes a row of another process is
    None. Every upload is queued before any shard computes (a pageable
    upload waits for its device's queue)."""
    d = mesh.shape["data"]
    n = len(next(iter(batch.values())) if isinstance(batch, dict)
            else batch)
    if n % d:
        raise ValueError(f"batch {n} not divisible by data axis {d}")
    rows = n // d
    from xrseg_tpu_torch.device import to_device
    rank = process_rank()

    def shard(x, i: int):
        return to_device(x[i * rows:(i + 1) * rows], mesh.first_device
                         if mesh.multiprocess else mesh.devices[i, 0])

    out = []
    for i in range(d):
        if mesh.multiprocess and rank not in mesh.ranks[i]:
            out.append(None)
        elif isinstance(batch, dict):
            out.append({k: shard(v, i) for k, v in batch.items()})
        else:
            out.append(shard(batch, i))
    return out
