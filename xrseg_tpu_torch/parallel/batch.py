"""Data- and tensor-parallel batched inference over a device mesh
(counterpart of xrseg_tpu/parallel/batch.py).

The multi-device serving path: the batch (or the camera streams) is split
over the mesh's `data` axis, and with a `model` axis wider than 1 the
widest convolutions run as slices of their output channels, one slice per
device of the row.

The JAX package compiles one program and lets XLA insert the collectives.
Here the host drives every device itself:
- `shard_batch` uploads every data shard before any shard computes, and
  no shard waits for the card, so devices overlap as JAX's
  single-controller dispatch does;
- each shard runs build_pipeline's frame program (compile.py: its
  preprocess, forward and decode, K1 on the segment/detect/pose decode,
  K3 on obb) with its row's module, on its row's first device;
- TP: a conv whose output channels reach tp_min_channels becomes a
  `_SlicedConv`, each device computing its slice (bias sliced with the
  weight; a depthwise conv takes the matching slice of its input
  channels), the slices concatenated on the row's first device (the
  train step's rows use `_TrainSlicedConv`, which slices the trained
  parameter itself in each forward);
- the outputs are gathered in batch order onto the mesh's first device.
  JAX returns a global array sharded on `data`; the port returns the
  gathered dict (one readback, as build_pipeline's).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.compile import (CompiledPipeline, bind_params,
                                     check_output_options, task_slate_length)
from xrseg_tpu_torch.config import ExecutorConfig
from xrseg_tpu_torch.device import Readback
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.parallel import mesh as mesh_lib
from xrseg_tpu_torch.parallel.mesh import Mesh
from xrseg_tpu_torch.parallel.multihost import ProcessShard


def on_device(dev: torch.device):
    """Make `dev` current for CUDA work (the kernels launch on the current
    device's stream); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _slices(n: int, parts: int) -> List[Tuple[int, int]]:
    """`parts` contiguous channel ranges of n (the first n % parts one
    longer), empty ones dropped."""
    edges = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n),
                                                            parts)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _sliced(t: torch.Tensor, dim: int, bounds, devices) -> nn.ParameterList:
    return nn.ParameterList(
        nn.Parameter(t.detach().narrow(dim, lo, hi - lo).to(dev).clone(),
                     requires_grad=False)
        for (lo, hi), dev in zip(bounds, devices))


class _SlicedConv(nn.Module):
    """A Conv whose output channels run as model-axis slices: slice j on
    devices[j], concatenated on devices[0]. A depthwise conv (groups ==
    channels) takes the same slice of its input channels."""

    def __init__(self, conv: L.Conv, devices: List[torch.device]):
        super().__init__()
        c2 = conv.weight.shape[0]
        self.depthwise = conv.groups > 1
        if self.depthwise and conv.groups != c2:
            raise ValueError(f"grouped conv ({conv.groups} groups of {c2}) "
                             "has no channel-slice form")
        self.stride, self.act, self.dtype = conv.stride, conv.act, conv.dtype
        self.bounds = _slices(c2, len(devices))
        self.devices = devices[:len(self.bounds)]
        self.w = _sliced(conv.weight, 0, self.bounds, self.devices)
        self.b = _sliced(conv.bias, 0, self.bounds, self.devices)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        outs = []
        for (lo, hi), dev, w, b in zip(self.bounds, self.devices, self.w,
                                       self.b):
            xi = x[:, lo:hi] if self.depthwise else x
            with on_device(dev):
                y = L.conv_apply(self, xi.to(dev), w, b,
                                 hi - lo if self.depthwise else 1)
            outs.append(y.to(home))
        return torch.cat(outs, 1)


class _SlicedProto(nn.Module):
    """A Proto whose transposed conv runs as model-axis slices of its
    output channels (up_w [in, out, 2, 2] split on out)."""

    def __init__(self, proto: L.Proto, devices: List[torch.device]):
        super().__init__()
        self.cv1, self.cv2, self.cv3 = proto.cv1, proto.cv2, proto.cv3
        self.dtype = proto.dtype
        self.bounds = _slices(proto.up_w.shape[1], len(devices))
        self.devices = devices[:len(self.bounds)]
        self.up_w = _sliced(proto.up_w, 1, self.bounds, self.devices)
        self.up_b = _sliced(proto.up_b, 0, self.bounds, self.devices)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        outs = []
        for dev, w, b in zip(self.devices, self.up_w, self.up_b):
            with on_device(dev):
                up = L.conv_transpose_apply(self, y.to(dev), w, b)
            outs.append(up.to(y.device))
        return self.cv3(self.cv2(torch.cat(outs, 1)))


class _TrainSlicedConv(nn.Module):
    """The training form of _SlicedConv: each slice is taken inside the
    forward from the conv's own full weight and bias (narrow, then .to
    the slice's device), so autograd routes every slice's gradient back
    to the named parameter. The conv is held, not registered: the wrapper
    owns no parameter."""

    def __init__(self, conv: L.Conv, devices: List[torch.device]):
        super().__init__()
        c2 = conv.weight.shape[0]
        self.depthwise = conv.groups > 1
        if self.depthwise and conv.groups != c2:
            raise ValueError(f"grouped conv ({conv.groups} groups of {c2}) "
                             "has no channel-slice form")
        self.__dict__["conv"] = conv
        self.bounds = _slices(c2, len(devices))
        self.devices = devices[:len(self.bounds)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, home, outs = self.conv, x.device, []
        for (lo, hi), dev in zip(self.bounds, self.devices):
            xi = x[:, lo:hi] if self.depthwise else x
            w = conv.weight.narrow(0, lo, hi - lo).to(dev)
            b = conv.bias.narrow(0, lo, hi - lo).to(dev)
            with on_device(dev):
                y = L.conv_apply(conv, xi.to(dev), w, b,
                                 hi - lo if self.depthwise else 1)
            outs.append(y.to(home))
        return torch.cat(outs, 1)


class _TrainSlicedProto(nn.Module):
    """The training form of _SlicedProto: the up-conv's slices taken in
    the forward from the held Proto's up_w and up_b."""

    def __init__(self, proto: L.Proto, devices: List[torch.device]):
        super().__init__()
        self.__dict__["proto"] = proto
        self.bounds = _slices(proto.up_w.shape[1], len(devices))
        self.devices = devices[:len(self.bounds)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.proto
        y = p.cv1(x)
        outs = []
        for (lo, hi), dev in zip(self.bounds, self.devices):
            w = p.up_w.narrow(1, lo, hi - lo).to(dev)
            b = p.up_b.narrow(0, lo, hi - lo).to(dev)
            with on_device(dev):
                up = L.conv_transpose_apply(p, y.to(dev), w, b)
            outs.append(up.to(y.device))
        return p.cv3(p.cv2(torch.cat(outs, 1)))


def place_row(model: yolo11.YOLO11, devices: List[torch.device],
              shardings: Dict[str, mesh_lib.Sharding],
              train: bool = False) -> yolo11.YOLO11:
    """A copy of `model` on devices[0] with every conv (and Proto up-conv)
    that `shardings` splits over "model" replaced by its sliced form over
    `devices`. The caller's module is untouched.

    train=True (train/train_step.shard_train_state): `model` already lies
    on devices[0] and the row is a view of it: the same parameters and
    buffers (a copy of the modules around them), with the training
    slices; with one device, `model` itself."""
    if train:
        if len(devices) == 1:
            return model
        shared = {id(t): t for t in (*model.parameters(), *model.buffers())}
        row = copy.deepcopy(model, shared)
        wraps = ((L.Conv, "weight", _TrainSlicedConv),
                 (L.Proto, "up_w", _TrainSlicedProto))
    else:
        row = copy.deepcopy(model).to(devices[0]).eval()
        if len(devices) == 1:
            return row
        wraps = ((L.Conv, "weight", _SlicedConv),
                 (L.Proto, "up_w", _SlicedProto))

    def split(name: str, leaf: str) -> bool:
        return shardings[f"{name}.{leaf}"].axis == "model"

    named = list(row.named_modules())
    for cls, leaf, wrap in wraps:
        for name, m in named:
            if isinstance(m, cls) and split(name, leaf):
                parent, _, attr = name.rpartition(".")
                setattr(row.get_submodule(parent), attr, wrap(m, devices))
    return row


def place_rows(model: yolo11.YOLO11, mesh: Mesh,
               tp_min_channels: int = 256) -> List[Optional[nn.Module]]:
    """One module per data row of `mesh` (place_row with the TP rules);
    rows on the same devices share one module. Across processes, only
    this process's rows, replicated on its device (None elsewhere)."""
    shardings = mesh_lib.param_shardings(model, mesh, tp_min_channels)
    rank = mesh_lib.process_rank()
    cache: Dict[tuple, nn.Module] = {}
    rows: List[Optional[nn.Module]] = []
    for i in range(mesh.shape["data"]):
        if mesh.multiprocess:
            mine = [d for d, r in zip(mesh.devices[i], mesh.ranks[i])
                    if r == rank]
            devs = mine[:1]
        else:
            devs = list(mesh.devices[i])
        if not devs:
            rows.append(None)
            continue
        key = tuple(str(d) for d in devs)
        if key not in cache:
            cache[key] = place_row(model, devs, shardings)
        rows.append(cache[key])
    return rows


def _gather(outs: List[Dict[str, torch.Tensor]], dev: torch.device
            ) -> Dict[str, torch.Tensor]:
    """The shards' outputs concatenated in batch order on `dev`."""
    if len(outs) == 1:
        return {k: v.to(dev) for k, v in outs[0].items()}
    return {k: torch.cat([o[k].to(dev) for o in outs], 0) for k in outs[0]}


def build_sharded_pipeline(cfg: ExecutorConfig, params: yolo11.YOLO11,
                           mesh: Mesh, *, batch: int,
                           frame_hw: Optional[Tuple[int, int]] = None,
                           resize_mode: str = "stretch",
                           tp_min_channels: int = 100000,
                           emit_masks: str = "all",
                           mask_display_hw: Optional[Tuple[int, int]] = None):
    """frames [B,H,W,3] uint8 -> detection slate, B split over `data`.

    `params` is a host YOLO11, placed here (place_rows), or the rows a
    pipeline over the same mesh already holds (ShardedPipeline.params),
    which the new one then shares: JAX's device_put of arrays already so
    placed moves nothing either.

    Returns (fn, sharded_params); fn(sharded_params, frames) takes a host
    batch (numpy or a tensor), a list of per-row shards (shard_batch), or
    this process's rows of a batch that spans processes
    (multihost.shard_host_batch, returning this process's outputs the
    same way). tp_min_channels below a model's widest conv turns on
    tensor parallelism there; the default leaves it off (DP only)."""
    yolo11.refuse_yolo12(cfg.model, "data and tensor parallelism")
    d = mesh.shape["data"]
    if batch % d:
        raise ValueError(f"batch {batch} not divisible by data axis {d}")
    check_output_options(emit_masks, mask_display_hw, "rgb")
    if isinstance(params, list):
        if len(params) != d:
            raise ValueError(f"{len(params)} placed rows for a mesh with "
                             f"data axis {d}")
        sharded = params
    else:
        sharded = place_rows(bind_params(cfg, params, None), mesh,
                             tp_min_channels)

    def run_shard(model: nn.Module, x: torch.Tensor):
        """The frame program of a data row: its module on its frames."""
        row = CompiledPipeline(cfg=cfg, params=model,
                               input_shape=tuple(x.shape), device=x.device,
                               resize_mode=resize_mode, emit_masks=emit_masks,
                               mask_display_hw=mask_display_hw)
        with on_device(x.device):
            return row.enqueue(x)

    def fn(rows: List[nn.Module], frames) -> Dict[str, Any]:
        if isinstance(frames, ProcessShard):
            mine = [i for i in range(d) if rows[i] is not None]
            parts = frames.data.chunk(len(mine))
            outs = [run_shard(rows[i], x) for i, x in zip(mine, parts)]
            return {k: dataclasses.replace(frames, data=v)
                    for k, v in _gather(outs, frames.data.device).items()}
        shards = frames if isinstance(frames, list) \
            else mesh_lib.shard_batch(frames, mesh)
        if sum(len(s) for s in shards) != batch:
            raise ValueError(f"batch of {sum(len(s) for s in shards)} "
                             f"frames for a pipeline built for {batch}")
        outs = [run_shard(m, x) for m, x in zip(rows, shards)]
        return _gather(outs, mesh.first_device)

    return fn, sharded


@dataclasses.dataclass
class ShardedPipeline:
    """CompiledPipeline-shaped adapter over a sharded pipeline: the
    multi-device serving unit (runtime/server.py --mesh). __call__ takes
    a host batch, splits it on the data axis and returns the gathered det
    dict (with the packed slate) on the mesh's first device, where
    `readback` copies it. `params` holds one module per data row;
    reshard() applies the TP and replication rules to fresh (hot-swapped)
    weights."""
    cfg: ExecutorConfig
    params: List[nn.Module]
    fn: Any
    mesh: Mesh
    input_shape: Tuple[int, ...]
    tp_min_channels: int = 100000
    readback: Optional[Readback] = None

    def __call__(self, frames) -> Dict[str, torch.Tensor]:
        return self.fn(self.params, frames)

    def warmup(self) -> "ShardedPipeline":
        """Build the kernels, run one zero batch and read its slate."""
        if any(d.type == "cuda" for d in self.mesh.devices.flat):
            _build.build_all()
        self(np.zeros(self.input_shape, np.uint8))["slate"].cpu()
        return self

    def reshard(self, host_params: yolo11.YOLO11) -> List[nn.Module]:
        return mesh_lib.shard_params(host_params, self.mesh,
                                     self.tp_min_channels)


def build_serving_pipeline(cfg: ExecutorConfig, params: yolo11.YOLO11,
                           mesh: Mesh, *, batch: int,
                           frame_hw: Optional[Tuple[int, int]] = None,
                           resize_mode: str = "stretch",
                           tp_min_channels: int = 100000,
                           emit_masks: str = "all",
                           mask_display_hw: Optional[Tuple[int, int]] = None
                           ) -> ShardedPipeline:
    """build_sharded_pipeline in the CompiledPipeline call shape, so the
    HTTP server's dispatch and bucket machinery serves a mesh unchanged."""
    fn, sparams = build_sharded_pipeline(
        cfg, params, mesh, batch=batch, frame_hw=frame_hw,
        resize_mode=resize_mode, tp_min_channels=tp_min_channels,
        emit_masks=emit_masks, mask_display_hw=mask_display_hw)
    fh, fw = frame_hw or cfg.model.input_size
    readback = None if mesh.multiprocess else Readback(
        batch * task_slate_length(cfg.model, cfg.post.max_detections),
        mesh.first_device)
    return ShardedPipeline(cfg=cfg, params=sparams, fn=fn, mesh=mesh,
                           input_shape=(batch, fh, fw, 3),
                           tp_min_channels=tp_min_channels,
                           readback=readback)


def _split_streams(frames, n: int):
    """[n * k, ...] -> [n, k, ...] (numpy or a tensor)."""
    return frames.reshape((n, -1) + tuple(frames.shape[1:]))


class MultiStreamRunner:
    """N camera streams as one sharded batch (stereo or multi-camera
    headsets): stream i is row i of the batch."""

    def __init__(self, cfg: ExecutorConfig, params: yolo11.YOLO11,
                 mesh: Mesh, n_streams: int = 2,
                 frame_hw: Optional[Tuple[int, int]] = None):
        self.n = n_streams
        self.fn, self.params = build_sharded_pipeline(
            cfg, params, mesh, batch=n_streams, frame_hw=frame_hw)
        self.mesh = mesh

    def __call__(self, frames) -> Dict[str, torch.Tensor]:
        """frames: [n_streams, H, W, 3] uint8 -> per-stream slates."""
        return self.fn(self.params, mesh_lib.shard_batch(frames, self.mesh))
