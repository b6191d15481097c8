"""Spatial partitioning (SP): the image's rows split across devices
(counterpart of xrseg_tpu/parallel/spatial.py).

For latency-critical batch-1 frames the spatial axis is the only one wide
enough to spread over devices. JAX shards the activations on H and XLA's
partitioner inserts the halo exchanges and all-gathers. PyTorch has no
partitioner, so this module writes them, and the model's own forward
stays the only one:

- an activation is a list of row bands, band b on the b-th device of the
  mesh axis; every level splits into the same fractions of its height
  (H divides into n shards of a multiple of 32 rows, so every stride
  level splits evenly);
- each top-level block (b0..b10, the neck's h13..h22, each head branch
  and the Proto) runs its own forward on its band widened by the block's
  receptive-field radius R: the sum of k//2 over its k x k convs and
  pools (an upper bound when the block branches), rounded up to the
  block's stride. The extra rows are copied from the neighbouring bands
  (device to device, from as many bands as R needs) and cropped from the
  block's output; at the image's own top and bottom the band is not
  widened, so the block pads there as the unsplit forward does;
- nearest upsampling and the neck's channel concatenations act band by
  band;
- the ops that mix every row gather the bands onto the first device:
  C2PSA (b10: attention over all H*W positions, then split again), each
  head branch's output before the flatten to [B, A, .], and the classify
  head.

Parameters are replicated: one copy per distinct device on the axis. The
result equals the unsplit pipeline within float rounding (the convolutions
see other shapes, so cuDNN may pick other algorithms).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from xrseg_tpu_torch.compile import CompiledPipeline, bind_params
from xrseg_tpu_torch.config import ExecutorConfig
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.parallel.batch import on_device
from xrseg_tpu_torch.parallel.mesh import Mesh

Bands = List[torch.Tensor]


def _starts(bands: Bands) -> List[int]:
    out = [0]
    for t in bands:
        out.append(out[-1] + t.shape[2])
    return out


def _extend(bands: Bands, b: int, top: int, bottom: int) -> torch.Tensor:
    """Band b with the `top` rows above it and the `bottom` rows below it
    (inside the image) copied from the other bands to band b's device."""
    starts = _starts(bands)
    lo, hi = starts[b] - top, starts[b + 1] + bottom
    dev = bands[b].device
    return torch.cat([t[:, :, max(lo, a) - a:min(hi, z) - a].to(dev)
                      for t, a, z in zip(bands, starts, starts[1:])
                      if max(lo, a) < min(hi, z)], 2)


def _radius(block: nn.Module) -> Tuple[int, int]:
    """(R, stride): the block's receptive-field radius in its input rows
    and its stride. A block is either one conv, of any stride, or a
    stride-1 composition (an upsampling inside it only shrinks R)."""
    if isinstance(block, L.Conv):
        return block.weight.shape[-1] // 2, block.stride
    convs = [m for m in block.modules() if isinstance(m, L.Conv)]
    if any(m.stride != 1 for m in convs):
        raise TypeError(f"no row-band form for {type(block).__name__}: a "
                        "strided conv inside a composite block")
    r = sum(m.weight.shape[-1] // 2 for m in convs)
    if isinstance(block, L.SPPF):
        r += 3 * (block.k // 2)
    return r, 1


def run(mods: List[nn.Module], bands: Bands) -> Bands:
    """One top-level block on row bands: mods[b] is the block in the
    replica on band b's device. Each band runs the block's own forward on
    itself widened by the block's radius, then drops the widened rows."""
    m = mods[0]
    if isinstance(m, L.C2PSA):
        # attention mixes every position: gather, run whole, split
        whole = m(_gather(bands))
        return [p.to(t.device) for p, t in zip(
            torch.split(whole, [t.shape[2] for t in bands], 2), bands)]
    r, s = _radius(m)
    w = -(-r // s) * s                    # widening, a multiple of stride
    starts = _starts(bands)
    out = []
    for b, mm in enumerate(mods):
        top, bottom = min(w, starts[b]), min(w, starts[-1] - starts[b + 1])
        x = _extend(bands, b, top, bottom)
        y = mm(x)
        # output rows per input row: 1/stride, or 2 past the Proto's
        # upsampling (top and bottom are multiples of the stride)
        lo = top * y.shape[2] // x.shape[2]
        hi = y.shape[2] - bottom * y.shape[2] // x.shape[2]
        out.append(y[:, :, lo:hi])
    return out


def _block(mods, name: str, bands: Bands) -> Bands:
    return run([getattr(m, name) for m in mods], bands)


def _seq(mods, names, bands: Bands) -> Bands:
    for n in names:
        bands = _block(mods, n, bands)
    return bands


def _gather(bands: Bands) -> torch.Tensor:
    dev = bands[0].device
    return torch.cat([x.to(dev) for x in bands], 2)


def _cat(*groups: Bands) -> Bands:
    return [torch.cat(parts, 1) for parts in zip(*groups)]


def _up(bands: Bands) -> Bands:
    return [L.upsample2x_nearest(t) for t in bands]


def _backbone(mods, bands: Bands):
    """YOLO11.backbone on row bands -> (x4, x6, x10) bands."""
    x = _seq(mods, ("b0", "b1", "b2"), bands)
    x4 = _seq(mods, ("b3", "b4"), x)
    x6 = _seq(mods, ("b5", "b6"), x4)
    x = _seq(mods, ("b7", "b8") + tuple(n for n in ("b9", "b10")
                                         if hasattr(mods[0], n)), x6)
    return x4, x6, x


def _neck(mods, x4: Bands, x6: Bands, x10: Bands):
    """YOLO11.neck on row bands -> (P3, P4, P5) bands."""
    x13 = _block(mods, "h13", _cat(_up(x10), x6))
    x16 = _block(mods, "h16", _cat(_up(x13), x4))
    x19 = _block(mods, "h19", _cat(_block(mods, "h17", x16), x13))
    x22 = _block(mods, "h22", _cat(_block(mods, "h20", x19), x10))
    return x16, x19, x22


class _BandedPipeline(CompiledPipeline):
    """The frame program with the network on row bands: `params` is the
    list of replicas, one per device of the axis (the first holds the
    frames, the gathered maps and the decode)."""

    def forward(self, x: torch.Tensor):
        reps, lead = self.params, self.params[0]
        names = {id(m): name for name, m in lead.named_modules()}

        def apply(module, bands: Bands) -> torch.Tensor:
            name = names[id(module)]
            return _gather(run([r.get_submodule(name) for r in reps],
                               bands))

        x = lead.to_input(x)
        rows = x.shape[2] // len(reps)
        bands = [x[:, :, b * rows:(b + 1) * rows].to(
            next(r.parameters()).device) for b, r in enumerate(reps)]
        x4, x6, x10 = _backbone(reps, bands)
        if self.cfg.model.task == "classify":
            return lead.cls_head(_gather(x10))
        return lead.head_outputs(_neck(reps, x4, x6, x10),
                                 concat_preds=False, apply=apply)


def build_spatial_pipeline(cfg: ExecutorConfig, params: yolo11.YOLO11,
                           mesh: Mesh, *, axis: str = "data", batch: int = 1,
                           frame_hw: Optional[Tuple[int, int]] = None,
                           resize_mode: str = "stretch"):
    """frames [B,H,W,3] uint8 -> the detection dict, with the network's
    rows split over the devices of mesh axis `axis`.

    Returns (fn, replicated_params); fn(replicated_params, frames). The
    frames are preprocessed on the first device, then split into bands;
    the decode (K1, or K3 for obb) runs on the first device."""
    mcfg = cfg.model
    yolo11.refuse_yolo12(mcfg, "spatial parallelism")
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if mcfg.input_size[0] % (n * 32):
        raise ValueError(
            f"input H {mcfg.input_size[0]} must divide into {n} "
            "shards of multiple-of-32 rows")
    params = bind_params(cfg, params, None)
    copies: Dict[str, yolo11.YOLO11] = {}
    for d in devs:
        if str(d) not in copies:
            copies[str(d)] = copy.deepcopy(params).to(d).eval()
    replicas = [copies[str(d)] for d in devs]
    shape = (batch, *(frame_hw or mcfg.input_size), 3)

    def fn(reps: List[yolo11.YOLO11], frames) -> Dict[str, torch.Tensor]:
        pipe = _BandedPipeline(cfg=cfg, params=reps, input_shape=shape,
                               device=devs[0], resize_mode=resize_mode)
        with on_device(devs[0]):
            return pipe.enqueue(pipe.upload(frames))

    return fn, replicas
