"""The network's weights, made on the device from the seed.

One `torch.rand` call draws every parameter of the plan; each leaf is a
slice of it scaled to its Kaiming-uniform bound (folded-BN convs keep a
zero bias). A random network's activations shrink layer by layer (by
1e-5 at the prototypes here), which would leave every mask at 0.5 and
the point cloud's validity to rounding; so one calibration forward of
the reference on a frame of the seed's scene rescales each conv's weight, in forward
order, to unit output RMS, as batch norm keeps a trained network's
activations. Then, as the program's own test fixture does, the detect
head's last 1x1 convs are set so that every anchor fires: its class
branch puts class `label` at `score_logit` and every other class at
exactly -8, class `label`'s weights random and scaled so that on the
calibration frame its logit departs from `score_logit` by at most
`cls_max` (scores about 0.73-0.95, below the sigmoid's flat top, where
rounding would move a score the most). Its box branch puts each side's
mass on bin `dist_bin` (logit `box_logit`, every other bin 0) and adds
random weights that move each bin's logit by at most `box_max` on the
calibration frame: a box of about 2 * dist_bin * stride pixels on its
anchor, each side a little longer or shorter by what the box branch
reads. At dist_bin 3 two neighbouring anchors of a level overlap by an
IoU of about 0.7 and anchors two apart by about 0.5, so the NMS really
suppresses (at IoU 0.43 and 0.6 alike), while the 50-box slate still
fills on every frame: the NMS sees every anchor, the path's worst case.

The state dict is float32, the program's storage type, and is handed to
both the program and the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import traffic
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import yolo


def seed63(seed: int) -> int:
    """Any whole number -> a non-negative seed below 2**63."""
    return int(seed) % (1 << 63)


def make_weights(cfg: dict, seed: int, device, *, label: int = 0,
                 score_logit: float = 2.0, dist_bin: int = 3,
                 cls_max: float = 1.0, box_logit: float = 6.0,
                 box_max: float = 1.0) -> Dict[str, torch.Tensor]:
    specs = yolo.param_specs(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed63(seed))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    pool = torch.rand(total, generator=gen, device=dev)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = pool[off:off + n].view(shape)
        off += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if name.endswith(".bias") or name.endswith(".up_b"):
            if kind == "head":
                # the fan-in is the matching weight's
                cin = sd[name[:-len("bias")] + "weight"].shape[1]
                t.mul_(2).sub_(1).mul_(math.sqrt(1.0 / cin))
            else:
                t.zero_()
        elif kind == "head":
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / shape[1]))
        elif kind == "up":
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / (shape[0] * 4)))
        else:
            t.mul_(2).sub_(1).mul_(math.sqrt(3.0 / fan_in))
        sd[name] = t
    rgb = traffic.scene_frames(seed, 1, tuple(cfg["frame_hw"]), (8, 8))[0][0]
    x = ref_pipeline.preprocess(torch.as_tensor(rgb[None]).to(dev),
                                cfg["input_size"])
    with torch.no_grad(), yolo.float32_scope():
        yolo.forward(_UnitRMS(sd), cfg, x)
    _fire_every_anchor(cfg, sd, x, gen, dev, label, score_logit, dist_bin,
                       cls_max, box_logit, box_max)
    return sd


class _UnitRMS(yolo.Ops):
    """Ops that scale each conv's weight, in place, so that its output
    (before bias and activation) has unit RMS on the input it is given."""

    def _rescale(self, w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        rms = float(y.square().mean().sqrt())
        if rms > 0:
            w.div_(rms)
            y = y / rms
        return y

    def conv(self, name, x, cout, k=1, s=1, groups=1, act=True,
             kind="conv"):
        w = self.sd[f"{name}.weight"]
        y = torch.nn.functional.conv2d(x, w, None, s, k // 2, 1, groups)
        y = self._rescale(w, y) + self.sd[f"{name}.bias"][:, None, None]
        return torch.nn.functional.silu(y) if act else y

    def conv_transpose2x(self, name, x):
        w = self.sd[f"{name}.up_w"]
        y = torch.nn.functional.conv_transpose2d(x, w, None, stride=2)
        return self._rescale(w, y) + self.sd[f"{name}.up_b"][:, None, None]


def _fire_every_anchor(cfg, sd, x, gen, dev, label, score_logit, dist_bin,
                       cls_max, box_logit, box_max) -> None:
    nc, reg_max = cfg["num_classes"], cfg["reg_max"]
    if not 0 <= label < nc or not 0 < dist_bin < reg_max:
        raise ValueError("label or dist_bin out of range")
    plan = yolo.Plan(cfg)
    n_cls = sum(sd[f"det.cv3.{i}.out.weight"].numel() for i in range(3))
    n_box = sum(sd[f"det.cv2.{i}.out.weight"].numel() for i in range(3))
    normal = torch.randn(n_cls + n_box, generator=gen, device=dev)
    with torch.no_grad(), yolo.float32_scope():
        o = yolo.Ops(sd)
        feats = yolo.backbone_neck(o, plan, x.permute(0, 3, 1, 2))
        off = 0
        for i, f in enumerate(feats):
            hidden = yolo.cls_hidden(o, f"det.cv3.{i}", f, plan.c3)
            w = sd[f"det.cv3.{i}.out.weight"]
            row = normal[off:off + hidden.shape[1]].clone()
            off += w.numel()
            z = (hidden[0] * row[:, None, None]).sum(0)
            row *= cls_max / float(z.abs().max().clamp_min(1e-12))
            # only class `label` varies, so no other class can overtake it
            w.zero_()
            w[label, :, 0, 0] = row
            b = sd[f"det.cv3.{i}.out.bias"]
            b.fill_(-8.0)
            b[label] = score_logit
        for i, f in enumerate(feats):
            name = f"det.cv2.{i}"
            hidden = o.conv(f"{name}.conv1", o.conv(f"{name}.conv0", f,
                                                    plan.c2, 3), plan.c2, 3)
            w = sd[f"{name}.out.weight"]
            rows = normal[off:off + w.numel()].view(w.shape[:2]).clone()
            off += w.numel()
            z = torch.einsum("oh,hyx->oyx", rows, hidden[0])
            rows *= box_max / z.abs().amax((1, 2)).clamp_min(1e-12)[:, None]
            w.copy_(rows.view_as(w))
            b = sd[f"{name}.out.bias"]
            b.zero_()
            b[dist_bin::reg_max] = box_logit
