"""Deterministic fixture weights that are guaranteed to detect.

The port's counterpart of xrseg_tpu/testing.py: random-init weights fire
detections only by seed luck, so `detection_params` patches the detect
head's final 1x1 convs so that EVERY anchor emits a confident box:

- cls out-conv bias: class `label` at `score_logit`, every other class at
  -8; its weights are random, scaled so the per-anchor logit spread is
  ~cls_spread (one calibration forward measures the penultimate
  activation RMS, since random-init activations decay by the head).
- box (DFL) out-conv bias: each side's mass on bin `dist_bin`, so each
  anchor decodes to a (2*dist_bin*stride)-px square centred on itself,
  small enough that neighbouring boxes stay under NMS IoU gates and the
  slate fills to max_det.

The rest of the network keeps its random init. The numbers come from the
port's own generator and differ from the JAX package's.

`sentis_template` writes a small `.sentis` file of a model's weights, the
container io/sentis.py reads, for tests and smoke runs that need one.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.perception.camera import (CameraIntrinsics, Pose,
                                               quat_identity)
from xrseg_tpu_torch.runtime.frame_source import FrameData

_CALIBRATION_SEED = 20260817


def limit_cpu_threads() -> int:
    """Cap torch's intra-op CPU threads at this process's share of the
    cores: os.cpu_count() // W, where W is the number of pytest-xdist
    workers (PYTEST_XDIST_WORKER_COUNT; 1 outside xdist), at least 1. The
    port's test modules call it at import; the library itself changes no
    thread setting. Returns the thread count set."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


def detection_params(gen: torch.Generator, cfg: ModelConfig, *,
                     label: int = 0, score_logit: float = 2.0,
                     dist_bin: int = 1, cls_spread: float = 0.3,
                     device="cuda") -> yolo11.YOLO11:
    """init_params + head patch => a YOLO11 on `device` that always
    detects: every anchor predicts class `label` at sigmoid(score_logit
    +- ~cls_spread) with a (2*dist_bin*stride)-px box centred on itself."""
    nc, reg_max = cfg.num_classes, cfg.reg_max
    if cfg.task == "classify":
        raise ValueError("detection_params patches the detect head; the "
                         "classify task has none (use init_params)")
    if not 0 <= label < nc:
        raise ValueError(f"label {label} out of range [0, {nc})")
    if not 0 < dist_bin < reg_max:
        raise ValueError(f"dist_bin {dist_bin} out of range (0, {reg_max})")
    dev = resolve_device(device)
    model = yolo11.init_params(gen, cfg).to(dev)
    calib = torch.Generator().manual_seed(_CALIBRATION_SEED)
    x = torch.rand((1, 3) + tuple(cfg.input_size), generator=calib)
    with torch.no_grad():
        feats = model.backbone_neck(x.to(dev, model.dtype))
        for i, f in enumerate(feats):
            d3 = model.det.cv3[i]
            c = d3.hidden(f).float()
            rms = float(c.square().mean().sqrt()) + 1e-12
            w_scale = cls_spread / (rms * c.shape[1] ** 0.5)
            d3.out.weight.copy_(
                torch.randn(d3.out.weight.shape, generator=gen) * w_scale)
            bias = torch.full((nc,), -8.0)
            bias[label] = score_logit
            d3.out.bias.copy_(bias)
            box_out = model.det.cv2[i].out
            box_b = torch.zeros(4 * reg_max)
            box_b[dist_bin::reg_max] = 8.0
            box_out.bias.copy_(box_b)
            box_out.weight.copy_(
                torch.randn(box_out.weight.shape, generator=gen) * 1e-3)
    return model


def xr_frames(n: int, frame_hw: Tuple[int, int],
              depth_hw: Tuple[int, int] = (128, 128), seed: int = 0,
              fps: float = 30.0) -> List[FrameData]:
    """`n` seeded XR frames for drives that need the whole tick: uint8 noise
    images, a tilted depth plane from 1.0 m (top left) to 2.0 m (bottom
    right) as raw fp16 bits (inside the 0.1-3.0 m range filter), the
    camera at the origin with no rotation, Quest-3-like intrinsics, and
    timestamps at `fps`."""
    rng = np.random.default_rng(seed)
    dh, dw = depth_hw
    plane = 1.0 + 0.5 * (np.arange(dw)[None, :] / max(dw - 1, 1)
                         + np.arange(dh)[:, None] / max(dh - 1, 1))
    depth = plane.astype(np.float16).view(np.uint16)
    return [FrameData(rgb=rng.integers(0, 256, tuple(frame_hw) + (3,),
                                       np.uint8),
                      timestamp=i / fps,
                      pose=Pose(np.zeros(3, np.float32), quat_identity()),
                      intrinsics=CameraIntrinsics.quest3_like(),
                      depth_fp16=depth)
            for i in range(n)]


def epilogue_calls(model: yolo11.YOLO11, x: torch.Tensor
                   ) -> List[Tuple[Tuple[int, ...], bool, bool]]:
    """The conv epilogues one inference forward of `model` on `x` (NHWC)
    runs, in order: (shape of the conv output [B, C, H, W], act,
    channels_last) for each conv and transposed conv, as
    models/layers._epilogue receives them."""
    from xrseg_tpu_torch.models import layers
    calls, run = [], layers._epilogue

    def record(y, bias, act):
        calls.append((tuple(y.shape), bool(act), not y.is_contiguous()))
        return run(y, bias, act)

    layers._epilogue = record
    try:
        with torch.inference_mode():
            model(x)
    finally:
        layers._epilogue = run
    return calls


# ---------------------------------------------------------------------------
# a synthetic .sentis template
# ---------------------------------------------------------------------------

_SCALAR_SIZE = {"B": 1, "i": 4, "I": 4, "f": 4, "Q": 8, "off": 4}


class _FlatWriter:
    """A back-to-front flatbuffer writer: objects are prepended, so each
    lies before (at a lower address than) the objects it refers to, and
    every unsigned offset points forward. A position is counted in bytes
    from the end of the buffer; the vtable of a table sits just before
    it, so its signed offset is the vtable's length."""

    def __init__(self):
        self.chunks: List[bytes] = []          # in reverse order
        self.size = 0

    def _prepend(self, b: bytes) -> int:
        self.chunks.append(bytes(b))
        self.size += len(b)
        return self.size

    def _pad(self, align: int, extra: int = 0) -> None:
        """Pad so that `extra` more bytes end on an `align` boundary."""
        n = (-(self.size + extra)) % align
        if n:
            self._prepend(bytes(n))

    def vec_i32(self, xs) -> int:
        self._pad(4)
        self._prepend(struct.pack(f"<{len(xs)}i", *xs))
        return self._prepend(struct.pack("<I", len(xs)))

    def vec_offsets(self, targets) -> int:
        self._pad(4)
        for t in reversed(targets):
            self._prepend(struct.pack("<I", self.size + 4 - t))
        return self._prepend(struct.pack("<I", len(targets)))

    def string(self, s: str) -> int:
        b = s.encode("utf8") + b"\0"
        self._pad(4, len(b))
        self._prepend(b)
        return self._prepend(struct.pack("<I", len(b) - 1))

    def table(self, fields: Dict[int, Tuple[str, object]]) -> int:
        """fields: index -> (struct format or "off", value); an "off"
        value is the position of an object built earlier. Fields left out
        read as their defaults."""
        off, pos = 4, {}
        for f in sorted(fields, key=lambda f: -_SCALAR_SIZE[fields[f][0]]):
            sz = _SCALAR_SIZE[fields[f][0]]
            off = -(-off // sz) * sz
            pos[f] = off
            off += sz
        tsize = -(-off // 8) * 8
        self._pad(8)
        start = self.size + tsize
        n = max(fields) + 1 if fields else 0
        vt = struct.pack(f"<HH{n}H", 4 + 2 * n, tsize,
                         *[pos.get(f, 0) for f in range(n)])
        body = bytearray(tsize)
        struct.pack_into("<i", body, 0, len(vt))
        for f, (fmt, v) in fields.items():
            if fmt == "off":
                struct.pack_into("<I", body, pos[f], start - pos[f] - v)
            else:
                struct.pack_into("<" + fmt, body, pos[f], v)
        self._prepend(body)
        self._prepend(vt)
        return start

    def finish(self, root: int) -> bytes:
        """The root offset first; 4 + the buffer's length is a multiple of
        16, so the constant segment after it starts aligned."""
        self._pad(16, 8)
        self._prepend(struct.pack("<I", self.size + 4 - root))
        return b"".join(reversed(self.chunks))


def sentis_template(cfg: ModelConfig, model, path: str, *,
                    seed: int = 0) -> str:
    """Write `model`'s weights (a YOLO11, or a params pytree of numpy
    arrays) as a `.sentis` file at `path`, in the container of
    io/sentis.py, and return `path`.

    One weighted op per slot of io/onnx_loader.ordered_param_slots(cfg),
    in order: Conv with an OIHW weight, ConvTranspose with an IOHW one,
    the DFL conv as a float32 arange(reg_max) constant, and for the
    classify head's linear slot a Gemm (which the format's readers do not
    count as weighted). Weights and biases are DequantizeUint8 chains of a
    uint8 constant, a Float scale and an Int zero point, quantized by
    io/sentis.quantize_uint8, except that the first conv's bias is a
    float32 constant and the bias of det.cv2.0.out (when the model has
    one) keeps its zero point at the flatbuffer default: no bytes are
    stored for it, its scale is the largest value / 255 and its negative
    values clip to 0. Sigmoid, Mul, Concat and Reshape chains (with an
    int32 shape constant) lie between the weighted ops, as `seed` picks
    them; `seed` also picks which uint8 constants are stored flat and the
    order of the constants in the segment. The file's graph is not meant
    to run: only what the readers take from it is."""
    from xrseg_tpu_torch.io.onnx_loader import ordered_param_slots
    from xrseg_tpu_torch.io.sentis import _key, _state_of, quantize_uint8

    rng = np.random.default_rng(seed)
    state = _state_of(model)
    operators = ["Sigmoid", "Conv", "DequantizeUint8", "ConvTranspose",
                 "Mul", "Concat", "Reshape", "Softmax", "Gemm"]
    values: List[Tuple[int, Dict]] = []        # (union type, fields)
    consts: List[Tuple[int, bytes]] = []       # (tensor value id, payload)
    chains: List[Tuple[List[int], List[int], int, List[int]]] = []

    def value(ty: int, **kw) -> int:
        values.append((ty, kw))
        return len(values) - 1

    def const(arr: np.ndarray, dtype: int, shape) -> int:
        vid = value(6, dtype=dtype, nbytes=arr.nbytes, shape=list(shape),
                    const=True)
        consts.append((vid, arr.tobytes()))
        return vid

    def chain(op: str, ins, outs, args=()) -> None:
        chains.append((list(ins), list(outs), operators.index(op),
                       list(args)))

    def weight(arr: np.ndarray, how: str = "u8") -> int:
        """A constant input of a weighted op: its value id."""
        arr = np.ascontiguousarray(arr, np.float32)
        if how == "f32":
            return const(arr, 0, arr.shape)
        if how == "pinned":
            scale = max(float(arr.max()) / 255.0, 1e-12)
            q = np.clip(np.rint(arr / scale), 0, 255).astype(np.uint8)
            zp_id = value(2)                   # the field left at default
        else:
            q, scale, zp = quantize_uint8(arr)
            zp_id = value(2, i=zp)
        flat = rng.random() < 0.3
        qid = const(q, 3, (q.size,) if flat else q.shape)
        out = value(6, shape=list(arr.shape))
        chain("DequantizeUint8", [qid], [out], [value(3, f=scale), zp_id])
        return out

    x = value(6, shape=[1, 3, *cfg.input_size])
    ep_inputs, acts = [x], [x]
    none = value(0)                            # an absent optional input
    first_conv = True
    for pathk, kind in ordered_param_slots(cfg):
        y = value(6)
        if kind == "dfl":
            w = np.arange(cfg.reg_max, dtype=np.float32).reshape(
                1, cfg.reg_max, 1, 1)
            chain("Softmax", [acts[-1]], [y])
            z = value(6)
            chain("Conv", [y, const(w, 0, w.shape), none], [z],
                  [value(8, ints=[1, 1]), -1])
            acts.append(z)
            continue
        if kind == "gemm":
            w, b = (state[_key(pathk, n)] for n in ("lin_w", "lin_b"))
            chain("Gemm", [acts[-1], const(w, 0, w.shape),
                           const(b, 0, b.shape)], [y])
            acts.append(y)
            continue
        names = (("up_w", "up_b") if kind == "convtranspose"
                 else ("weight", "bias"))
        w, b = (state[_key(pathk, n)] for n in names)
        how = ("f32" if first_conv else
               "pinned" if pathk == ("det", "cv2", 0, "out") else "u8")
        first_conv = False
        wid, bid = weight(w), weight(b, how)
        k = w.shape[-1]
        group = w.shape[0] if kind == "conv" and w.shape[1] == 1 else 1
        chain("ConvTranspose" if kind == "convtranspose" else "Conv",
              [acts[-1], wid, bid], [y],
              [value(8, ints=[k // 2] * 4), value(2, i=group), -1])
        acts.append(y)
        pick = rng.random()
        if pick < 0.5:                         # SiLU as Sigmoid, Mul
            s, z = value(6), value(6)
            chain("Sigmoid", [y], [s])
            chain("Mul", [y, s], [z])
            acts.append(z)
        elif pick < 0.6:
            z = value(6)
            chain("Concat", acts[-2:], [z], [value(2, i=1)])
            acts.append(z)
    shape = const(np.array([1, -1], np.int32), 1, (2,))
    out = value(6)
    chain("Reshape", [acts[-1], shape], [out])
    cat = value(6)
    chain("Concat", [out, acts[1]], [cat], [value(2, i=-1)])
    ep_outputs = [cat, acts[-1]]
    value(4, s="yolo11")                       # a String value

    # the constant segment, in a seeded order, each payload 16-aligned
    segment = bytearray()
    offsets = {}
    for i in rng.permutation(len(consts)):
        vid, payload = consts[i]
        offsets[vid] = len(segment)
        segment += payload + bytes(-len(payload) % 16)

    fb = _FlatWriter()
    value_tables = []
    for vid, (ty, kw) in enumerate(values):
        if ty == 0:
            value_tables.append(fb.table({}))
            continue
        if ty == 6:
            fields = {1: ("I", kw.get("nbytes", 0))}
            if kw.get("dtype", 0):
                fields[0] = ("B", kw["dtype"])
            if kw.get("shape"):
                fields[2] = ("off", fb.vec_i32(kw["shape"]))
            if kw.get("const"):
                fields[3] = ("I", 1)
            if offsets.get(vid, 0):
                fields[4] = ("I", offsets[vid])
        elif ty == 3:
            fields = {0: ("f", kw["f"])}
        elif ty == 2:
            fields = {0: ("i", kw["i"])} if "i" in kw else {}
        elif ty == 8:
            fields = {0: ("off", fb.vec_i32(kw["ints"]))}
        else:
            fields = {0: ("off", fb.string(kw["s"]))}
        payload = fb.table(fields)
        value_tables.append(fb.table({0: ("B", ty), 1: ("off", payload)}))
    chain_tables = []
    for ins, outs, op, args in chains:
        call = {1: ("off", fb.vec_i32(args))}
        if op:
            call[0] = ("I", op)
        instr = fb.table({0: ("B", 1), 1: ("off", fb.table(call))})
        chain_tables.append(fb.table({
            0: ("off", fb.vec_i32(ins)), 1: ("off", fb.vec_i32(outs)),
            2: ("off", fb.vec_offsets([instr]))}))
    op_tables = [fb.table({0: ("off", fb.string(o))}) for o in operators]
    plan = fb.table({0: ("off", fb.string("forward")),
                     1: ("off", fb.vec_offsets(value_tables)),
                     2: ("off", fb.vec_i32(ep_inputs)),
                     4: ("off", fb.vec_i32(ep_outputs)),
                     6: ("off", fb.vec_offsets(chain_tables)),
                     7: ("off", fb.vec_offsets(op_tables))})
    seg = fb.table({0: ("Q", 0), 1: ("Q", len(segment))})
    root = fb.table({0: ("I", 1), 1: ("off", plan),
                     3: ("off", fb.vec_offsets([seg]))})
    program = fb.finish(root)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(program)) + program + bytes(segment))
    return path
