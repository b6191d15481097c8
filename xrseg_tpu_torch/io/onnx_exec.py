"""Minimal ONNX interpreter in torch, for verifying exports (counterpart of
xrseg_tpu/io/onnx_exec.py).

No onnxruntime is installed, so io/onnx_export.py's output is verified by
executing the graph: the ops the exporter emits are implemented here with
torch ops on an explicit device (torch.nn.functional for Conv,
ConvTranspose, MaxPool, Resize and Softmax), and the result is compared
against the port's forward. Also a debugging lens on any ultralytics-style
ONNX file.

Supported ops: Conv, ConvTranspose, MaxPool, Resize (nearest, integer
scales), Sigmoid, Softmax, MatMul, Mul, Add, Sub, Concat, Split, Reshape,
Transpose, Identity (everything the exporter emits), plus the common
foreign-graph vocabulary of third-party exports: Slice, Gather, Shape,
Unsqueeze, Squeeze, Div, Pow, Exp, Cos, Sin, Sqrt, Neg, Constant, Cast,
ReduceMax, ReduceMean, ArgMax, Gemm, Flatten, Relu, LeakyRelu, Clip,
GlobalAveragePool, Where, Equal, Greater, Less, Expand, Range. Axes-style
arguments take both the attribute form (opset < 13) and the input form
(opset >= 13). Every value lives on the device; shape-like inputs are read
back to the host where an op needs them as numbers.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from xrseg_tpu_torch.device import resolve_device
from xrseg_tpu_torch.io.onnx_loader import (_collect, _fields, _parse_tensor,
                                            _read_varint)

# AttributeProto.type enum
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS = 6, 7

# TensorProto.DataType code -> torch dtype (Cast targets)
_CAST_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                6: torch.int32, 7: torch.int64, 9: torch.bool,
                10: torch.float16, 11: torch.float64}


def _parse_attr(buf: bytes) -> Any:
    name = ""
    atype = None
    i_val = f_val = s_val = t_val = None
    ints: List[int] = []
    floats: List[float] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = val.decode("utf8")
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = val
        elif fnum == 4:
            s_val = val.decode("utf8")
        elif fnum == 5:                       # t: embedded TensorProto
            t_val = _parse_tensor(val)[1]     # (Constant op payload)
        elif fnum == 6:
            floats.append(struct.unpack("<f", val)[0])
        elif fnum == 7:
            if wtype == 0:
                ints.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v)
        elif fnum == 20:
            atype = val
    if atype == _AT_INT:
        return name, i_val
    if atype == _AT_FLOAT:
        return name, f_val
    if atype == _AT_STRING:
        return name, s_val
    if atype == _AT_TENSOR:
        return name, t_val
    if atype == _AT_INTS:
        return name, ints
    if atype == _AT_FLOATS:
        return name, floats
    # untyped: whichever field appeared
    return name, (i_val if i_val is not None else
                  f_val if f_val is not None else
                  s_val if s_val is not None else
                  t_val if t_val is not None else ints or floats)


def parse_onnx_full(path: str) -> Dict[str, Any]:
    """Like onnx_loader.parse_onnx but keeps node attributes and the graph's
    input and output names too."""
    with open(path, "rb") as f:
        model = _collect(f.read())
    graph = _collect(model[7][0])
    nodes = []
    for b in graph.get(1, []):
        node = {"inputs": [], "outputs": [], "name": "", "op": "",
                "attrs": {}}
        for fnum, _, val in _fields(b):
            if fnum == 1:
                node["inputs"].append(val.decode("utf8"))
            elif fnum == 2:
                node["outputs"].append(val.decode("utf8"))
            elif fnum == 3:
                node["name"] = val.decode("utf8")
            elif fnum == 4:
                node["op"] = val.decode("utf8")
            elif fnum == 5:
                k, v = _parse_attr(val)
                node["attrs"][k] = v
        nodes.append(node)
    inits = dict(_parse_tensor(b) for b in graph.get(5, []))

    def names(field):
        out = []
        for b in graph.get(field, []):
            for fnum, _, val in _fields(b):
                if fnum == 1:
                    out.append(val.decode("utf8"))
                    break
        return out

    return {"nodes": nodes, "initializers": inits, "inputs": names(11),
            "outputs": names(12)}


# ---------------------------------------------------------------------------
# op semantics (NCHW)
# ---------------------------------------------------------------------------

def _ints(t) -> List[int]:
    """A shape-like value as host ints."""
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(t).reshape(-1)]


def _pad2d(x, pads, value=0.0):
    """ONNX pads [top, left, bottom, right] -> (x, symmetric (ph, pw)):
    asymmetric pads are applied to x here."""
    t, l, b, r = (int(p) for p in pads)
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _conv(x, w, b, attrs):
    x, pad = _pad2d(x.float(), attrs.get("pads", [0, 0, 0, 0]))
    return F.conv2d(x, w.float(), None if b is None else b.float(),
                    tuple(int(s) for s in attrs.get("strides", [1, 1])),
                    pad, tuple(int(d) for d in attrs.get("dilations",
                                                         [1, 1])),
                    int(attrs.get("group", 1)))


def _convtranspose(x, w, b, attrs):
    # ONNX and torch share the weight layout [Cin, Cout/group, kH, kW]
    return F.conv_transpose2d(
        x.float(), w.float(), None if b is None else b.float(),
        tuple(int(s) for s in attrs.get("strides", [1, 1])),
        groups=int(attrs.get("group", 1)))


def _maxpool(x, attrs):
    k = [int(v) for v in attrs["kernel_shape"]]
    x, pad = _pad2d(x.float(), attrs.get("pads", [0] * 4), -np.inf)
    return F.max_pool2d(x, k, [int(s) for s in attrs.get("strides", [1, 1])],
                        pad)


def _resize(x, scales, attrs):
    if attrs.get("mode") != "nearest":
        raise NotImplementedError(f"Resize mode {attrs.get('mode')!r}")
    sh, sw = (int(v) for v in scales.reshape(-1)[2:].tolist())
    return x.repeat_interleave(sh, 2).repeat_interleave(sw, 3)


def _axes(ins, a):
    """Axes from the second input (opset >= 13) or the attribute."""
    if len(ins) > 1 and ins[1] is not None:
        return _ints(ins[1])
    return [int(v) for v in a.get("axes", [])]


def run_onnx(path: str, feeds: Dict[str, Any], device="cuda"
             ) -> Dict[str, torch.Tensor]:
    """Execute the graph on `device`; returns {output_name: tensor}."""
    dev = resolve_device(device)
    parsed = parse_onnx_full(path)

    def put(a):
        return torch.as_tensor(np.array(a)).to(dev)      # a writable copy

    vals: Dict[str, torch.Tensor] = {k: put(v) for k, v in
                                     parsed["initializers"].items()}
    vals.update({k: v.to(dev) if isinstance(v, torch.Tensor) else put(v)
                 for k, v in feeds.items()})

    for node in parsed["nodes"]:
        op = node["op"]
        a = node["attrs"]
        ins = [vals[i] if i else None for i in node["inputs"]]
        opt = (lambda i: ins[i] if len(ins) > i else None)
        if op == "Conv":
            out = _conv(ins[0], ins[1], opt(2), a)
        elif op == "ConvTranspose":
            out = _convtranspose(ins[0], ins[1], opt(2), a)
        elif op == "MaxPool":
            out = _maxpool(ins[0], a)
        elif op == "Resize":
            out = _resize(ins[0], ins[2], a)
        elif op == "Sigmoid":
            out = torch.sigmoid(ins[0].float())
        elif op == "Softmax":
            out = torch.softmax(ins[0].float(), int(a["axis"]))
        elif op == "MatMul":
            out = torch.matmul(ins[0].float(), ins[1].float())
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Concat":
            out = torch.cat(ins, int(a["axis"]))
        elif op == "Split":
            outs = torch.split(ins[0], _ints(ins[1]), int(a.get("axis", 0)))
            for nm, o in zip(node["outputs"], outs):
                vals[nm] = o
            continue
        elif op == "Reshape":
            out = ins[0].reshape(_ints(ins[1]))
        elif op == "Transpose":
            out = ins[0].permute([int(p) for p in a["perm"]])
        elif op == "Identity":
            out = ins[0]
        # ---- foreign-graph vocabulary (third-party exports) ----------
        elif op == "Slice":
            starts, ends = _ints(ins[1]), _ints(ins[2])
            axes = _ints(ins[3]) if opt(3) is not None \
                else list(range(len(starts)))
            steps = _ints(ins[4]) if opt(4) is not None \
                else [1] * len(starts)
            sl = [slice(None)] * ins[0].dim()
            for s, e, ax, st in zip(starts, ends, axes, steps):
                if st <= 0:
                    raise NotImplementedError("Slice with a step <= 0")
                sl[ax] = slice(s, e, st)
            out = ins[0][tuple(sl)]
        elif op == "Gather":
            axis = int(a.get("axis", 0)) % ins[0].dim()
            idx = ins[1].long() % ins[0].shape[axis]
            out = ins[0].index_select(axis, idx.reshape(-1)).reshape(
                *ins[0].shape[:axis], *idx.shape, *ins[0].shape[axis + 1:])
        elif op == "Shape":
            out = torch.tensor(list(ins[0].shape), dtype=torch.int64,
                               device=dev)
        elif op in ("Unsqueeze", "Squeeze"):
            axes = _axes(ins, a)
            out = ins[0]
            if op == "Unsqueeze":
                for ax in sorted(ax % (out.dim() + 1) for ax in axes):
                    out = out.unsqueeze(ax)
            else:
                out = (out.squeeze(tuple(ax % out.dim() for ax in axes))
                       if axes else out.squeeze())
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Pow":
            out = torch.pow(ins[0].float(), ins[1])
        elif op == "Exp":
            out = torch.exp(ins[0].float())
        elif op == "Cos":
            out = torch.cos(ins[0].float())
        elif op == "Sin":
            out = torch.sin(ins[0].float())
        elif op == "Sqrt":
            out = torch.sqrt(ins[0].float())
        elif op == "Neg":
            out = -ins[0]
        elif op == "Constant":
            out = put(a["value"])
        elif op == "Cast":
            out = ins[0].to(_CAST_DTYPES[int(a["to"])])
        elif op in ("ReduceMax", "ReduceMean"):
            axes = _axes(ins, a) or list(range(ins[0].dim()))
            keep = bool(a.get("keepdims", 1))
            out = ins[0].amax(axes, keep) if op == "ReduceMax" \
                else ins[0].mean(axes, keep)
        elif op == "ArgMax":
            ax = int(a.get("axis", 0))
            out = ins[0].argmax(ax, keepdim=bool(a.get("keepdims", 1)))
        elif op == "Gemm":
            x, w = ins[0].float(), ins[1].float()
            if int(a.get("transA", 0)):
                x = x.T
            if int(a.get("transB", 0)):
                w = w.T
            out = float(a.get("alpha", 1.0)) * (x @ w)
            if opt(2) is not None:
                out = out + float(a.get("beta", 1.0)) * ins[2]
        elif op == "Flatten":
            ax = int(a.get("axis", 1))
            out = ins[0].reshape(int(np.prod(ins[0].shape[:ax])) or 1, -1)
        elif op == "Relu":
            out = ins[0].clamp_min(0)
        elif op == "LeakyRelu":
            out = torch.where(ins[0] >= 0, ins[0],
                              float(a.get("alpha", 0.01)) * ins[0])
        elif op == "Clip":
            lo = opt(1) if opt(1) is not None else a.get("min")
            hi = opt(2) if opt(2) is not None else a.get("max")
            out = torch.clamp(ins[0], lo, hi)
        elif op == "GlobalAveragePool":
            out = ins[0].mean((2, 3), keepdim=True)
        elif op == "Where":
            out = torch.where(ins[0].bool(), ins[1], ins[2])
        elif op == "Equal":
            out = ins[0] == ins[1]
        elif op == "Greater":
            out = ins[0] > ins[1]
        elif op == "Less":
            out = ins[0] < ins[1]
        elif op == "Expand":
            out = ins[0] * torch.ones(_ints(ins[1]), dtype=ins[0].dtype,
                                      device=dev)
        elif op == "Range":
            out = torch.arange(ins[0].item(), ins[1].item(), ins[2].item(),
                               dtype=ins[0].dtype, device=dev)
        else:
            raise NotImplementedError(f"op {op}")
        vals[node["outputs"][0]] = out

    return {o: vals[o] for o in parsed["outputs"]}
