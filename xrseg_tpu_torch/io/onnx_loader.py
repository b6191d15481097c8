"""Minimal ONNX weight loader with no `onnx` package (counterpart of
xrseg_tpu/io/onnx_loader.py).

Parses the ONNX protobuf wire format directly, just enough to pull the
graph's Conv / ConvTranspose / Gemm nodes in graph order with their weight
and bias initializers, and maps them positionally onto the port's model in
the order of `ordered_param_slots`: the order in which an ultralytics
export (and io/onnx_export.py) emits the weighted ops. Covers fp32 and
fp16 initializers, raw_data and typed fields.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.torch_pt import load_state, seed_o2o
from xrseg_tpu_torch.models.yolo11 import YOLO11, Spec, refuse_arch


# ---------------------------------------------------------------------------
# protobuf wire-format reader
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) for one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:        # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:      # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:      # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:      # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _collect(buf: bytes) -> Dict[int, List[Any]]:
    out: Dict[int, List[Any]] = {}
    for fnum, _, val in _fields(buf):
        out.setdefault(fnum, []).append(val)
    return out


# ONNX TensorProto dtypes
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: 1=dims(varint rep), 2=data_type, 4=float_data,
    7=int64_data, 8=name, 9=raw_data."""
    dims: List[int] = []
    dtype = np.float32
    name = ""
    raw: Optional[bytes] = None
    floats: List[bytes] = []
    int64s: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            dims.append(val)
        elif fnum == 2:
            dtype = _DTYPES.get(val, np.float32)
        elif fnum == 8:
            name = val.decode("utf8")
        elif fnum == 9:
            raw = val
        elif fnum == 4:
            floats.append(val)
        elif fnum == 7:
            if wtype == 0:
                int64s.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
    if raw is not None:
        arr = np.frombuffer(raw, dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_node(buf: bytes) -> Dict[str, Any]:
    """NodeProto: 1=input(rep str), 2=output, 3=name, 4=op_type."""
    node = {"inputs": [], "outputs": [], "name": "", "op": ""}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node["inputs"].append(val.decode("utf8"))
        elif fnum == 2:
            node["outputs"].append(val.decode("utf8"))
        elif fnum == 3:
            node["name"] = val.decode("utf8")
        elif fnum == 4:
            node["op"] = val.decode("utf8")
    return node


def parse_onnx(path: str) -> Dict[str, Any]:
    """Returns {"nodes": [NodeDict...] (graph order),
    "initializers": {name: array},
    "metadata": {key: value} (ModelProto.metadata_props — ultralytics
    stores `names`/`task`/`imgsz`/`kpt_shape` there)}."""
    data = open(path, "rb").read()
    model = _collect(data)
    if 7 not in model:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    graph = _collect(model[7][0])
    nodes = [_parse_node(b) for b in graph.get(1, [])]
    inits = dict(_parse_tensor(b) for b in graph.get(5, []))
    meta: Dict[str, str] = {}
    for entry in model.get(14, []):
        kv = _collect(entry)
        if 1 in kv and 2 in kv:
            meta[kv[1][0].decode("utf8")] = kv[2][0].decode("utf8")
    return {"nodes": nodes, "initializers": inits, "metadata": meta}


def read_class_names(path_or_parsed) -> Optional[List[str]]:
    """The `names` metadata entry as an index-ordered list (ultralytics
    str({0: 'person', ...}) form), or None when absent/unparseable."""
    import ast
    parsed = (path_or_parsed if isinstance(path_or_parsed, dict)
              else parse_onnx(path_or_parsed))
    raw = parsed.get("metadata", {}).get("names")
    if not raw:
        return None
    try:
        d = ast.literal_eval(raw)
        return [str(d[i]) for i in sorted(d)]
    except (ValueError, SyntaxError, KeyError, TypeError):
        return None


def conv_sequence_onnx(parsed: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Weighted ops (Conv/ConvTranspose/Gemm) in graph order with their
    arrays (Gemm carries the classify head's linear layer)."""
    inits = parsed["initializers"]
    seq = []
    for node in parsed["nodes"]:
        if node["op"] not in ("Conv", "ConvTranspose", "Gemm"):
            continue
        if len(node["inputs"]) < 2 or node["inputs"][1] not in inits:
            continue
        w = np.asarray(inits[node["inputs"][1]], np.float32)
        b = None
        if len(node["inputs"]) > 2 and node["inputs"][2] in inits:
            b = np.asarray(inits[node["inputs"][2]], np.float32)
        seq.append({"op": node["op"], "w": w, "b": b, "name": node["name"]})
    return seq



def ordered_param_slots(cfg: ModelConfig):
    """Conv-like module paths of the port's model in the order an
    exported graph runs them: backbone sequentially, FPN level blocks each
    followed immediately by that level's detect branches, the DFL conv,
    then segment cv4 heads and Proto (the JAX package's
    yolo11.ordered_param_slots, over the port's own Spec and module names).

    Returns (path, kind) pairs, path a tuple of the port's module names and
    indices (its state-dict prefix split at the dots), kind one of "conv",
    "convtranspose", "gemm" (the classify head's linear layer) and "dfl"
    (the fixed arange conv, which the port's decode has no parameter for).
    """
    refuse_arch(cfg, "the ONNX and .sentis slot mapping")
    s = Spec(cfg)
    slots = []

    def conv(*path):
        slots.append((tuple(path), "conv"))

    def bottleneck(*p):
        conv(*p, "cv1")
        conv(*p, "cv2")

    def c3k(*p):
        conv(*p, "cv1")
        for i in range(2):
            bottleneck(*p, "m", i)
        conv(*p, "cv2")
        conv(*p, "cv3")

    def c3k2(name, is_c3k):
        conv(name, "cv1")
        for i in range(s.n2):
            if is_c3k:
                c3k(name, "m", i)
            else:
                bottleneck(name, "m", i)
        conv(name, "cv2")

    def branch3(name):
        for i in range(3):
            conv(name, i, "conv0")
            conv(name, i, "conv1")
            conv(name, i, "out")

    def task_tail():
        if cfg.task == "segment":
            branch3("seg_cv4")
            conv("proto", "cv1")
            slots.append((("proto",), "convtranspose"))
            conv("proto", "cv2")
            conv("proto", "cv3")
        elif cfg.task == "pose":
            branch3("pose_cv4")
        elif cfg.task == "obb":
            branch3("obb_cv4")

    if s.arch == "yolov8":
        def c2f(name, n):
            conv(name, "cv1")
            for i in range(n):
                bottleneck(name, "m", i)
            conv(name, "cv2")

        def detect_level_v8(i):
            conv("det", "cv2", i, "conv0")
            conv("det", "cv2", i, "conv1")
            conv("det", "cv2", i, "out")
            conv("det", "cv3", i, "conv0")
            conv("det", "cv3", i, "conv1")
            conv("det", "cv3", i, "out")

        conv("b0"); conv("b1")
        c2f("b2", s.n3); conv("b3")
        c2f("b4", s.n6); conv("b5")
        c2f("b6", s.n6); conv("b7")
        c2f("b8", s.n3)
        if cfg.task == "classify":   # v8-cls: no SPPF
            conv("cls_head", "conv")
            slots.append((("cls_head",), "gemm"))
            return slots
        conv("b9", "cv1"); conv("b9", "cv2")
        c2f("h13", s.n3)
        c2f("h16", s.n3)
        detect_level_v8(0)
        conv("h17")
        c2f("h19", s.n3)
        detect_level_v8(1)
        conv("h20")
        c2f("h22", s.n3)
        detect_level_v8(2)
        slots.append(((), "dfl"))
        task_tail()
        return slots

    fc3k = s.force_c3k
    conv("b0"); conv("b1")
    c3k2("b2", fc3k or False); conv("b3")
    c3k2("b4", fc3k or False); conv("b5")
    c3k2("b6", True); conv("b7")
    c3k2("b8", True)
    conv("b9", "cv1"); conv("b9", "cv2")
    conv("b10", "cv1")
    for i in range(s.n2):
        conv("b10", "m", i, "attn", "qkv")
        conv("b10", "m", i, "attn", "pe")
        conv("b10", "m", i, "attn", "proj")
        conv("b10", "m", i, "ffn1")
        conv("b10", "m", i, "ffn2")
    conv("b10", "cv2")

    if cfg.task == "classify":
        # backbone-only topology: Conv(1280) then the pooled linear head
        # (exported as a Gemm; the Gemm slot carries (lin_w, lin_b))
        conv("cls_head", "conv")
        slots.append((("cls_head",), "gemm"))
        return slots

    c3k2("h13", fc3k or False)
    c3k2("h16", fc3k or False)

    def detect_level(i):
        conv("det", "cv2", i, "conv0")
        conv("det", "cv2", i, "conv1")
        conv("det", "cv2", i, "out")
        conv("det", "cv3", i, "dw0")
        conv("det", "cv3", i, "pw0")
        conv("det", "cv3", i, "dw1")
        conv("det", "cv3", i, "pw1")
        conv("det", "cv3", i, "out")

    detect_level(0)
    conv("h17")
    c3k2("h19", fc3k or False)
    detect_level(1)
    conv("h20")
    c3k2("h22", True)
    detect_level(2)
    slots.append(((), "dfl"))

    task_tail()                   # seg cv4+proto / pose / obb after DFL
    return slots


def load_yolo11_onnx(path: str, cfg: ModelConfig = None
                     ) -> Tuple[YOLO11, ModelConfig]:
    """Load an ultralytics-contract YOLO11/YOLOv8 ONNX export into a YOLO11
    on the CPU, by the ordered-slot mapping. Returns (model, cfg); cfg
    defaults to ModelConfig(scale="n")."""
    if cfg is None:
        cfg = ModelConfig(scale="n")
    parsed = parse_onnx(path)
    seq = conv_sequence_onnx(parsed)
    slots = ordered_param_slots(cfg)
    # ONNX exports keep the DFL conv too; tolerate exact or off-by-DFL counts
    if len(seq) != len(slots):
        # maybe the export lacks the DFL conv (older exports decode in graph)
        slots_nodfl = [s for s in slots if s[1] != "dfl"]
        if len(seq) == len(slots_nodfl):
            slots = slots_nodfl
        else:
            raise ValueError(
                f"weighted-op count mismatch: onnx has {len(seq)}, model "
                f"({cfg.scale}, {cfg.task}) expects {len(slots)}")

    model = YOLO11(cfg)
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def put(pathk, name, a, what) -> None:
        key = ".".join([str(p) for p in pathk] + [name])
        if tuple(state[key].shape) != a.shape:
            raise ValueError(f"{what} shape mismatch at {pathk}: model "
                             f"{tuple(state[key].shape)} vs onnx {a.shape}")
        state[key] = torch.tensor(np.asarray(a, np.float32))

    for (pathk, kind), op in zip(slots, seq):
        w, b = op["w"], op["b"]
        if kind == "gemm":            # lin_w [hidden, nc] (transB=0 export)
            put(pathk, "lin_w", w, "gemm")
            if b is not None:
                put(pathk, "lin_b", b, "gemm")
        elif kind == "dfl":
            got = w.reshape(-1)
            if not np.allclose(got, np.arange(cfg.reg_max), atol=0.5):
                raise ValueError(f"unexpected DFL weights: {got[:8]}")
        elif kind == "convtranspose":  # [Cin, Cout, kH, kW], the port's up_w
            put(pathk, "up_w", w, "upsample")
            if b is not None:
                put(pathk, "up_b", b, "upsample")
        else:
            put(pathk, "weight", w, "conv")
            if b is not None:
                put(pathk, "bias", b, "conv")
    seed_o2o(state, cfg)
    return load_state(model, state), cfg
