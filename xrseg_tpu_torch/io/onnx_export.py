"""ONNX export: the port's model -> an ultralytics-contract ONNX file
(counterpart of xrseg_tpu/io/onnx_export.py).

The reference's offline converter consumes a raw ultralytics YOLO11 ONNX
export (output0 [1,4+nc+nm,A], output1 [1,nm,H/4,W/4]), so a model trained
or loaded here can go back into that pipeline or any ONNX runtime. No
`onnx` package is installed, so the ModelProto is written directly in
protobuf wire format (the mirror of io/onnx_loader.py's reader). The graph
follows the ultralytics export shape for shape: NCHW tensors,
Conv+Sigmoid+Mul (SiLU), Resize-nearest upsamples, in-graph DFL
(Reshape/Transpose/Softmax/arange-Conv) and box decode against constant
anchors and strides, Sigmoid class scores, raw mask coefficients,
ConvTranspose proto upsample. Weighted ops appear in the order of
io/onnx_loader.ordered_param_slots, so load_yolo11_onnx reads the file
back, and io/onnx_exec.run_onnx executes it.

The writer walks the port's modules through their JAX-layout view
(io/weights.params_to_tree: HWIO conv weights) and emits the same bytes as
the JAX package's export of the same weights.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.io.weights import params_to_tree
from xrseg_tpu_torch.models.yolo11 import (YOLO11, Spec, make_anchors,
                                           refuse_arch)
from xrseg_tpu_torch.viz.labels import COCO_LABELS

# ---------------------------------------------------------------------------
# protobuf wire writer
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _fv(fnum: int, val: int) -> bytes:           # varint field
    return _tag(fnum, 0) + _varint(val)


def _fb(fnum: int, payload: bytes) -> bytes:     # length-delimited field
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _fs(fnum: int, s: str) -> bytes:
    return _fb(fnum, s.encode("utf8"))


def _ff(fnum: int, val: float) -> bytes:         # 32-bit float field
    return _tag(fnum, 5) + struct.pack("<f", float(val))


# ---------------------------------------------------------------------------
# ONNX proto emitters
# ---------------------------------------------------------------------------

_ONNX_DTYPE = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
               np.dtype(np.float16): 10, np.dtype(np.int32): 6}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_fv(1, int(d)) for d in arr.shape)
    out += _fv(2, _ONNX_DTYPE[arr.dtype])
    out += _fs(8, name)
    out += _fb(9, arr.tobytes())
    return out


# AttributeProto.type enum values
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR, _AT_FLOATS, _AT_INTS = \
    1, 2, 3, 4, 6, 7


def _attr(name: str, value) -> bytes:
    out = _fs(1, name)
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        out += _fv(3, int(value)) + _fv(20, _AT_INT)
    elif isinstance(value, float):
        out += _ff(2, value) + _fv(20, _AT_FLOAT)
    elif isinstance(value, str):
        out += _fb(4, value.encode("utf8")) + _fv(20, _AT_STRING)
    elif isinstance(value, (list, tuple)) and value and isinstance(
            value[0], float):
        out += b"".join(_tag(6, 5) + struct.pack("<f", v) for v in value)
        out += _fv(20, _AT_FLOATS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_fv(7, int(v)) for v in value) + _fv(20, _AT_INTS)
    elif isinstance(value, np.ndarray):
        # TENSOR attribute (e.g. the Constant op's `value`)
        out += _fb(5, _tensor_proto(name, value)) + _fv(20, _AT_TENSOR)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _node_proto(op: str, inputs: Sequence[str], outputs: Sequence[str],
                name: str, attrs: Dict[str, Any]) -> bytes:
    out = b"".join(_fs(1, i) for i in inputs)
    out += b"".join(_fs(2, o) for o in outputs)
    out += _fs(3, name) + _fs(4, op)
    out += b"".join(_fb(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, shape: Sequence[int], elem_type: int = 1) -> bytes:
    dims = b"".join(_fb(1, _fv(1, int(d))) for d in shape)
    tensor_type = _fv(1, elem_type) + _fb(2, dims)
    return _fs(1, name) + _fb(2, _fb(1, tensor_type))


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------


class _G:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, hint: str, arr: np.ndarray) -> str:
        nm = self.name(hint)
        self.inits.append(_tensor_proto(nm, np.asarray(arr)))
        return nm

    def n(self, op: str, inputs: Sequence[str], n_out: int = 1,
          out_names: Optional[Sequence[str]] = None, **attrs):
        outs = (list(out_names) if out_names
                else [self.name(op.lower()) for _ in range(n_out)])
        self.nodes.append(_node_proto(op, inputs, outs,
                                      self.name(op), attrs))
        return outs[0] if n_out == 1 and out_names is None else outs


def _silu(g: _G, x: str) -> str:
    return g.n("Mul", [x, g.n("Sigmoid", [x])])


def _conv(g: _G, p, x: str, stride: int = 1, groups: int = 1,
          act: bool = True) -> str:
    """p: {w HWIO, b}. Emits Conv (OIHW weights) + optional SiLU."""
    w = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))  # OIHW
    k = w.shape[-1]
    inputs = [x, g.init("w", w)]
    if p.get("b") is not None:
        inputs.append(g.init("b", np.asarray(p["b"], np.float32)))
    y = g.n("Conv", inputs, kernel_shape=[k, k],
            strides=[stride, stride], pads=[k // 2] * 4, group=groups)
    return _silu(g, y) if act else y


def _dwconv(g: _G, p, x: str, c: int, act: bool = True) -> str:
    return _conv(g, p, x, groups=c, act=act)


def _split2(g: _G, x: str, c: int, axis: int = 1) -> Tuple[str, str]:
    sp = g.init("split", np.asarray([c, c], np.int64))
    return tuple(g.n("Split", [x, sp], n_out=2, axis=axis))


def _bottleneck(g: _G, p, x: str, shortcut: bool, c_in: int,
                c_out: int) -> str:
    y = _conv(g, p["cv2"], _conv(g, p["cv1"], x))
    if shortcut and c_in == c_out:
        y = g.n("Add", [x, y])
    return y


def _c3k(g: _G, p, x: str, c: int) -> str:
    y1 = _conv(g, p["cv1"], x)
    for bp in p["m"]:
        y1 = _bottleneck(g, bp, y1, True, c, c)
    y2 = _conv(g, p["cv2"], x)
    return _conv(g, p["cv3"], g.n("Concat", [y1, y2], axis=1))


def _c3k2(g: _G, p, x: str, shortcut: bool = True) -> str:
    """Emits C3k2 and (structurally identical) v8 C2f blocks; shortcut
    False for v8 neck blocks (yolov8.yaml head C2f(..., False))."""
    is_c3k = "cv3" in p["m"][0]
    c = np.asarray(p["cv1"]["w"]).shape[-1] // 2
    y = _conv(g, p["cv1"], x)
    a, b = _split2(g, y, c)
    outs = [a, b]
    cur = b
    for bp in p["m"]:
        cur = (_c3k(g, bp, cur, c) if is_c3k
               else _bottleneck(g, bp, cur, shortcut, c, c))
        outs.append(cur)
    return _conv(g, p["cv2"], g.n("Concat", outs, axis=1))


def _sppf(g: _G, p, x: str, k: int = 5) -> str:
    y = _conv(g, p["cv1"], x)
    mp = dict(kernel_shape=[k, k], strides=[1, 1], pads=[k // 2] * 4)
    y1 = g.n("MaxPool", [y], **mp)
    y2 = g.n("MaxPool", [y1], **mp)
    y3 = g.n("MaxPool", [y2], **mp)
    return _conv(g, p["cv2"], g.n("Concat", [y, y1, y2, y3], axis=1))


def _attention(g: _G, p, x: str, c: int, hw: Tuple[int, int]) -> str:
    nh = max(1, c // 64)
    hd = c // nh
    h_total = np.asarray(p["qkv"]["w"]).shape[-1]
    kd = (h_total - c) // (2 * nh)
    H, W = hw
    N = H * W
    qkv = _conv(g, p["qkv"], x, act=False)                 # [B,h,H,W]
    qkv = g.n("Reshape", [qkv, g.init(
        "shape", np.asarray([1, nh, kd * 2 + hd, N], np.int64))])
    sp = g.init("split", np.asarray([kd, kd, hd], np.int64))
    q, k, v = g.n("Split", [qkv, sp], n_out=3, axis=2)     # [B,nh,*,N]
    qt = g.n("Transpose", [q], perm=[0, 1, 3, 2])          # [B,nh,N,kd]
    attn = g.n("MatMul", [qt, k])                          # [B,nh,N,N]
    attn = g.n("Mul", [attn, g.init(
        "scale", np.asarray(kd ** -0.5, np.float32))])
    attn = g.n("Softmax", [attn], axis=3)
    at = g.n("Transpose", [attn], perm=[0, 1, 3, 2])
    o = g.n("MatMul", [v, at])                             # [B,nh,hd,N]
    o = g.n("Reshape", [o, g.init(
        "shape", np.asarray([1, c, H, W], np.int64))])
    vmap = g.n("Reshape", [v, g.init(
        "shape", np.asarray([1, c, H, W], np.int64))])
    o = g.n("Add", [o, _dwconv(g, p["pe"], vmap, c, act=False)])
    return _conv(g, p["proj"], o, act=False)


def _psablock(g: _G, p, x: str, c: int, hw: Tuple[int, int]) -> str:
    x = g.n("Add", [x, _attention(g, p["attn"], x, c, hw)])
    y = _conv(g, p["ffn1"], x)
    y = _conv(g, p["ffn2"], y, act=False)
    return g.n("Add", [x, y])


def _c2psa(g: _G, p, x: str, hw: Tuple[int, int]) -> str:
    c = np.asarray(p["cv1"]["w"]).shape[-1] // 2
    y = _conv(g, p["cv1"], x)
    a, b = _split2(g, y, c)
    for bp in p["m"]:
        b = _psablock(g, bp, b, c, hw)
    return _conv(g, p["cv2"], g.n("Concat", [a, b], axis=1))


def _upsample2x(g: _G, x: str) -> str:
    roi = g.init("roi", np.zeros(0, np.float32))
    scales = g.init("scales", np.asarray([1, 1, 2, 2], np.float32))
    return g.n("Resize", [x, roi, scales], mode="nearest",
               nearest_mode="floor",
               coordinate_transformation_mode="asymmetric")


def _proto(g: _G, p, x: str) -> str:
    y = _conv(g, p["cv1"], x)
    # ConvTranspose weights: [Cin, Cout, kH, kW]; ours up_w is [kH,kW,I,O]
    w = np.transpose(np.asarray(p["up_w"], np.float32), (2, 3, 0, 1))
    y = g.n("ConvTranspose", [y, g.init("up_w", w),
                              g.init("up_b", np.asarray(p["up_b"],
                                                        np.float32))],
            kernel_shape=[2, 2], strides=[2, 2])
    y = _conv(g, p["cv2"], y)
    return _conv(g, p["cv3"], y)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def export_onnx(params, cfg, path: str,
                class_names: Optional[Sequence[str]] = None) -> str:
    """Write an ultralytics-contract ONNX file for `params` (a YOLO11
    module, or its params_to_tree view) and `cfg`.

    class_names: embedded as the ultralytics `names` metadata_props
    entry (str of an {index: name} dict — what third-party tooling and
    the Unity-side label asset expect to find). Defaults to the COCO-80
    list when num_classes == 80, else "class_<i>".

    Input: images [1,3,H,W] float32 in [0,1]. Outputs by task:
      detect   output0 [1, 4+nc, A]
      segment  output0 [1, 4+nc+nm, A] + output1 [1, nm, H/4, W/4] —
               exactly the contract the reference's converter slices
               (IEModelEditorConverter.cs:48-65)
      pose     output0 [1, 4+nc+nk, A] (in-graph keypoint decode)
      obb      output0 [1, 4+nc+1, A] (in-graph dist2rbox, angle last)
      classify output0 [1, nc] softmax probabilities
    (Every task round-trips through io/onnx_loader.load_yolo11_onnx:
    the weighted-op order follows ordered_param_slots, classify's linear
    head rides the Gemm node.)
    """
    refuse_arch(cfg, "ONNX export")
    if isinstance(params, YOLO11):
        params = params_to_tree(params)
    Spec(cfg)                                  # validates cfg
    H, W = cfg.input_size
    g = _G()
    x0 = "images"

    # --- backbone (node order mirrors ordered_param_slots) ---
    x = _conv(g, params["b0"], x0, stride=2)
    x = _conv(g, params["b1"], x, stride=2)
    x = _c3k2(g, params["b2"], x)
    x = _conv(g, params["b3"], x, stride=2)
    x4 = _c3k2(g, params["b4"], x)
    x = _conv(g, params["b5"], x4, stride=2)
    x6 = _c3k2(g, params["b6"], x)
    x = _conv(g, params["b7"], x6, stride=2)
    x = _c3k2(g, params["b8"], x)
    if "b9" in params:                 # v8-cls drops SPPF
        x = _sppf(g, params["b9"], x)
    # v8 has no C2PSA; x10 is then the SPPF (or b8) output
    x10 = (_c2psa(g, params["b10"], x, (H // 32, W // 32))
           if "b10" in params else x)

    if cfg.task == "classify":
        # backbone -> Conv(1280) -> GlobalAveragePool -> Gemm -> Softmax:
        # output0 [1, nc] class probabilities (ultralytics classify export)
        h = params["cls_head"]
        y = _conv(g, h["conv"], x10)
        p = g.n("GlobalAveragePool", [y])
        f = g.n("Flatten", [p], axis=1)
        gm = g.n("Gemm", [f,
                          g.init("lin_w", np.asarray(h["lin_w"],
                                                     np.float32)),
                          g.init("lin_b", np.asarray(h["lin_b"],
                                                     np.float32))],
                 alpha=1.0, beta=1.0, transB=0)
        g.n("Softmax", [gm], axis=1, out_names=["output0"])
        return _write_model(g, cfg, path,
                            [_value_info("output0",
                                         (1, cfg.num_classes))],
                            class_names)

    # --- neck + heads, interleaved per reference graph order ---
    sc = getattr(cfg, "arch", "yolo11") != "yolov8"   # v8 neck: no residual
    u = _upsample2x(g, x10)
    x13 = _c3k2(g, params["h13"], g.n("Concat", [u, x6], axis=1), sc)
    u = _upsample2x(g, x13)
    x16 = _c3k2(g, params["h16"], g.n("Concat", [u, x4], axis=1), sc)

    nc, rm, nm = cfg.num_classes, cfg.reg_max, cfg.num_masks

    box_maps: List[Tuple[str, int]] = []   # (tensor, H*W)
    cls_maps: List[Tuple[str, int]] = []

    def emit_detect(i: int, f: str, hw: Tuple[int, int]):
        d2 = params["det"]["cv2"][i]
        b = _conv(g, d2["conv0"], f)
        b = _conv(g, d2["conv1"], b)
        box_maps.append((_conv(g, d2["out"], b, act=False), hw[0] * hw[1]))
        d3 = params["det"]["cv3"][i]
        if "dw0" in d3:          # v11: depthwise-separable cls branch
            ci = np.asarray(d3["dw0"]["w"]).shape[-1]
            c = _dwconv(g, d3["dw0"], f, ci)
            c = _conv(g, d3["pw0"], c)
            cj = np.asarray(d3["dw1"]["w"]).shape[-1]
            c = _dwconv(g, d3["dw1"], c, cj)
            c = _conv(g, d3["pw1"], c)
        else:                    # v8 legacy: two plain 3x3 convs
            c = _conv(g, d3["conv0"], f)
            c = _conv(g, d3["conv1"], c)
        cls_maps.append((_conv(g, d3["out"], c, act=False), hw[0] * hw[1]))

    emit_detect(0, x16, (H // 8, W // 8))
    d = _conv(g, params["h17"], x16, stride=2)
    x19 = _c3k2(g, params["h19"], g.n("Concat", [d, x13], axis=1), sc)
    emit_detect(1, x19, (H // 16, W // 16))
    d = _conv(g, params["h20"], x19, stride=2)
    x22 = _c3k2(g, params["h22"], g.n("Concat", [d, x10], axis=1), sc)
    emit_detect(2, x22, (H // 32, W // 32))

    # --- concat levels along anchors ---
    def flat(maps: List[Tuple[str, int]], c: int) -> str:
        parts = [g.n("Reshape", [t, g.init(
            "shape", np.asarray([1, c, n], np.int64))]) for t, n in maps]
        return g.n("Concat", parts, axis=2)

    box_cat = flat(box_maps, 4 * rm)                 # [1, 4*rm, A]
    cls_cat = flat(cls_maps, nc)                     # [1, nc, A]
    A = sum(n for _, n in box_maps)

    # --- in-graph DFL decode (ultralytics DFL module shape-for-shape) ---
    r = g.n("Reshape", [box_cat, g.init(
        "shape", np.asarray([1, 4, rm, A], np.int64))])
    r = g.n("Transpose", [r], perm=[0, 2, 1, 3])     # [1, rm, 4, A]
    r = g.n("Softmax", [r], axis=1)
    dfl_w = np.arange(rm, dtype=np.float32).reshape(1, rm, 1, 1)
    r = g.n("Conv", [r, g.init("dfl_w", dfl_w)],
            kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0])
    ltrb = g.n("Reshape", [r, g.init(
        "shape", np.asarray([1, 4, A], np.int64))])  # [1,4,A]

    anchors_np, strides_np = make_anchors(cfg.input_size)
    anchors = g.init("anchors",
                     np.ascontiguousarray(anchors_np.T[None]))  # [1,2,A]
    strides = g.init("strides",
                     np.ascontiguousarray(strides_np.T[None]))  # [1,1,A]
    sp = g.init("split", np.asarray([2, 2], np.int64))
    lt, rb = g.n("Split", [ltrb, sp], n_out=2, axis=1)
    x1y1 = g.n("Sub", [anchors, lt])
    x2y2 = g.n("Add", [anchors, rb])
    cxy = g.n("Mul", [g.n("Add", [x1y1, x2y2]),
                      g.init("half", np.asarray(0.5, np.float32))])
    wh = g.n("Sub", [x2y2, x1y1])
    boxes = g.n("Mul", [g.n("Concat", [cxy, wh], axis=1), strides])
    scores = g.n("Sigmoid", [cls_cat])

    outputs = []
    if cfg.task == "pose":
        # keypoint branch -> in-graph kpts decode:
        # xy = (raw*2 + anchor - 0.5) * stride, vis = sigmoid ->
        # output0 [1, 4+nc+nk, A] (ultralytics pose export contract)
        K, Dk = cfg.kpt_shape
        nk = K * Dk
        kpt_maps: List[Tuple[str, int]] = []
        for i, (f, hw) in enumerate(
                zip((x16, x19, x22),
                    ((H // 8, W // 8), (H // 16, W // 16),
                     (H // 32, W // 32)))):
            c4 = params["pose_cv4"][i]
            m = _conv(g, c4["conv0"], f)
            m = _conv(g, c4["conv1"], m)
            kpt_maps.append((_conv(g, c4["out"], m, act=False),
                             hw[0] * hw[1]))
        kf = flat(kpt_maps, nk)                          # [1, nk, A]
        kr = g.n("Reshape", [kf, g.init(
            "kshape", np.asarray([1, K, Dk, A], np.int64))])
        xy, v = g.n("Split", [kr, g.init(
            "ksplit", np.asarray([2, Dk - 2], np.int64))], n_out=2,
            axis=2)
        two = g.init("two", np.asarray(2.0, np.float32))
        anch_k = g.init("anch_k", np.ascontiguousarray(
            anchors_np.T[None, None]) - 0.5)             # [1,1,2,A]
        str_k = g.init("str_k", np.ascontiguousarray(
            strides_np.T[None, None]))                   # [1,1,1,A]
        xy = g.n("Mul", [g.n("Add", [g.n("Mul", [xy, two]), anch_k]),
                         str_k])
        v = g.n("Sigmoid", [v])
        kd = g.n("Concat", [xy, v], axis=2)              # [1,K,Dk,A]
        kpts = g.n("Reshape", [kd, g.init(
            "kflat", np.asarray([1, nk, A], np.int64))])
        g.n("Concat", [boxes, scores, kpts], axis=1, out_names=["output0"])
        outputs = [_value_info("output0", (1, 4 + nc + nk, A))]
    elif cfg.task == "obb":
        # angle branch -> (sigmoid-0.25)*pi; boxes via in-graph dist2rbox
        # -> output0 [1, 4+nc+1, A] (ultralytics obb export contract)
        ang_maps: List[Tuple[str, int]] = []
        for i, (f, hw) in enumerate(
                zip((x16, x19, x22),
                    ((H // 8, W // 8), (H // 16, W // 16),
                     (H // 32, W // 32)))):
            c4 = params["obb_cv4"][i]
            m = _conv(g, c4["conv0"], f)
            m = _conv(g, c4["conv1"], m)
            ang_maps.append((_conv(g, c4["out"], m, act=False),
                             hw[0] * hw[1]))
        af = flat(ang_maps, 1)                           # [1, 1, A]
        ang = g.n("Mul", [g.n("Sub", [g.n("Sigmoid", [af]),
                                      g.init("q", np.asarray(
                                          0.25, np.float32))]),
                          g.init("pi", np.asarray(np.pi, np.float32))])
        co, si = g.n("Cos", [ang]), g.n("Sin", [ang])
        off = g.n("Mul", [g.n("Sub", [rb, lt]),
                          g.init("half2", np.asarray(0.5, np.float32))])
        xf, yf = g.n("Split", [off, g.init(
            "osplit", np.asarray([1, 1], np.int64))], n_out=2, axis=1)
        rx = g.n("Sub", [g.n("Mul", [xf, co]), g.n("Mul", [yf, si])])
        ry = g.n("Add", [g.n("Mul", [xf, si]), g.n("Mul", [yf, co])])
        rxy = g.n("Add", [g.n("Concat", [rx, ry], axis=1), anchors])
        rwh = g.n("Add", [lt, rb])
        rboxes = g.n("Mul", [g.n("Concat", [rxy, rwh], axis=1), strides])
        g.n("Concat", [rboxes, scores, ang], axis=1, out_names=["output0"])
        outputs = [_value_info("output0", (1, 4 + nc + 1, A))]
    elif cfg.task == "segment":
        coef_maps: List[Tuple[str, int]] = []
        for i, (f, hw) in enumerate(
                zip((x16, x19, x22),
                    ((H // 8, W // 8), (H // 16, W // 16),
                     (H // 32, W // 32)))):
            c4 = params["seg_cv4"][i]
            m = _conv(g, c4["conv0"], f)
            m = _conv(g, c4["conv1"], m)
            coef_maps.append((_conv(g, c4["out"], m, act=False),
                              hw[0] * hw[1]))
        coefs = flat(coef_maps, nm)
        g.n("Concat", [boxes, scores, coefs], axis=1,
            out_names=["output0"])
        _proto_out = _proto(g, params["proto"], x16)
        # Identity to pin the output name
        g.n("Identity", [_proto_out], out_names=["output1"])
        outputs = [_value_info("output0", (1, 4 + nc + nm, A)),
                   _value_info("output1", (1, nm, H // 4, W // 4))]
    else:
        g.n("Concat", [boxes, scores], axis=1, out_names=["output0"])
        outputs = [_value_info("output0", (1, 4 + nc, A))]

    return _write_model(g, cfg, path, outputs, class_names)


def _write_model(g: _G, cfg, path: str, outputs: List[bytes],
                 class_names: Optional[Sequence[str]] = None) -> str:
    H, W = cfg.input_size
    graph = b"".join(_fb(1, n) for n in g.nodes)
    graph += _fs(2, f"xrseg_{getattr(cfg, 'arch', 'yolo11')}"
                    f"{cfg.scale}_{cfg.task}")
    graph += b"".join(_fb(5, t) for t in g.inits)
    graph += _fb(11, _value_info("images", (1, 3, H, W)))
    graph += b"".join(_fb(12, o) for o in outputs)

    model = _fv(1, 8)                        # ir_version
    model += _fs(2, "xrseg_tpu")             # producer
    model += _fb(8, _fs(1, "") + _fv(2, 13))  # opset 13
    model += _fb(7, graph)
    # metadata_props (field 14, StringStringEntryProto): the ultralytics
    # metadata vocabulary — third-party loaders read `names` for labels
    if class_names is None:
        if cfg.num_classes == 80:
            class_names = COCO_LABELS
        else:
            class_names = [f"class_{i}" for i in range(cfg.num_classes)]
    meta = {"task": cfg.task,
            "stride": "32",
            "batch": "1",
            "imgsz": str([H, W]),
            "names": str(dict(enumerate(class_names)))}
    if cfg.task == "pose":
        meta["kpt_shape"] = str(list(cfg.kpt_shape))
    for k, v in meta.items():
        model += _fb(14, _fs(1, k) + _fs(2, v))
    with open(path, "wb") as f:
        f.write(model)
    return path
