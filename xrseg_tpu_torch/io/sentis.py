"""Reader and writer of Unity Inference Engine (Sentis 2.x) `.sentis` model
files (counterpart of xrseg_tpu/io/sentis.py), torch and numpy only.

The reference ships its network as a compiled, uint8-weight-quantized
`.sentis` artifact (yolo11n-seg-sentis.sentis). This module parses that
format directly, maps its weights onto the port's YOLO11, and writes
trained weights back into a copy of an artifact, so the port runs the
same weights the headset runs and its training reaches the headset.

Format (an ExecuTorch-style program flatbuffer):
  [u32 size][flatbuffer Program][constant data segment]
  Program        { f0: version, f1: ExecutionPlan, f3: [DataSegment] }
  ExecutionPlan  { f0: name, f1: [EValue], f2: inputs, f4: outputs,
                   f6: [Chain], f7: [Operator] }
  EValue union   { 2: Int, 3: Float, 4: String, 6: Tensor, 8: IntList }
  Tensor         { f0: dtype(ubyte), f1: nbytes, f2: shape[i32],
                   f3: const flag, f4: segment byte offset }
  Chain          { f0: input value ids, f1: output value ids,
                   f2: [Instruction{ KernelCall{ f0: op idx, f1: arg ids }}] }

Quantized weights are DequantizeUint8 chains: w = (u8 - zero_point) * scale.
The file's conv weights are OIHW and its ConvTranspose weight [I, O, kH,
kW], the port's own layouts, so no leaf is transposed either way.

    python -m xrseg_tpu_torch.io.sentis model.sentis

prints the program's summary and its weighted ops.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.bridge import state_dict_from_jax
from xrseg_tpu_torch.io.onnx_loader import ordered_param_slots
from xrseg_tpu_torch.io.torch_pt import load_state, seed_o2o
from xrseg_tpu_torch.io.weights import _tree_of
from xrseg_tpu_torch.models.yolo11 import YOLO11


@dataclasses.dataclass
class SentisTensor:
    dtype: int              # 0=float32, 1=int32, 3=uint8
    nbytes: int
    shape: Tuple[int, ...]
    const: bool
    offset: int             # byte offset into the constant segment


@dataclasses.dataclass
class SentisChain:
    inputs: List[int]
    outputs: List[int]
    op: str
    args: List[int]


@dataclasses.dataclass
class SentisProgram:
    version: int
    values: List[Tuple[int, Any]]    # (union_type, payload)
    chains: List[SentisChain]
    operators: List[str]
    ep_inputs: List[int]
    ep_outputs: List[int]
    segment: bytes
    # absolute file byte offset of each value's scalar payload (Float and
    # Int unions whose field is stored; None otherwise): the writer patches
    # quantization scale/zero-point there in place
    value_pos: Optional[List[Optional[int]]] = None
    # absolute file offset where the constant segment begins
    segment_base: int = 0

    def tensor(self, idx: int) -> SentisTensor:
        ty, payload = self.values[idx]
        if ty != 6:
            raise TypeError(f"value {idx} is union type {ty}, not Tensor")
        return payload

    def const_data(self, idx: int) -> np.ndarray:
        t = self.tensor(idx)
        if not t.const:
            raise ValueError(f"value {idx} is not a constant tensor")
        raw = self.segment[t.offset:t.offset + t.nbytes]
        if t.dtype == 3:
            arr = np.frombuffer(raw, np.uint8)
        elif t.dtype == 0:
            arr = np.frombuffer(raw, np.float32)
        elif t.dtype == 1:
            arr = np.frombuffer(raw, np.int32)
        else:
            raise ValueError(f"unhandled dtype {t.dtype}")
        return arr.reshape(t.shape) if t.shape else arr


class _FB:
    """Minimal flatbuffers reader."""

    def __init__(self, data: bytes):
        self.d = data

    def u8(self, o): return self.d[o]
    def u16(self, o): return struct.unpack_from("<H", self.d, o)[0]
    def u32(self, o): return struct.unpack_from("<I", self.d, o)[0]
    def i32(self, o): return struct.unpack_from("<i", self.d, o)[0]
    def f32(self, o): return struct.unpack_from("<f", self.d, o)[0]
    def ind(self, o): return o + self.u32(o)

    def fields(self, tpos: int) -> Dict[int, int]:
        """Field index -> absolute position, for the fields the table
        stores (its vtable's non-zero u16 offsets, relative to the
        table)."""
        vt = tpos - self.i32(tpos)
        n = (self.u16(vt) - 4) // 2
        out = {}
        for f in range(n):
            off = self.u16(vt + 4 + 2 * f)
            if off:
                out[f] = tpos + off
        return out

    def string(self, fpos: int) -> str:
        p = self.ind(fpos)
        n = self.u32(p)
        return self.d[p + 4:p + 4 + n].decode("utf8")

    def vec_i32(self, fpos: int) -> List[int]:
        p = self.ind(fpos)
        n = self.u32(p)
        return [self.i32(p + 4 + 4 * i) for i in range(n)]

    def vec_tables(self, fpos: int) -> List[int]:
        p = self.ind(fpos)
        n = self.u32(p)
        e0 = p + 4
        return [e0 + 4 * i + self.u32(e0 + 4 * i) for i in range(n)]


def parse_sentis(path: str) -> SentisProgram:
    with open(path, "rb") as f:
        data = f.read()
    fb = _FB(data)
    fb_size = fb.u32(0)
    root = 4 + fb.u32(4)
    rf = fb.fields(root)
    version = fb.u32(rf[0]) if 0 in rf else 0

    # constant segment: everything after the (aligned) flatbuffer region;
    # DataSegment {f0: offset (u64), f1: size (u64)}, its last stored
    # field read as the size
    seg_tables = fb.vec_tables(rf[3]) if 3 in rf else []
    seg_size = None
    if seg_tables:
        sff = fb.fields(seg_tables[0])
        seg_size = struct.unpack_from("<Q", data, sff[max(sff)])[0]
    if seg_size is None or seg_size > len(data):
        seg_size = len(data) - (4 + fb_size)
    segment = data[len(data) - seg_size:]

    ep = fb.ind(rf[1])
    epf = fb.fields(ep)
    operators = [fb.string(fb.fields(t)[0]) for t in fb.vec_tables(epf[7])]

    values: List[Tuple[int, Any]] = []
    value_pos: List[Optional[int]] = []
    for t in fb.vec_tables(epf[1]):
        ff = fb.fields(t)
        ty = fb.u8(ff[0]) if 0 in ff else 0
        payload: Any = None
        pos: Optional[int] = None
        if 1 in ff:
            vt = fb.ind(ff[1])
            vff = fb.fields(vt)
            if ty == 6:
                payload = SentisTensor(
                    dtype=fb.u8(vff[0]) if 0 in vff else 0,
                    nbytes=fb.u32(vff[1]) if 1 in vff else 0,
                    shape=tuple(fb.vec_i32(vff[2])) if 2 in vff else (),
                    const=bool(fb.u32(vff[3])) if 3 in vff else False,
                    offset=fb.u32(vff[4]) if 4 in vff else 0,
                )
            elif ty == 3:
                payload = fb.f32(vff[0]) if 0 in vff else 0.0
                pos = vff.get(0)
            elif ty == 2:
                payload = fb.i32(vff[0]) if 0 in vff else 0
                pos = vff.get(0)
            elif ty == 8:
                payload = fb.vec_i32(vff[0]) if 0 in vff else []
            elif ty == 4:
                payload = fb.string(vff[0]) if 0 in vff else ""
        values.append((ty, payload))
        value_pos.append(pos)

    chains: List[SentisChain] = []
    for t in fb.vec_tables(epf[6]):
        ff = fb.fields(t)
        ins = fb.vec_i32(ff[0]) if 0 in ff else []
        outs = fb.vec_i32(ff[1]) if 1 in ff else []
        op, args = operators[0], []
        if 2 in ff:
            for it in fb.vec_tables(ff[2]):
                itf = fb.fields(it)
                k = fb.ind(itf[1])
                kf = fb.fields(k)
                op_idx = fb.u32(kf[0]) if 0 in kf else 0   # default 0
                args = fb.vec_i32(kf[1]) if 1 in kf else []
                op = operators[op_idx]
        chains.append(SentisChain(ins, outs, op, args))

    return SentisProgram(
        version=version, values=values, chains=chains, operators=operators,
        ep_inputs=fb.vec_i32(epf[2]) if 2 in epf else [],
        ep_outputs=fb.vec_i32(epf[4]) if 4 in epf else [],
        segment=segment, value_pos=value_pos,
        segment_base=len(data) - len(segment),
    )


# ---------------------------------------------------------------------------
# constant extraction
# ---------------------------------------------------------------------------

def dequantized_constants(prog: SentisProgram) -> Dict[int, np.ndarray]:
    """value-id -> float32 array for every DequantizeUint8 output."""
    out: Dict[int, np.ndarray] = {}
    for ch in prog.chains:
        if ch.op != "DequantizeUint8" or not ch.inputs:
            continue
        q = prog.const_data(ch.inputs[0]).astype(np.float32)
        scale = float(prog.values[ch.args[0]][1])
        zp = float(prog.values[ch.args[1]][1])
        out[ch.outputs[0]] = (q - zp) * scale
    return out


WEIGHTED_OPS = ("Conv", "ConvTranspose")


def conv_sequence(prog: SentisProgram,
                  consts: Optional[Dict[int, np.ndarray]] = None
                  ) -> List[Dict[str, Any]]:
    """Ordered list of weighted ops with their dequantized weights/biases.

    Conv inputs are (x, W[OIHW], B[O]); ConvTranspose (x, W[IOHW], B[O]).
    """
    if consts is None:
        consts = dequantized_constants(prog)

    def fetch(idx: int) -> Optional[np.ndarray]:
        if idx in consts:
            return consts[idx]
        ty, payload = prog.values[idx]
        if ty == 6 and payload.const:
            return prog.const_data(idx).astype(np.float32)
        return None

    seq = []
    for ci, ch in enumerate(prog.chains):
        if ch.op not in WEIGHTED_OPS:
            continue
        w = fetch(ch.inputs[1]) if len(ch.inputs) > 1 else None
        b = fetch(ch.inputs[2]) if len(ch.inputs) > 2 else None
        if w is None:
            continue
        wshape = prog.tensor(ch.inputs[1]).shape
        seq.append({
            "chain": ci, "op": ch.op,
            "w": w.reshape(wshape), "b": b,
            "args": [prog.values[a][1] for a in ch.args if a >= 0],
        })
    return seq


def summarize(prog: SentisProgram) -> str:
    from collections import Counter
    hist = Counter(ch.op for ch in prog.chains)
    lines = [f"sentis program v{prog.version}: {len(prog.chains)} chains, "
             f"{len(prog.values)} values, segment {len(prog.segment)} B",
             f"inputs={prog.ep_inputs} outputs={prog.ep_outputs}",
             "ops: " + ", ".join(f"{k}x{v}" for k, v in hist.most_common())]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# YOLO11 param mapping
# ---------------------------------------------------------------------------

def _key(pathk, leaf: str) -> str:
    return ".".join([str(p) for p in pathk] + [leaf])


def load_yolo11_params(path: str, cfg: ModelConfig = None
                       ) -> Tuple[YOLO11, ModelConfig]:
    """Load a .sentis artifact into a YOLO11 on the CPU, by the ordered-slot
    mapping (io/onnx_loader.ordered_param_slots). Returns (model, cfg); cfg
    defaults to ModelConfig(scale="n"). The weights are the dequantized
    uint8 values, the numbers the reference runtime executes.

    The classify head's linear layer is a Gemm, which the format's
    weighted ops (Conv, ConvTranspose) do not hold: a classify template
    is refused with the count mismatch, as the JAX package refuses it."""
    if cfg is None:
        cfg = ModelConfig(scale="n")
    prog = parse_sentis(path)
    seq = conv_sequence(prog)
    slots = ordered_param_slots(cfg)
    if len(seq) != len(slots):
        raise ValueError(
            f"weighted-op count mismatch: file has {len(seq)}, model "
            f"({cfg.scale}, {cfg.task}) expects {len(slots)}")

    model = YOLO11(cfg)
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def put(key: str, a: np.ndarray, pathk, chain: int) -> None:
        if tuple(state[key].shape) != a.shape:
            raise ValueError(
                f"shape mismatch at {pathk}: model {tuple(state[key].shape)}"
                f" vs file {a.shape} (op chain {chain})")
        state[key] = torch.tensor(np.asarray(a, np.float32))

    for (pathk, kind), op in zip(slots, seq):
        w, b = op["w"], op["b"]
        if kind == "dfl":
            # the fixed arange(reg_max) conv: the decode computes it
            expect = np.arange(cfg.reg_max, dtype=np.float32)
            got = w.reshape(-1)
            if not np.allclose(got, expect, atol=0.5):
                raise ValueError(f"unexpected DFL conv weights: {got[:8]}...")
            continue
        if kind == "gemm":
            raise ValueError(
                f"a Conv at the classify head's linear slot {pathk} (op "
                f"chain {op['chain']}): the format holds no Gemm weights")
        names = (("up_w", "up_b") if kind == "convtranspose"
                 else ("weight", "bias"))
        put(_key(pathk, names[0]), w, pathk, op["chain"])
        if b is not None:
            put(_key(pathk, names[1]), b, pathk, op["chain"])
    seed_o2o(state, cfg)          # after the mapping, as maybe_seed_o2o
    return load_state(model, state), cfg


# ---------------------------------------------------------------------------
# Writer: weight transplant into the deployed artifact
# ---------------------------------------------------------------------------

def quantize_uint8(w: np.ndarray, method: str = "minmax"
                   ) -> Tuple[np.ndarray, float, int]:
    """Per-tensor affine uint8 quantization matching the artifact's
    DequantizeUint8 semantics (w ~ (q - zp) * scale). The range is forced
    to include 0 so the zero-point is exact and lands in [0, 255]. The
    numpy arithmetic on float32 arrays with a Python-float scale decides
    the bytes, as in the JAX package.

    method="minmax" (default): scale from the exact value range; the
    error is at most half a step. method="mse": search scales in
    [0.3, 1.0] x the minmax range and keep the least-squared-error fit
    (outlier tails saturate, the bulk gets finer steps)."""
    lo = min(float(w.min()), 0.0)
    hi = max(float(w.max()), 0.0)
    if hi == lo:
        return np.zeros(w.shape, np.uint8), 1.0, 0

    def fit(lo_c: float, hi_c: float):
        scale = (hi_c - lo_c) / 255.0
        zp = max(0, min(255, int(round(-lo_c / scale))))
        q = np.clip(np.rint(w / scale) + zp, 0, 255).astype(np.uint8)
        return q, scale, zp

    if method == "minmax":
        return fit(lo, hi)
    if method != "mse":
        raise ValueError(f"unknown quantization method {method!r}")
    best = None
    best_err = np.inf
    for frac in np.linspace(0.3, 1.0, 15):
        q, scale, zp = fit(lo * frac, hi * frac)
        err = float(np.mean(
            ((q.astype(np.float32) - zp) * scale - w) ** 2))
        if err < best_err:
            best, best_err = (q, scale, zp), err
    return best


def _state_of(params) -> Dict[str, np.ndarray]:
    """A YOLO11 (on any device) or a params pytree of numpy arrays (nested,
    or flat "a/b/0/w" keys) -> the port's state-dict layout as float32
    numpy arrays."""
    if isinstance(params, YOLO11):
        return {k: v.detach().cpu().float().numpy()
                for k, v in params.state_dict().items()}
    return {k: v.numpy() for k, v in
            state_dict_from_jax(_tree_of(params)).items()}


def write_yolo11_sentis(out_path: str, params, template_path: str,
                        cfg: ModelConfig = None,
                        quant_method: str = "minmax") -> None:
    """Write a YOLO11's weights into a `.sentis` artifact by transplanting
    them into a COPY of `template_path` (normally the reference's deployed
    model).

    `params`: a YOLO11 on any device, or a params pytree of numpy arrays.
    The flatbuffer program region stays as it was (same graph, tensor
    shapes and offsets), so the output is a drop-in replacement for the
    artifact the Unity runtime loads. Only the constant payloads change:
    each conv weight and bias is quantized per tensor to uint8 and written
    over the old bytes, and its scale and zero-point scalars are patched
    in place inside the flatbuffer (positions from parse_sentis). Float
    constants are overwritten as float32. Architecture changes (another
    scale, task or channel count) cannot transplant: export ONNX
    (io/onnx_export.py) and convert it in Unity instead."""
    if cfg is None:
        cfg = ModelConfig(scale="n")
    with open(template_path, "rb") as f:
        data = bytearray(f.read())
    prog = parse_sentis(template_path)
    slots = ordered_param_slots(cfg)
    weighted = [ch for ch in prog.chains if ch.op in WEIGHTED_OPS]
    if len(weighted) != len(slots):
        raise ValueError(
            f"template/model mismatch: template has {len(weighted)} "
            f"weighted ops, model ({cfg.scale}, {cfg.task}) expects "
            f"{len(slots)} — architecture changes need the ONNX path")

    # DequantizeUint8 output id -> (u8 tensor id, scale value id, zp id)
    dequant: Dict[int, Tuple[int, int, int]] = {}
    for ch in prog.chains:
        if ch.op == "DequantizeUint8" and ch.inputs and ch.outputs:
            dequant[ch.outputs[0]] = (ch.inputs[0], ch.args[0], ch.args[1])

    state = _state_of(params)

    def patch(value_id: int, arr: np.ndarray) -> None:
        """Overwrite constant `value_id` with `arr` (f32), re-quantizing
        when the template stores it as uint8."""
        arr = np.ascontiguousarray(arr, np.float32)
        if value_id in dequant:
            qid, sid, zid = dequant[value_id]
            t = prog.tensor(qid)
            spos, zpos = prog.value_pos[sid], prog.value_pos[zid]
            if spos is None:
                raise ValueError(
                    f"scale position unrecorded for value {value_id}")
            if zpos is None:
                # a zero-point stored as the flatbuffer default has no
                # bytes to patch: quantize with zp pinned to the template's
                # value; mass outside the representable range is an error,
                # not a silent clamp
                zp = int(prog.values[zid][1])
                lo, hi = float(arr.min()), float(arr.max())
                scale = max(hi / (255 - zp) if zp < 255 else 0.0,
                            lo / (0 - zp) if zp > 0 and lo < 0 else 0.0,
                            1e-12)
                q = np.clip(np.rint(arr / scale) + zp, 0, 255
                            ).astype(np.uint8)
                err = np.abs((q.astype(np.float32) - zp) * scale - arr)
                if err.max() > 3.0 * scale:
                    raise ValueError(
                        f"value {value_id}: new values exceed the "
                        f"template's fixed zero-point ({zp}) range "
                        f"(max clamp error {err.max():.4g} vs scale "
                        f"{scale:.4g}) — use the ONNX path")
            else:
                q, scale, zp = quantize_uint8(arr, quant_method)
                struct.pack_into("<i", data, zpos, zp)
            if q.nbytes != t.nbytes:
                raise ValueError(f"size mismatch at value {value_id}: "
                                 f"{q.nbytes} vs template {t.nbytes}")
            off = prog.segment_base + t.offset
            data[off:off + t.nbytes] = q.tobytes()
            struct.pack_into("<f", data, spos, scale)
            return
        t = prog.tensor(value_id)
        if t.dtype != 0:
            raise ValueError(f"value {value_id}: unexpected dtype {t.dtype}")
        if arr.nbytes != t.nbytes:
            raise ValueError(f"size mismatch at value {value_id}: "
                             f"{arr.nbytes} vs template {t.nbytes}")
        off = prog.segment_base + t.offset
        data[off:off + t.nbytes] = arr.tobytes()

    for (pathk, kind), ch in zip(slots, weighted):
        if kind == "dfl":
            continue                 # fixed arange conv: template keeps it
        names = (("up_w", "up_b") if kind == "convtranspose"
                 else ("weight", "bias"))
        patch(ch.inputs[1], state[_key(pathk, names[0])])
        bias = _key(pathk, names[1])
        if len(ch.inputs) > 2 and bias in state:
            patch(ch.inputs[2], state[bias])

    with open(out_path, "wb") as f:
        f.write(bytes(data))


def _main(argv: Optional[List[str]] = None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    prog = parse_sentis(argv[0])
    print(summarize(prog))
    seq = conv_sequence(prog)
    print(f"\n{len(seq)} weighted ops:")
    for i, c in enumerate(seq):
        b = "none" if c["b"] is None else c["b"].shape
        print(f"  [{i:3d}] chain {c['chain']:3d} {c['op']:14s} "
              f"w={c['w'].shape} b={b}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
