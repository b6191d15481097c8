"""Ultralytics torch checkpoint (.pt) importer (counterpart of
xrseg_tpu/io/torch_pt.py).

An ultralytics YOLO11/YOLOv8 training checkpoint is an un-fused conv+BN
state dict keyed by module name. `ultralytics_slots` gives, for every
conv-like slot of the port's model, the ultralytics module prefix it
corresponds to (`model.2.m.0.cv1` etc.); the port's modules carry the JAX
package's names (models/layers.py), so a slot is also the port's
state-dict prefix. Each Conv's BatchNorm is fused analytically into the
weights (the port's model is the deploy form, folded BN):

    scale = gamma / sqrt(running_var + eps)
    w_fused[o,...] = w[o,...] * scale[o]
    b_fused[o]     = beta[o] - running_mean[o] * scale[o]

(eps 1e-3: ultralytics builds nn.BatchNorm2d(c2, eps=1e-3), not torch's
1e-5). The arithmetic is the JAX package's numpy float32, so both loaders
give the same bits. Already-fused checkpoints (after ultralytics
`model.fuse()`: conv.bias present, bn.* gone) load too.

Accepted file contents (torch.load(weights_only=True)):
  - a plain state dict, the recommended form:
    `torch.save(YOLO('yolo11n-seg.pt').model.state_dict(), 'sd.pt')`
  - a dict wrapping one under 'model' / 'ema' / 'state_dict'.
Full ultralytics checkpoints pickle the nn.Module and need the ultralytics
package to unpickle; they are refused with the one-liner above. Key
prefixes ('model.', 'model.model.', 'module.') are stripped; every key
must be consumed exactly once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.models.yolo11 import (YOLO11, YOLO11_SCALES,
                                           YOLOV8_SCALES, Spec,
                                           make_divisible, refuse_arch)

# ultralytics nn.BatchNorm2d eps (modules/conv.py Conv.__init__)
ULTRALYTICS_BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# name map: the port's module paths <-> ultralytics module prefixes
# ---------------------------------------------------------------------------

def ultralytics_slots(cfg: ModelConfig) -> List[Tuple[Tuple, str, str]]:
    """(path, ultralytics_prefix, kind) for every weighted slot; `path` is
    the port's module path (its state-dict prefix split at the dots).

    kind: 'conv'   ultralytics Conv module  ({p}.conv.weight + {p}.bn.*)
          'plain'  bare nn.Conv2d           ({p}.weight / {p}.bias)
          'convt'  nn.ConvTranspose2d       (Proto.upsample)
          'linear' nn.Linear                (Classify head)
          'dfl'    the fixed arange conv    (validated, not loaded)

    Module indices follow the ultralytics yolo11*/yolov8* yamls."""
    refuse_arch(cfg, "the ultralytics .pt mapping")
    s = Spec(cfg)
    v8 = s.arch == "yolov8"
    out: List[Tuple[Tuple, str, str]] = []

    def conv(path, ul):
        out.append((tuple(path), ul, "conv"))

    def plain(path, ul):
        out.append((tuple(path), ul, "plain"))

    def bottleneck(p, ul):
        conv(p + ("cv1",), f"{ul}.cv1")
        conv(p + ("cv2",), f"{ul}.cv2")

    def c3k(p, ul):
        conv(p + ("cv1",), f"{ul}.cv1")
        conv(p + ("cv2",), f"{ul}.cv2")
        conv(p + ("cv3",), f"{ul}.cv3")
        for j in range(2):
            bottleneck(p + ("m", j), f"{ul}.m.{j}")

    def csp(name, idx, n, is_c3k):
        """C3k2 (v11) / C2f (v8): the same key names either way."""
        conv((name, "cv1"), f"{idx}.cv1")
        conv((name, "cv2"), f"{idx}.cv2")
        for i in range(n):
            if is_c3k:
                c3k((name, "m", i), f"{idx}.m.{i}")
            else:
                bottleneck((name, "m", i), f"{idx}.m.{i}")

    # --- backbone ---
    conv(("b0",), "0")
    conv(("b1",), "1")
    if v8:
        csp("b2", 2, s.n3, False)
        conv(("b3",), "3")
        csp("b4", 4, s.n6, False)
        conv(("b5",), "5")
        csp("b6", 6, s.n6, False)
        conv(("b7",), "7")
        csp("b8", 8, s.n3, False)
    else:
        fc = s.force_c3k
        csp("b2", 2, s.n2, fc)
        conv(("b3",), "3")
        csp("b4", 4, s.n2, fc)
        conv(("b5",), "5")
        csp("b6", 6, s.n2, True)
        conv(("b7",), "7")
        csp("b8", 8, s.n2, True)

    if cfg.task == "classify":
        if v8:
            head = 9          # yolov8-cls: no SPPF, the head is module 9
        else:
            conv(("b9", "cv1"), "9.cv1")
            conv(("b9", "cv2"), "9.cv2")
            _c2psa(conv, s, 10)
            head = 11
        conv(("cls_head", "conv"), f"{head}.conv")
        out.append((("cls_head",), f"{head}.linear", "linear"))
        return out

    conv(("b9", "cv1"), "9.cv1")
    conv(("b9", "cv2"), "9.cv2")
    if v8:
        # v8 module indices: Upsample 10, Concat 11, C2f 12, Upsample 13,
        # Concat 14, C2f 15, Conv 16, Concat 17, C2f 18, Conv 19,
        # Concat 20, C2f 21, head 22
        csp("h13", 12, s.n3, False)
        csp("h16", 15, s.n3, False)
        conv(("h17",), "16")
        csp("h19", 18, s.n3, False)
        conv(("h20",), "19")
        csp("h22", 21, s.n3, False)
        head = 22
    else:
        _c2psa(conv, s, 10)
        fc = s.force_c3k
        csp("h13", 13, s.n2, fc)
        csp("h16", 16, s.n2, fc)
        conv(("h17",), "17")
        csp("h19", 19, s.n2, fc)
        conv(("h20",), "20")
        csp("h22", 22, s.n2, True)
        head = 23

    # --- detect head ---
    for i in range(3):
        conv(("det", "cv2", i, "conv0"), f"{head}.cv2.{i}.0")
        conv(("det", "cv2", i, "conv1"), f"{head}.cv2.{i}.1")
        plain(("det", "cv2", i, "out"), f"{head}.cv2.{i}.2")
        if v8:
            conv(("det", "cv3", i, "conv0"), f"{head}.cv3.{i}.0")
            conv(("det", "cv3", i, "conv1"), f"{head}.cv3.{i}.1")
        else:
            # v11 depthwise-separable cls branch:
            # Sequential(Sequential(DWConv, Conv), Sequential(DWConv, Conv),
            # Conv2d)
            conv(("det", "cv3", i, "dw0"), f"{head}.cv3.{i}.0.0")
            conv(("det", "cv3", i, "pw0"), f"{head}.cv3.{i}.0.1")
            conv(("det", "cv3", i, "dw1"), f"{head}.cv3.{i}.1.0")
            conv(("det", "cv3", i, "pw1"), f"{head}.cv3.{i}.1.1")
        plain(("det", "cv3", i, "out"), f"{head}.cv3.{i}.2")
    out.append(((), f"{head}.dfl.conv", "dfl"))

    # --- task tails ---
    def branch3(tree):
        for i in range(3):
            conv((tree, i, "conv0"), f"{head}.cv4.{i}.0")
            conv((tree, i, "conv1"), f"{head}.cv4.{i}.1")
            plain((tree, i, "out"), f"{head}.cv4.{i}.2")

    if cfg.task == "segment":
        branch3("seg_cv4")
        conv(("proto", "cv1"), f"{head}.proto.cv1")
        out.append((("proto",), f"{head}.proto.upsample", "convt"))
        conv(("proto", "cv2"), f"{head}.proto.cv2")
        conv(("proto", "cv3"), f"{head}.proto.cv3")
    elif cfg.task == "pose":
        branch3("pose_cv4")
    elif cfg.task == "obb":
        branch3("obb_cv4")
    return out


def _c2psa(conv, s: Spec, idx: int) -> None:
    conv(("b10", "cv1"), f"{idx}.cv1")
    for i in range(s.n2):
        conv(("b10", "m", i, "attn", "qkv"), f"{idx}.m.{i}.attn.qkv")
        conv(("b10", "m", i, "attn", "proj"), f"{idx}.m.{i}.attn.proj")
        conv(("b10", "m", i, "attn", "pe"), f"{idx}.m.{i}.attn.pe")
        conv(("b10", "m", i, "ffn1"), f"{idx}.m.{i}.ffn.0")
        conv(("b10", "m", i, "ffn2"), f"{idx}.m.{i}.ffn.1")
    conv(("b10", "cv2"), f"{idx}.cv2")


# ---------------------------------------------------------------------------
# BN fuse
# ---------------------------------------------------------------------------

def fuse_conv_bn(w: np.ndarray, gamma: np.ndarray, beta: np.ndarray,
                 mean: np.ndarray, var: np.ndarray,
                 eps: float = ULTRALYTICS_BN_EPS
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold BatchNorm stats into a (bias-free) conv weight [O,I,kh,kw]; the
    function of torch.nn.utils.fusion.fuse_conv_bn_weights with
    conv_b=None."""
    scale = gamma / np.sqrt(var + eps)
    return w * scale[:, None, None, None], beta - mean * scale


# ---------------------------------------------------------------------------
# state-dict normalization + config inference
# ---------------------------------------------------------------------------

def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def normalize_state_dict(obj: Any) -> Dict[str, Any]:
    """Unwrap checkpoint containers and strip module-path prefixes until
    keys start with the layer index ('0.conv.weight', ...)."""
    if not isinstance(obj, dict):
        raise ValueError(
            "checkpoint did not load as a dict — full ultralytics "
            "checkpoints pickle the model object and need the ultralytics "
            "package to unpickle. Save a plain state dict instead:\n"
            "  torch.save(YOLO('x.pt').model.state_dict(), 'sd.pt')")
    for k in ("state_dict", "ema", "model"):
        inner = obj.get(k)
        if isinstance(inner, dict) and inner and all(
                hasattr(v, "shape") for v in inner.values()):
            obj = inner
            break
    if not obj or not all(hasattr(v, "shape") for v in obj.values()):
        bad = [k for k, v in obj.items() if not hasattr(v, "shape")]
        raise ValueError(
            f"not a tensor state dict (non-tensor entries: {bad[:5]}) — "
            "save one with torch.save(model.state_dict(), path)")
    sd = dict(obj)
    # strip any leading non-numeric qualifiers ('model.', 'module.', ...)
    for _ in range(4):
        if any(k.split(".", 1)[0].isdigit() for k in sd):
            break
        sd = {k.split(".", 1)[1]: v for k, v in sd.items() if "." in k}
    if not any(k.split(".", 1)[0].isdigit() for k in sd):
        raise ValueError("no layer-indexed keys found ('0.conv.weight', "
                         "...); is this an ultralytics state dict?")
    return sd


def infer_pt_config(sd: Dict[str, Any], base_cfg: ModelConfig = None
                    ) -> ModelConfig:
    """Infer (arch, scale, task, nc, ...) from state-dict structure.

    Fields not derivable from shapes (input_size, thresholds, dtype...)
    come from `base_cfg` (default ModelConfig())."""
    head = max(int(k.split(".", 1)[0]) for k in sd
               if k.split(".", 1)[0].isdigit())
    arch = "yolo11" if any(".attn.qkv." in k for k in sd) else "yolov8"

    if f"{head}.linear.weight" in sd:
        task = "classify"
        nc = int(sd[f"{head}.linear.weight"].shape[0])
    elif any(k.startswith(f"{head}.proto.") for k in sd):
        task, nc = "segment", int(sd[f"{head}.cv3.0.2.weight"].shape[0])
    elif f"{head}.cv4.0.2.weight" in sd:
        cout = int(sd[f"{head}.cv4.0.2.weight"].shape[0])
        task = "obb" if cout == 1 else "pose"
        nc = int(sd[f"{head}.cv3.0.2.weight"].shape[0])
    else:
        task, nc = "detect", int(sd[f"{head}.cv3.0.2.weight"].shape[0])

    # scale: match stem width + block-2 repeat count against the ladder
    c64 = int(sd["0.conv.weight"].shape[0])
    reps = [int(k.split(".")[2]) for k in sd if k.startswith("2.m.")]
    n_rep = 1 + max(reps)
    table = YOLO11_SCALES if arch == "yolo11" else YOLOV8_SCALES
    scale = None
    for sc, (depth, width, max_ch) in table.items():
        want_rep = max(round((2 if arch == "yolo11" else 3) * depth), 1)
        if make_divisible(min(64, max_ch) * width, 8) == c64 \
                and want_rep == n_rep:
            scale = sc
            break
    if scale is None:
        raise ValueError(
            f"cannot match stem width {c64} / block-2 repeats {n_rep} to "
            f"any {arch} scale")

    kw: Dict[str, Any] = dict(arch=arch, scale=scale, task=task,
                              num_classes=nc)
    if task in ("detect", "segment", "pose", "obb"):
        kw["reg_max"] = int(sd[f"{head}.cv2.0.2.weight"].shape[0]) // 4
    if task == "segment":
        kw["num_masks"] = int(sd[f"{head}.proto.cv3.conv.weight"].shape[0])
    if task == "pose":
        nk = int(sd[f"{head}.cv4.0.2.weight"].shape[0])
        kw["kpt_shape"] = (nk // 3, 3) if nk % 3 == 0 else (nk // 2, 2)
    base = base_cfg if base_cfg is not None else ModelConfig()
    return dataclasses.replace(base, **kw)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def seed_o2o(state: Dict[str, torch.Tensor], cfg: ModelConfig) -> None:
    """The one-to-one branch warm-started from the detect head (io/weights
    maybe_seed_o2o, on a state dict): a loader of one-head artifacts fills
    det only."""
    if cfg.o2o:
        for k in [k for k in state if k.startswith("det.")]:
            state["det_o2o" + k[3:]] = state[k].clone()


def load_state(model: YOLO11, state: Dict[str, torch.Tensor]) -> YOLO11:
    """Load `state` strictly, with a clear error for a wrong shape."""
    own = model.state_dict()
    for k, v in state.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(own[k].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
    model.load_state_dict(state, strict=True)
    return model


def load_from_state_dict(sd: Dict[str, Any], cfg: ModelConfig,
                         bn_eps: float = ULTRALYTICS_BN_EPS,
                         strict: bool = True) -> YOLO11:
    """Map a normalized ultralytics state dict onto a YOLO11 for `cfg` (on
    the CPU)."""
    used = set()
    state: Dict[str, torch.Tensor] = {}

    def get(k: str) -> np.ndarray:
        if k not in sd:
            raise KeyError(
                f"state dict is missing '{k}' — architecture mismatch? "
                f"(cfg: {cfg.arch}/{cfg.scale}/{cfg.task})")
        used.add(k)
        return _to_numpy(sd[k])

    def put(path, name, a) -> None:
        key = ".".join([str(p) for p in path] + [name])
        state[key] = torch.tensor(np.asarray(a, np.float32))

    for path, ul, kind in ultralytics_slots(cfg):
        if kind == "conv":
            w = get(f"{ul}.conv.weight")
            if f"{ul}.bn.weight" in sd:
                w, b = fuse_conv_bn(
                    w, get(f"{ul}.bn.weight"), get(f"{ul}.bn.bias"),
                    get(f"{ul}.bn.running_mean"),
                    get(f"{ul}.bn.running_var"), bn_eps)
                used.add(f"{ul}.bn.num_batches_tracked")
            elif f"{ul}.conv.bias" in sd:     # already-fused checkpoint
                b = get(f"{ul}.conv.bias")
            else:
                b = np.zeros((w.shape[0],), np.float32)
            put(path, "weight", w)
            put(path, "bias", b)
        elif kind == "plain":
            put(path, "weight", get(f"{ul}.weight"))
            put(path, "bias", get(f"{ul}.bias"))
        elif kind == "convt":
            put(path, "up_w", get(f"{ul}.weight"))     # [I, O, kH, kW]
            put(path, "up_b", get(f"{ul}.bias"))
        elif kind == "linear":
            put(path, "lin_w", get(f"{ul}.weight").T)  # [hidden, nc]
            put(path, "lin_b", get(f"{ul}.bias"))
        elif kind == "dfl":
            k = f"{ul}.weight"
            if k in sd:                       # validate the fixed arange
                got = _to_numpy(sd[k]).reshape(-1)
                used.add(k)
                if not np.allclose(got, np.arange(cfg.reg_max), atol=0.5):
                    raise ValueError(
                        f"unexpected DFL conv weights: {got[:8]}...")

    if strict:
        leftovers = [k for k in sd if k not in used
                     and not k.endswith(".num_batches_tracked")]
        if leftovers:
            raise ValueError(
                f"{len(leftovers)} unconsumed state-dict keys (first 8: "
                f"{sorted(leftovers)[:8]}) — architecture mismatch between "
                f"checkpoint and cfg ({cfg.arch}/{cfg.scale}/{cfg.task})")
    seed_o2o(state, cfg)
    return load_state(YOLO11(cfg), state)


def load_yolo11_pt(path: str, cfg: ModelConfig = None
                   ) -> Tuple[YOLO11, ModelConfig]:
    """Load an ultralytics .pt checkpoint (state-dict form) into a YOLO11
    on the CPU. Returns (model, cfg); cfg (arch/scale/task/nc/...) is
    inferred from the state dict when not given."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:                    # pickled nn.Module inside
        raise ValueError(
            f"cannot load {path} with weights_only=True ({e}). Full "
            "ultralytics checkpoints pickle the model object; extract the "
            "state dict where ultralytics is installed:\n"
            "  torch.save(YOLO('x.pt').model.state_dict(), 'sd.pt')")
    sd = normalize_state_dict(obj)
    if cfg is None:
        cfg = infer_pt_config(sd)
    return load_from_state_dict(sd, cfg), cfg
