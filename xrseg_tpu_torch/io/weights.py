"""Weight files, weight-only int8 storage and weight-storage precision
(counterpart of xrseg_tpu/io/weights.py), torch-only.

Checkpoints are npz files in the JAX package's flat-key layout, so a file
either package writes, the other reads: every leaf of the params pytree
under its "/"-joined path, conv weights HWIO under ".../w", biases under
".../b", the Proto's transposed-conv weight [kH,kW,I,O] under "up_w".
`params_to_tree` is the inverse of io/bridge.py (module -> pytree of
numpy arrays); `load_npz` goes back through io/bridge.params_from_jax.
`load_params_auto` also reads the reference's .sentis artifacts
(io/sentis), ultralytics .pt/.pth state dicts (io/torch_pt) and
ultralytics-contract .onnx exports (io/onnx_loader).

quantize_int8 / dequantize_int8: per-output-channel symmetric weight-only
int8 over the pytree ({q: int8, scale: f32} nodes in place of "w" and
"up_w"), the same numpy arithmetic as the JAX package, so the two produce
the same bits. cast_params sets a module's weight-storage precision.
"""
from __future__ import annotations

import copy
import math
import os
from typing import Any, Dict

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.io.onnx_loader import load_yolo11_onnx
from xrseg_tpu_torch.io.torch_pt import load_yolo11_pt
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.models.yolo11 import YOLO11, yolo11_for_state

Tree = Any

_SEP = "/"
# state-dict leaf -> (pytree leaf, permutation into the JAX layout): the
# inverse of io/bridge.py's table
_TO_JAX = {"weight": ("w", (2, 3, 1, 0)), "bias": ("b", None),
           "up_w": ("up_w", (2, 3, 0, 1)), "up_b": ("up_b", None),
           "lin_w": ("lin_w", None), "lin_b": ("lin_b", None)}


def params_to_tree(model: YOLO11) -> Tree:
    """A YOLO11 module -> the JAX package's params pytree (nested dicts and
    lists of float32 numpy arrays)."""
    flat = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        name, perm = _TO_JAX[leaf]
        a = t.detach().float().cpu().numpy()
        if perm is not None:
            a = a.transpose(perm)
        flat[_SEP.join(path + [name])] = np.ascontiguousarray(a)
    return unflatten_params(flat)


def flatten_params(params: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Pytree -> {"a/b/0/w": array} (the npz layout)."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}{_SEP}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{_SEP}{i}")
        else:
            out[path] = np.asarray(node)

    rec(params, prefix)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Tree:
    """Inverse of flatten_params: a dict whose keys are all digits becomes
    a list."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_npz(path: str, params) -> None:
    """Write a YOLO11 module (or a params pytree, quantized or not) as a
    flat-key npz in the JAX package's layout."""
    tree = params_to_tree(params) if isinstance(params, YOLO11) else params
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_params(tree))


def load_npz(path: str, cfg: ModelConfig) -> YOLO11:
    """An npz checkpoint (either package's) -> a YOLO11 for `cfg` on the
    CPU. {q, scale} nodes are dequantized first. The load is strict: a
    missing or extra parameter, or a wrong shape, raises."""
    with np.load(path) as z:
        tree = unflatten_params({k: z[k] for k in z.files})
    return params_from_jax(dequantize_int8(tree), cfg)


# ---------------------------------------------------------------------------
# int8 weight-only quantization
# ---------------------------------------------------------------------------

def quantize_int8(params: Tree) -> Tree:
    """Per-output-channel symmetric int8 for every 4-d "w"/"up_w" leaf of
    a pytree (a YOLO11 module is converted first). Biases and the classify
    head's 2-d lin_w stay float32.
    Returns a pytree with {q: int8, scale: f32} nodes in their place."""
    if isinstance(params, YOLO11):
        params = params_to_tree(params)

    def rec(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("w", "up_w") and np.ndim(v) == 4:
                    w = np.asarray(v, np.float32)
                    amax = np.abs(w).reshape(-1, w.shape[-1]).max(0)
                    scale = np.where(amax > 0, amax / 127.0,
                                     1.0).astype(np.float32)
                    q = np.clip(np.round(w / scale), -127,
                                127).astype(np.int8)
                    out[k] = {"q": q, "scale": scale}
                else:
                    out[k] = rec(v)
            return out
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node

    return rec(params)


def dequantize_int8(params: Tree, dtype=np.float32) -> Tree:
    """{q, scale} nodes -> q * scale in `dtype`; other leaves unchanged."""
    def rec(node):
        if isinstance(node, dict):
            if set(node.keys()) == {"q", "scale"}:
                return (np.asarray(node["q"]).astype(dtype)
                        * np.asarray(node["scale"]).astype(dtype))
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node

    return rec(params)


def quantized_size_bytes(params) -> int:
    """Bytes of every leaf of a pytree, or of every parameter of a
    module, as stored."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in params.parameters())
    return sum(int(a.nbytes) for a in flatten_params(params).values())


# ---------------------------------------------------------------------------
# weight-storage precision
# ---------------------------------------------------------------------------

def cast_params(model: YOLO11, dtype) -> YOLO11:
    """A copy of `model` with its weights stored in `dtype` ("float32" or
    "bfloat16"): the cast happens once here, not at every call.

    Every other float parameter (the biases, the classify head's lin_w and
    lin_b) is rounded to `dtype` as the JAX package's cast rounds every
    float leaf, but kept in float32 storage: the layers use them in
    float32, so the numbers are the JAX ones and need no cast at run time.
    A weight already in the compute dtype is used as it is (`Tensor.to`
    of the same dtype launches nothing)."""
    dt = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"params_dtype {dtype!r}: expected 'float32' or "
                         "'bfloat16'")
    out = copy.deepcopy(model)
    with torch.no_grad():
        for m in out.modules():
            for name, p in list(m.named_parameters(recurse=False)):
                if (isinstance(m, L.Conv) and name == "weight") or (
                        isinstance(m, L.Proto) and name == "up_w"):
                    setattr(m, name, torch.nn.Parameter(p.to(dt)))
                else:
                    p.copy_(p.to(dt).float())
    return out


# ---------------------------------------------------------------------------
# checkpoint/config agreement (over pytrees)
# ---------------------------------------------------------------------------

def donor_num_classes(params: Tree):
    """Class count a params pytree was built for (None if it has no
    head)."""
    if "det" in params:
        return int(np.shape(params["det"]["cv3"][0]["out"]["b"])[0])
    if "cls_head" in params:
        return int(np.shape(params["cls_head"]["lin_b"])[0])
    return None


def params_match_config(params: Tree, cfg: ModelConfig) -> bool:
    """True iff `params` already has the head `cfg` asks for (class count
    and task-specific branches)."""
    if donor_num_classes(params) != cfg.num_classes:
        return False
    task_keys = {"segment": ("proto", "seg_cv4"), "pose": ("pose_cv4",),
                 "obb": ("obb_cv4",), "classify": ("cls_head",),
                 "detect": ()}
    need = task_keys[cfg.task]
    if any(k not in params for k in need):
        return False
    if cfg.task == "detect" and "det" not in params:
        return False
    extras = {"proto", "seg_cv4", "pose_cv4", "obb_cv4", "cls_head"}
    if set(params) & (extras - set(need)):
        return False
    # the NMS-free branch must exist when asked for; a dual-head
    # checkpoint served with o2o=False is fine as it is
    if cfg.o2o and "det_o2o" not in params:
        return False
    return True


def maybe_seed_o2o(params: Tree, cfg: ModelConfig) -> Tree:
    """Warm-start the one-to-one branch from the detect head when cfg.o2o
    and the tree carries both (a loader that mapped a one-head artifact
    into the dual-head structure)."""
    if cfg.o2o and "det" in params and "det_o2o" in params:
        params["det_o2o"] = copy.deepcopy(params["det"])
    return params


def _tree_of(params) -> Tree:
    """A YOLO11, a nested pytree or a flat {"a/b/0/w": array} dict -> a
    nested pytree of numpy arrays."""
    if isinstance(params, YOLO11):
        return params_to_tree(params)
    if isinstance(params, dict) and any(_SEP in k for k in params):
        return unflatten_params(params)
    return params


def transfer_params(donor, new_cfg: ModelConfig,
                    gen: torch.Generator = None):
    """Head-surgery transfer (the JAX package's transfer_params): start a
    fresh `new_cfg` model from `gen` (init_params) and graft in every donor
    leaf whose shape matches (backbone, neck, box branch, task branches),
    reinitialising only what the new class count or task changes.

    When the class count changes, the donor's class-branch hidden stack
    (dw0, pw0, dw1, pw1) is kept at the donor's width and only the final
    1x1 class conv, det/cv3/{i}/out, is drawn anew, with the YOLO prior
    bias log(5 / nc / (640 / stride)^2). A new_cfg.o2o target whose donor
    has no one-to-one branch gets det_o2o seeded from the post-surgery det.
    YOLOv8 class branches (conv0, conv1, out; the JAX function raises a
    KeyError on them) keep what the shape-matching pass gives them.

    `donor`: a YOLO11 (on any device) or a params pytree, nested or flat
    ("a/b/0/w" keys), of numpy arrays: an npz read with unflatten_params,
    whose head need not fit any config (load_npz is strict, this is not).
    Returns (a YOLO11 for new_cfg on the CPU, report) with report =
    {"copied": n, "reinit": [...], "dropped": [...]} in the JAX package's
    flat "a/b/0/w" notation. The reinitialised numbers come from torch's
    generator and differ from JAX's."""
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    dtree = _tree_of(donor)
    dflat = flatten_params(dtree)
    nflat = flatten_params(params_to_tree(yolo11.init_params(gen, new_cfg)))
    out: Dict[str, np.ndarray] = {}
    copied, reinit = [], []
    for k, v in nflat.items():
        dv = dflat.get(k)
        if dv is not None and tuple(dv.shape) == tuple(v.shape):
            out[k] = np.asarray(dv, v.dtype)
            copied.append(k)
        else:
            out[k] = v
            reinit.append(k)
    dropped = [k for k in dflat if k not in nflat]
    tree = unflatten_params(out)

    # class-branch hidden-stack rescue: keep the donor's dw/pw stack at its
    # own width and draw only the final class conv
    nc = new_cfg.num_classes
    if "det" in dtree and "det" in tree \
            and donor_num_classes(dtree) != nc:
        s = yolo11.Spec(new_cfg)
        for i, dcv in enumerate(dtree["det"]["cv3"]):
            if "pw0" not in dcv or np.shape(dcv["pw0"]["w"])[2] \
                    != s.head_ch[i]:
                continue        # a v8 branch, or another scale at this level
            c3d = int(np.shape(dcv["pw1"]["w"])[-1])
            conv = L.HeadConv(c3d, nc)
            conv.reset_parameters(gen)
            branch = {kk: {leaf: np.asarray(a, np.float32)
                           for leaf, a in dcv[kk].items()}
                      for kk in ("dw0", "pw0", "dw1", "pw1")}
            branch["out"] = {
                "w": np.ascontiguousarray(
                    conv.weight.detach().permute(2, 3, 1, 0).numpy()),
                "b": np.full((nc,), math.log(
                    5 / nc / (640 / s.strides[i]) ** 2), np.float32)}
            tree["det"]["cv3"][i] = branch
            pre = f"det/cv3/{i}/"
            rescued = [k for k in reinit
                       if k.startswith(pre) and not k.startswith(pre + "out")]
            copied.extend(rescued)
            reinit = [k for k in reinit if k not in rescued]

    # o2o warm start from the (post-surgery) one-to-many head
    if new_cfg.o2o and "det_o2o" in tree and "det_o2o" not in dtree:
        tree["det_o2o"] = copy.deepcopy(tree["det"])
        copied.extend(k for k in reinit if k.startswith("det_o2o/"))
        reinit = [k for k in reinit if not k.startswith("det_o2o/")]

    model = params_from_jax(tree, new_cfg)
    return model, {"copied": len(copied), "reinit": sorted(reinit),
                   "dropped": sorted(dropped)}


def with_config(model: YOLO11, cfg: ModelConfig) -> YOLO11:
    """`model`'s weights under another config of the same network (another
    input_size, dtype or precision): `model` itself when its config is
    `cfg`, else a new YOLO11 on the CPU (build_pipeline binds a module to
    the config it was built for)."""
    if model.cfg == cfg:
        return model
    return yolo11_for_state(cfg, {k: v.detach().float().cpu()
                                  for k, v in model.state_dict().items()})


def load_for_config(path: str, cfg: ModelConfig, donor_cfg: ModelConfig):
    """Weights from `path` as a start for training `cfg` (the training
    scripts' --weights): loaded as they are when their head fits cfg,
    transferred (transfer_params) when it does not. An .npz is read as a
    tree, whatever head it holds; an .onnx, .pt or .sentis whose head does
    not load under `cfg` (the loaders' ValueError, as the JAX scripts
    catch it) is loaded under `donor_cfg`, and any other load error
    propagates. Returns (YOLO11 on the CPU, cfg, report or None); cfg is
    the file's own for an .onnx or .pt whose head fits."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            donor = dequantize_int8(unflatten_params(
                {k: z[k] for k in z.files}))
        if params_match_config(donor, cfg):
            return params_from_jax(donor, cfg), cfg, None
    else:
        try:
            model, got = load_params_auto(path, cfg)
            cfg = got if got is not None else cfg
        except ValueError:
            model, _ = load_params_auto(path, donor_cfg)
        donor = params_to_tree(model)
        if params_match_config(donor, cfg):
            return with_config(model, cfg), cfg, None
    model, report = transfer_params(donor, cfg)
    return model, cfg, report


# ---------------------------------------------------------------------------
# format-dispatching loader
# ---------------------------------------------------------------------------

def load_params_auto(path: str, cfg: ModelConfig = None):
    """Load a YOLO11 from a weights file by extension, as the JAX package's
    load_params_auto dispatches: .sentis (the reference's deployed uint8
    artifact: io/sentis), .pt/.pth (an ultralytics state dict, BN fused on
    load: io/torch_pt), .onnx (an ultralytics-contract export:
    io/onnx_loader) and .npz (either package's flat checkpoint; {q, scale}
    nodes dequantize on load). Returns (model on the CPU, cfg): .pt infers
    the config when `cfg` is None, .sentis, .onnx and .npz default to
    ModelConfig().

    Orbax checkpoint directories stay refused (ROADMAP item 13b, a
    standing refusal): orbax writes tensorstore's OCDBT layout, a B-tree of
    zstd-compressed files, and no machine the port runs on has orbax,
    tensorstore or a zstd decoder. Convert one to .npz with the JAX
    package (xrseg_tpu.io.weights.save_npz) and load that."""
    if path.endswith(".sentis"):
        from xrseg_tpu_torch.io.sentis import load_yolo11_params
        return load_yolo11_params(path, cfg)
    if path.endswith((".pt", ".pth")):
        return load_yolo11_pt(path, cfg)
    if path.endswith(".onnx"):
        return load_yolo11_onnx(path, cfg)
    cfg = cfg if cfg is not None else ModelConfig()
    if path.endswith(".npz"):
        return load_npz(path, cfg), cfg
    raise NotImplementedError(
        f"loading an orbax checkpoint directory ({path!r}) is refused "
        "(ROADMAP item 13b, a standing refusal: orbax writes tensorstore's "
        "OCDBT layout of zstd-compressed files, and neither orbax, "
        "tensorstore nor a zstd decoder is on the machines the port runs "
        "on); convert it to .npz with the JAX package's "
        "xrseg_tpu.io.weights.save_npz and load that")
