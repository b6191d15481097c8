"""Weight files, weight-only int8 storage and weight-storage precision
(counterpart of xrseg_tpu/io/weights.py), torch-only.

Checkpoints are npz files in the JAX package's flat-key layout, so a file
either package writes, the other reads: every leaf of the params pytree
under its "/"-joined path, conv weights HWIO under ".../w", biases under
".../b", the Proto's transposed-conv weight [kH,kW,I,O] under "up_w".
`params_to_tree` is the inverse of io/bridge.py (module -> pytree of
numpy arrays); `load_npz` goes back through io/bridge.params_from_jax.

quantize_int8 / dequantize_int8: per-output-channel symmetric weight-only
int8 over the pytree ({q: int8, scale: f32} nodes in place of "w" and
"up_w"), the same numpy arithmetic as the JAX package, so the two produce
the same bits. cast_params sets a module's weight-storage precision.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.io.bridge import params_from_jax
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models.yolo11 import YOLO11

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


# ---------------------------------------------------------------------------
# format-dispatching loader
# ---------------------------------------------------------------------------

def load_params_auto(path: str, cfg: ModelConfig):
    """Load a YOLO11 for `cfg` from a weights file by extension. Returns
    (model on the CPU, cfg). Only npz checkpoints are read by the port;
    {q, scale} nodes dequantize on load."""
    if path.endswith(".npz"):
        return load_npz(path, cfg), cfg
    kind = next((ext for ext in (".sentis", ".onnx", ".pt", ".pth")
                 if path.endswith(ext)), "an orbax checkpoint directory")
    raise NotImplementedError(
        f"loading {kind} ({path!r}) is not ported yet (ROADMAP queue 1, "
        "item 13: the port's own torch-only loaders); save the weights "
        "as .npz")
