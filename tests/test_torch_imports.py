"""The port stands alone: xrseg_tpu_torch and chip_smoke.py import neither
JAX nor anything of the xrseg_tpu package, nor the root bench.py (which
imports JAX), and importing them touches no device. Checked twice: by
importing every module in a fresh interpreter and reading sys.modules,
and by scanning every import statement in the sources (which also
catches imports inside functions). And the port is
whole: every subpackage re-exports its JAX twin's names, and every public
function and class of a JAX module has a counterpart, or a listed reason
why not."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "xrseg_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    """JAX, the JAX package, and the root bench.py (which imports JAX)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "xrseg_tpu", "bench")


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_module_names()) + ["chip_smoke"]
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'xrseg_tpu', 'bench'))\n"
        "print('BAD', bad)\n"
        "print('CUDA_INIT', torch.cuda.is_initialized())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "CUDA_INIT False" in out.stdout, out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_reaches_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    """No card here: it exits non-zero and prints no result. Alone in a
    directory without the package: it fails to start at all."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "xrseg_tpu_torch" in out.stderr


# ---------------------------------------------------------------------------
# the subpackages re-export what their JAX twins do
# ---------------------------------------------------------------------------

SUBPACKAGES = ("io", "models", "ops", "parallel", "perception", "runtime",
               "train", "viz")
# JAX-only names with no counterpart in the port, each with its reason
NO_COUNTERPART = {
    # the port's network is a module: JAX's free forward(params, x, cfg)
    # is YOLO11.forward
    ("models", "forward"),
}


def _jax_exports(sub: str) -> set:
    """The names xrseg_tpu/<sub>/__init__.py binds, read from its source
    (importing it would load JAX)."""
    src = (ROOT / "xrseg_tpu" / sub / "__init__.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    import importlib
    pkg = importlib.import_module(f"xrseg_tpu_torch.{sub}")
    want = _jax_exports(sub) - {n for s, n in NO_COUNTERPART if s == sub}
    assert want, sub
    missing = sorted(n for n in want if not hasattr(pkg, n))
    assert not missing, f"xrseg_tpu_torch.{sub} lacks {missing}"


def test_named_imports_work():
    from xrseg_tpu_torch.models import init_params, make_anchors, model_info
    from xrseg_tpu_torch.runtime import CameraPermissions, Executor, XRLoop
    from xrseg_tpu_torch.train import distill, trainer
    assert all((init_params, make_anchors, model_info, CameraPermissions,
                Executor, XRLoop, distill, trainer))


# ---------------------------------------------------------------------------
# negative-stride numpy input (a mirrored frame) enters the port
# ---------------------------------------------------------------------------

def test_negative_stride_frame_equals_its_copy():
    """A frame mirrored with numpy (`img[:, ::-1]`, negative strides, which
    torch.tensor refuses) gives the slate of its contiguous copy, through
    the pipeline and through the train step."""
    import copy

    import numpy as np
    import torch
    from xrseg_tpu_torch.compile import build_pipeline
    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.testing import detection_params
    from xrseg_tpu_torch.train import train_step as ts

    cfg = ModelConfig(scale="n", num_classes=3, input_size=(64, 64),
                      dtype="float32", matmul_precision="highest")
    model = detection_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    pipe = build_pipeline(ExecutorConfig(model=cfg), model, frame_hw=(40, 56),
                          batch=2, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 40, 56, 3),
                                               np.uint8)
    flipped = frames[:, :, ::-1]
    assert any(s < 0 for s in flipped.strides)
    got = pipe(flipped)["slate"]
    want = pipe(np.ascontiguousarray(flipped))["slate"]
    assert torch.equal(got, want) and int(want[0, -1]) > 0

    images = np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    batch = {"images": images[:, ::-1],
             "boxes_xywh": np.full((2, 1, 4), 20.0, np.float32),
             "labels": np.zeros((2, 1), np.int32)}
    assert any(s < 0 for s in batch["images"].strides)
    opt = ts.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5)
    metrics = []
    for b in (batch, {k: np.ascontiguousarray(v) for k, v in batch.items()}):
        m = copy.deepcopy(model)
        step = ts.make_train_step(cfg, opt, use_remat=False, device="cpu")
        _, out = step(ts.TrainState(m, opt.init(m), 0), b)
        metrics.append({k: float(v) for k, v in out.items()})
    assert metrics[0] == metrics[1]


# ---------------------------------------------------------------------------
# every public name of the JAX package has a counterpart in the port
# ---------------------------------------------------------------------------

JAX_PKG = ROOT / "xrseg_tpu"
# JAX module -> the port's modules that hold its names, where they moved
MOVED = {
    "ops/pallas_kernels.py": ("ops/nms_kernels.py", "ops/mask_kernels.py"),
}
# (JAX module, name) -> the port's counterpart under another name or in
# another place, "module:attribute", checked by importing it
COUNTERPART = {
    ("ops/pallas_kernels.py", "nms_select_pallas"):
        "xrseg_tpu_torch.ops.nms_kernels:nms_select_cuda",
    ("ops/pallas_kernels.py", "nms_select_batched_pallas"):
        "xrseg_tpu_torch.ops.nms_kernels:nms_select_batched_cuda",
    ("ops/pallas_kernels.py", "nms_rotated_batched_pallas"):
        "xrseg_tpu_torch.ops.nms_kernels:nms_rotated_batched_cuda",
    ("ops/pallas_kernels.py", "mask_synth_crop_pallas"):
        "xrseg_tpu_torch.ops.mask_kernels:mask_synth_crop_cuda",
    ("models/yolo11.py", "ordered_param_slots"):
        "xrseg_tpu_torch.io.onnx_loader:ordered_param_slots",
    **{("models/yolo11.py", m): f"xrseg_tpu_torch.models.yolo11:YOLO11.{m}"
       for m in ("forward", "forward_train", "backbone", "neck",
                 "head_outputs")},
    # the classify task runs through YOLO11.forward (cls_head)
    ("models/yolo11.py", "classify_forward"):
        "xrseg_tpu_torch.models.yolo11:ClassifyHead.forward",
    # the port's resize_normalize takes its output dtype
    ("ops/preprocess.py", "resize_normalize_bf16"):
        "xrseg_tpu_torch.ops.preprocess:resize_normalize",
}
# (JAX module, name) -> why the port has none
NO_PORT = {
    ("__init__.py", "enable_compile_cache"):
        "XLA's persistent compilation cache; eager torch compiles nothing",
    ("train/preflight.py", "jaxpr_peak_bytes"):
        "reads a jaxpr; the port's preflight estimates from the step's "
        "tensors",
    ("io/native.py", "NativeUnavailable"):
        "the port builds the native library or raises; no numpy fallback "
        "to signal",
    ("io/weights.py", "load_orbax"):
        "orbax checkpoints are a standing refusal (ROADMAP item 13b): "
        "orbax-checkpoint requires jax",
    ("io/weights.py", "save_orbax"): "as load_orbax",
    ("models/layers.py", "KeyGen"):
        "JAX PRNG key splitting; the port draws from a torch.Generator",
    ("models/layers.py", "autopad"):
        "the port's convs are nn.Modules that pad k // 2 themselves",
    ("models/layers.py", "conv2d_f32acc"):
        "a custom_vjp for float32 accumulation; torch convs accumulate in "
        "float32 and autograd differentiates them",
    ("models/layers.py", "convT2x_f32acc"): "as conv2d_f32acc",
    ("models/layers.py", "conv0_s2d_apply"):
        "a space-to-depth stem for the TPU's MXU that the JAX model does "
        "not use either (xrseg_tpu/models/yolo11.py:281)",
    **{("models/layers.py", name):
       "the functional layers' init/apply pairs are nn.Modules in the port"
       for name in ("attention_init", "attention_apply", "bottleneck_init",
                    "bottleneck_apply", "c2f_init", "c2psa_init",
                    "c2psa_apply", "c3k2_init", "c3k2_apply", "c3k_init",
                    "c3k_apply", "conv_init", "dwconv_init", "dwconv_apply",
                    "head_conv_init", "head_conv_apply", "proto_init",
                    "proto_apply", "psablock_init", "psablock_apply",
                    "sppf_init", "sppf_apply")},
}


def _defined(path: Path) -> set:
    """The public top-level functions and classes of a module."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _bound(path: Path) -> set:
    """Every top-level name a module binds (defs, classes, assignments,
    imports)."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    """Each public function and class of xrseg_tpu/<rel> is defined or
    bound at the same path in the port (or in the modules it moved to),
    or stands in COUNTERPART (checked by import) or NO_PORT (with its
    reason). Stale entries fail too, so the lists stay what the diff
    finds."""
    import importlib
    jax_names = _defined(JAX_PKG / rel)
    homes = [PORT / m for m in MOVED.get(rel, (rel,))]
    assert all(h.exists() for h in homes), f"no port module for {rel}"
    port_names = set().union(*(_bound(h) for h in homes))
    missing = jax_names - port_names
    for name in sorted(missing & {n for m, n in COUNTERPART if m == rel}):
        mod, attr = COUNTERPART[(rel, name)].split(":")
        obj = importlib.import_module(mod)
        for part in attr.split("."):
            obj = getattr(obj, part)
        assert callable(obj), COUNTERPART[(rel, name)]
    listed = {n for m, n in list(COUNTERPART) + list(NO_PORT) if m == rel}
    assert missing == listed, (
        f"{rel}: unported {sorted(missing - listed)}; listed but "
        f"present or gone {sorted(listed - missing)}")
