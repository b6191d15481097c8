"""Builds the port's CUDA sources and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc
into its own shared library:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
       -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The build happens at first use, into `build/kernels/` at the root of the
checkout (listed in .gitignore). The file name carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source is never served by a stale library. `build_all()` starts one nvcc per missing source, all at once,
and waits for all of them; ptxas's register and shared-memory report goes
to `<library>.log` beside the library. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("nms_select", "nms_rotated", "mask_synth_crop", "wbf",
           "conv_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin:"
                           " the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every missing library among `names` in parallel; return paths."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (its
    cudaGetLastError() after the launch)."""
    if err:
        fn = lib.xrseg_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: " + fn(err).decode())


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    `argtypes` set from `signatures` (function -> ctypes argument types)
    and an int `restype` for each of those functions."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def device_index(device) -> int:
    """The CUDA ordinal of a torch device ("cuda" means the current one)."""
    return device.index if device.index is not None else \
        torch.cuda.current_device()
