"""Pre-deployment environment validation (counterpart of
xrseg_tpu/runtime/deploy_check.py).

The reference validates its deployment environment before build/run:
supported-device gating (Quest 3/3S + HorizonOS >= v74,
PassthroughCameraUtils.cs:60-74) and an Android-manifest pre-build hook
injecting required permissions (PassthroughCameraEditorUpdateManifest.cs).
The port checks its serving environment up front the same way: the
device, the CUDA kernels (every `csrc/` source built with nvcc), mesh
divisibility, the config and the native host runtime, so failures happen
at deploy time with clear messages, not mid-stream.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class CheckResult:
    ok: bool
    checks: List[Tuple[str, bool, str]]    # (name, passed, detail)

    def raise_if_failed(self) -> None:
        if not self.ok:
            failed = "\n".join(f"  - {n}: {d}" for n, p, d in self.checks
                               if not p)
            raise RuntimeError(f"deployment checks failed:\n{failed}")


def check_environment(cfg=None, *, batch: int = 1,
                      mesh_shape: Optional[Tuple[int, int]] = None,
                      require_cuda: bool = False,
                      frame_source=None, device="cuda") -> CheckResult:
    """Validate the device, kernels and config for serving. Returns
    per-check results; it raises nothing itself (`raise_if_failed` does).

    device: the entry's device ("cuda" or "cpu"). On "cuda" the card must
    be present and the CUDA kernels must build; a failed build is a failed
    check. require_cuda=True adds the check that the device is a CUDA card
    (the JAX package's require_tpu), so it fails on "cpu".
    frame_source: optional ManagedFrameSource; its support/permission/
    availability gates are surfaced as checks (the reference gates these
    at scene startup, WebCamTextureManager.cs:40-56)."""
    checks: List[Tuple[str, bool, str]] = []

    if frame_source is not None:
        from xrseg_tpu_torch.runtime.permissions import ManagedSourceState
        checks.append(("camera_supported", frame_source.is_supported,
                       "passthrough camera device support"))
        perm = frame_source.permissions.has_camera_permission
        checks.append(("camera_permission", perm is True,
                       f"has_camera_permission={perm}"))
        checks.append(("camera_available",
                       frame_source.state != ManagedSourceState.FAILED,
                       f"state={frame_source.state.value} after "
                       f"{frame_source.open_attempts} open attempt(s)"))

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if on_card:
        names = [torch.cuda.get_device_name(i) for i in range(n_cards)]
        checks.append(("devices_present", n_cards > 0,
                       f"{n_cards} device(s): "
                       f"{names[0] if names else 'none'}"))
    else:
        checks.append(("devices_present", True, f"1 device(s): {dev.type}"))
    n_devs = n_cards if on_card else 1

    if require_cuda:
        checks.append(("cuda_platform", on_card and n_cards > 0,
                       f"platform={dev.type}, {n_cards} CUDA device(s)"))

    if on_card and n_cards > 0:
        from xrseg_tpu_torch import _build
        try:
            paths = _build.build_all()
            checks.append(("cuda_kernels", True,
                           f"{len(paths)} libraries built: "
                           + ", ".join(sorted(paths))))
        except RuntimeError as e:      # nvcc missing or a source failed
            checks.append(("cuda_kernels", False, str(e)))

    if mesh_shape is not None:
        n = mesh_shape[0] * mesh_shape[1]
        checks.append(("mesh_fits_devices", n <= n_devs,
                       f"mesh {mesh_shape} needs {n}, have {n_devs}"))
        checks.append(("batch_divisible", batch % max(mesh_shape[0], 1) == 0,
                       f"batch {batch} over data axis {mesh_shape[0]}"))

    if cfg is not None:
        h, w = cfg.model.input_size
        checks.append(("input_stride_aligned", h % 32 == 0 and w % 32 == 0,
                       f"input {cfg.model.input_size} % 32"))
        checks.append(("thresholds_sane",
                       0.0 < cfg.post.score_threshold < 1.0
                       and 0.0 < cfg.post.iou_threshold <= 1.0,
                       f"score={cfg.post.score_threshold} "
                       f"iou={cfg.post.iou_threshold}"))
        checks.append(("topk_covers_maxdet",
                       cfg.post.pre_nms_topk == 0
                       or cfg.post.pre_nms_topk >= cfg.post.max_detections,
                       f"topk={cfg.post.pre_nms_topk} (0=all anchors) "
                       f"max_det={cfg.post.max_detections}"))

    # native runtime availability (only depth_backend="native" and the
    # dataset resize need it, so a missing one is surfaced, not failed)
    from xrseg_tpu_torch.io import native
    try:
        path = native.build_native()
        native.load_library()
        checks.append(("native_runtime", True, f"{path.name} loaded"))
    except (RuntimeError, OSError) as e:
        checks.append(("native_runtime", True,
                       f"unavailable (native host paths disabled): {e}"))

    return CheckResult(ok=all(p for _, p, _ in checks), checks=checks)
