"""Mask -> RGBD point-cloud fusion (counterpart of
xrseg_tpu/ops/depth_fusion.py).

Rebuild of the reference's Burst `DepthExtractionJob`
(Assets/Scripts/InferenceEngine/IEExecutor.cs:53-179): over a strided
160x160 mask grid, threshold -> box-relative image coords -> depth-UV (with
the depth texture's bottom-up Y flip) -> fp16 depth decode -> 0.1-3.0 m
range filter -> pinhole unprojection with camera intrinsics -> world
transform with the (latency-compensated) depth-capture pose.

The whole grid is a handful of vectorised tensor ops with static shapes
(the grid is only (160/step)^2 points), in the arithmetic order of the JAX
function, and nothing in it reads a value back to the host.

The depth frame is raw fp16 bits. PyTorch has few CUDA ops for uint16, so
the bits travel as int16 (`depth_bits`: a reinterpretation on the host, no
value changes), are gathered as int16 and reinterpreted as float16 on the
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.ops.masks import select_row


def depth_bits(depth_fp16, device) -> torch.Tensor:
    """[Dh,Dw] uint16 raw fp16 bits (numpy) -> int16 tensor on `device`
    holding the same bits."""
    a = np.ascontiguousarray(depth_fp16, np.uint16).view(np.int16)
    return torch.tensor(a, device=device)


def extract_points(depth_fp16: torch.Tensor, mask: torch.Tensor,
                   box_xywh_640: torch.Tensor, focal: torch.Tensor,
                   principal: torch.Tensor, sensor_res: torch.Tensor,
                   cam_pos: torch.Tensor, cam_quat: torch.Tensor,
                   *, confidence_threshold: float = 0.5,
                   min_depth: float = 0.1, max_depth: float = 3.0,
                   sampling_step: int = 4,
                   mask_hw: Tuple[int, int] = (160, 160)
                   ) -> Dict[str, torch.Tensor]:
    """Fixed-shape point extraction.

    Args:
      depth_fp16: [Dh,Dw] int16: raw fp16 bits (see `depth_bits`).
      mask:       [...,mh,mw] float: target instance's sigmoid mask.
      box_xywh_640: [...,4]: target box, model-640 space (cx, cy, w, h).
      focal/principal/sensor_res: [2] camera intrinsics (pixels).
      cam_pos: [3], cam_quat: [4] (x,y,z,w): depth-capture camera pose.
    Returns:
      positions [...,N,3] world-space, depths [...,N], valid [...,N] bool,
      packed [...,N,5], N = (mh/step)*(mw/step). Leading dims of mask and
      box stand for targets sharing one depth frame.
    """
    if depth_fp16.dtype != torch.int16:
        raise TypeError("extract_points takes the depth frame's fp16 bits as "
                        f"int16 (depth_bits), got {depth_fp16.dtype}")
    mh, mw = mask_hw
    step = sampling_step
    gh, gw = mh // step, mw // step
    dh, dw = depth_fp16.shape
    dev = mask.device

    ys = torch.arange(gh, device=dev) * step
    xs = torch.arange(gw, device=dev) * step
    yy = ys.repeat_interleave(gw)        # [N] row-major like the ref kernel
    xx = xs.repeat(gh)

    mval = mask[..., yy, xx]
    alive = mval > confidence_threshold

    # mask coords -> model-image coords inside the box (IEExecutor.cs:108-116)
    norm_x = xx.to(torch.float32) / mw
    norm_y = yy.to(torch.float32) / mh
    cx, cy, bw, bh = (box_xywh_640[..., i, None] for i in range(4))
    img_x = cx - bw * 0.5 + norm_x * bw
    img_y = cy - bh * 0.5 + norm_y * bh
    u = torch.clamp(img_x / 640.0, 0.0, 1.0)
    v = torch.clamp(img_y / 640.0, 0.0, 1.0)

    # depth sampling with bottom-up Y (IEExecutor.cs:119-127); the casts
    # truncate toward zero and the values are non-negative after the clip
    dx = (u * (dw - 1)).to(torch.int32)
    dy = ((1.0 - v) * (dh - 1)).to(torch.int32)
    bits = depth_fp16.reshape(-1)[(dy * dw + dx).long()]
    depth_m = bits.view(torch.float16).to(torch.float32)

    alive = alive & (depth_m > min_depth) & (depth_m < max_depth)

    # pinhole unprojection (IEExecutor.cs:138-147)
    cam_px = u * sensor_res[0]
    cam_py = (1.0 - v) * sensor_res[1]
    dir_cam = torch.stack([
        (cam_px - principal[0]) / focal[0],
        (cam_py - principal[1]) / focal[1],
        torch.ones_like(u),
    ], dim=-1)
    dir_cam = dir_cam / torch.linalg.norm(dir_cam, dim=-1, keepdim=True)

    # quaternion rotate + translate (IEExecutor.cs:149-151)
    qv = cam_quat[:3]
    qw = cam_quat[3]
    t = 2.0 * torch.linalg.cross(qv.expand_as(dir_cam), dir_cam)
    dir_world = dir_cam + qw * t + torch.linalg.cross(qv.expand_as(t), t)
    positions = cam_pos + dir_world * depth_m[..., None]

    positions = torch.where(alive[..., None], positions, 0.0)
    depths = torch.where(alive, depth_m, 0.0)
    return {
        "positions": positions,
        "depths": depths,
        "valid": alive,
        # single-copy packed form: [N, 5] = xyz | depth | valid
        "packed": torch.cat(
            [positions, depths[..., None], alive[..., None].float()], dim=-1),
    }


def extract_points_for_target(masks: torch.Tensor, target_index,
                              depth_fp16: torch.Tensor,
                              box_xywh_640: torch.Tensor, focal: torch.Tensor,
                              principal: torch.Tensor,
                              sensor_res: torch.Tensor, cam_pos: torch.Tensor,
                              cam_quat: torch.Tensor, **kw):
    """Device-fused variant for the tracking hot path: gathers the tracked
    target's mask row from the (device-resident) detection slate and runs
    the fusion on it, so the host never downloads the mask (the reference
    copies the full mask to the CPU every frame, IEExecutor.cs:615-621).

    masks: [D,mh,mw] (one image's slate), target_index: int or 0-dim int
    tensor on the masks' device.
    """
    mask = select_row(masks, target_index)
    return extract_points(depth_fp16, mask, box_xywh_640, focal, principal,
                          sensor_res, cam_pos, cam_quat,
                          mask_hw=tuple(masks.shape[1:]), **kw)


def extract_points_batched(depth_fp16, masks, boxes, focal, principal,
                           sensor_res, cam_pos, cam_quat, **kw):
    """Targets sharing one depth frame ([T,...] masks/boxes): the batch
    dimension that the JAX package gets from vmap."""
    return extract_points(depth_fp16, masks, boxes, focal, principal,
                          sensor_res, cam_pos, cam_quat, **kw)


def extract_points_numpy(depth_fp16, mask, box_xywh_640, focal, principal,
                         sensor_res, cam_pos, cam_quat,
                         confidence_threshold=0.5, min_depth=0.1,
                         max_depth=3.0, sampling_step=4):
    """Pure-numpy scalar reference (mirrors the Burst job literally): the
    test oracle for the tensor version. depth_fp16 is the uint16 frame."""
    mh, mw = mask.shape
    dh, dw = depth_fp16.shape
    gh, gw = mh // sampling_step, mw // sampling_step
    N = gh * gw
    positions = np.zeros((N, 3), np.float32)
    depths = np.zeros(N, np.float32)
    valid = np.zeros(N, bool)
    cx, cy, bw, bh = (float(v) for v in box_xywh_640)
    qx, qy, qz, qw = (float(v) for v in cam_quat)

    for idx in range(N):
        ly, lx = divmod(idx, gw)
        y, x = ly * sampling_step, lx * sampling_step
        if mask[y, x] <= confidence_threshold:
            continue
        nx_, ny_ = x / mw, y / mh
        img_x = cx - bw / 2 + nx_ * bw
        img_y = cy - bh / 2 + ny_ * bh
        u = min(max(img_x / 640.0, 0.0), 1.0)
        v = min(max(img_y / 640.0, 0.0), 1.0)
        dx = int(u * (dw - 1))
        dy = int((1.0 - v) * (dh - 1))
        d = float(np.frombuffer(np.uint16(depth_fp16[dy, dx]).tobytes(),
                                np.float16)[0])
        if d <= min_depth or d >= max_depth:
            continue
        cam_px = u * sensor_res[0]
        cam_py = (1.0 - v) * sensor_res[1]
        dirc = np.array([(cam_px - principal[0]) / focal[0],
                         (cam_py - principal[1]) / focal[1], 1.0], np.float32)
        dirc /= np.linalg.norm(dirc)
        uvec = np.array([qx, qy, qz], np.float32)
        t = 2.0 * np.cross(uvec, dirc)
        dirw = dirc + qw * t + np.cross(uvec, t)
        positions[idx] = np.asarray(cam_pos, np.float32) + dirw * d
        depths[idx] = d
        valid[idx] = True
    return {"positions": positions, "depths": depths, "valid": valid}
