"""Mask visualization with temporal smoothing (the IEMasker equivalent).

Reference behavior reproduced (Assets/Scripts/InferenceEngine/IEMasker.cs):
  - renders the tracked object's 160x160 mask thresholded at the confidence
    gate and cropped to the box (IEMasker.cs:167-185, 232-247)
  - the mask sprite's position/size is smoothed every frame with Unity's
    SmoothDamp (critically-damped spring; IEMasker.cs:65-80)
  - on lost frames the last mask stays visible (KeepCurrentMask,
    IEMasker.cs:201-208)

Output surface: an RGBA overlay array sized to the frame, alpha 0.75 like
the reference's random-color masks (IEMasker.cs:298).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from xrseg_tpu_torch.perception.tracking import BoundingBox
from xrseg_tpu_torch.viz.boxer import class_color


def smooth_damp(current: np.ndarray, target: np.ndarray,
                velocity: np.ndarray, smooth_time: float, dt: float,
                max_speed: float = np.inf) -> Tuple[np.ndarray, np.ndarray]:
    """Unity Vector2.SmoothDamp (critically damped spring), vectorized.

    Game Programming Gems 4 formulation, matching UnityEngine.Mathf.
    """
    smooth_time = max(1e-4, smooth_time)
    omega = 2.0 / smooth_time
    x = omega * dt
    exp = 1.0 / (1.0 + x + 0.48 * x * x + 0.235 * x * x * x)
    change = current - target
    max_change = max_speed * smooth_time
    change = np.clip(change, -max_change, max_change)
    clamped_target = current - change
    temp = (velocity + omega * change) * dt
    new_velocity = (velocity - omega * temp) * exp
    out = clamped_target + (change + temp) * exp
    # anti-overshoot (Unity does this per-component via dot test; sign test
    # per component is the vectorized equivalent)
    overshoot = ((target - current) > 0) == ((out - target) > 0)
    out = np.where(overshoot, target, out)
    new_velocity = np.where(overshoot, (out - target) / dt, new_velocity)
    return out, new_velocity


class Masker:
    """Single-target mask overlay with smoothed placement."""

    def __init__(self, confidence_threshold: float = 0.5,
                 position_smooth_time: float = 0.05,
                 size_smooth_time: float = 0.1,
                 mask_hw: Tuple[int, int] = (160, 160)):
        # ref: 160x160 prototypes (IEMasker.cs:11-12); generalizes to the
        # model's input/4 mask size for non-640 configs
        self.MASK_H, self.MASK_W = mask_hw
        self.confidence = confidence_threshold
        self.pos_tau = position_smooth_time
        self.size_tau = size_smooth_time
        self.reset()

    def reset(self) -> None:
        """ClearAllMasks (IEMasker.cs:226-230)."""
        self._has_target = False
        self._pos = np.zeros(2)
        self._size = np.zeros(2)
        self._pos_vel = np.zeros(2)
        self._size_vel = np.zeros(2)
        self._cached_mask: Optional[np.ndarray] = None
        self._cached_color = (255, 255, 255)

    @property
    def has_cached_mask(self) -> bool:
        return self._cached_mask is not None

    def draw_single_mask(self, box: BoundingBox, mask_160: np.ndarray,
                         frame_wh: Tuple[int, int], dt: float = 1 / 30
                         ) -> None:
        """DrawSingleMask (IEMasker.cs:124-196): cache thresholded+cropped
        mask and update the smoothing targets."""
        fw, fh = frame_wh
        # threshold + bbox crop in mask space (IEMasker.cs:167-185).
        # The reference flips Y when writing texels (posY = H-1-y) because
        # Unity textures are bottom-up; our overlay is top-down so the mask's
        # row order already matches the image.
        m = np.asarray(mask_160)
        assert m.shape == (self.MASK_H, self.MASK_W), m.shape
        sx = self.MASK_W / float(fw)
        sy = self.MASK_H / float(fh)
        ccx = box.center_x * sx + self.MASK_W / 2
        ccy = self.MASK_H / 2 - box.center_y * sy
        hw = box.width * sx / 2
        hh = box.height * sy / 2
        xs = np.arange(self.MASK_W)[None, :]
        ys = np.arange(self.MASK_H)[:, None]
        inside = ((xs >= ccx - hw) & (xs <= ccx + hw) &
                  (ys >= ccy - hh) & (ys <= ccy + hh))
        self._cached_mask = (m > self.confidence) & inside
        self._cached_color = class_color(box.label)

        target_pos = np.array([box.center_x, -box.center_y])
        target_size = np.array([box.width, box.height])
        if not self._has_target:
            self._pos, self._size = target_pos, target_size
            self._pos_vel = np.zeros(2)
            self._size_vel = np.zeros(2)
            self._has_target = True
        self._target_pos = target_pos
        self._target_size = target_size
        self.update_transform(dt)

    def keep_current_mask(self, dt: float = 1 / 30) -> None:
        """KeepCurrentMask (IEMasker.cs:201-208): lost frame, keep overlay.

        The reference runs SmoothDamp from Update() every frame regardless
        of detection outcome (IEMasker.cs:65-80), so a lost frame still
        damps the sprite toward the last target instead of freezing it.
        """
        self.update_transform(dt)

    def update_transform(self, dt: float) -> None:
        """Per-frame SmoothDamp of position/size (IEMasker.cs:65-80)."""
        if not self._has_target:
            return
        self._pos, self._pos_vel = smooth_damp(
            self._pos, self._target_pos, self._pos_vel, self.pos_tau, dt)
        self._size, self._size_vel = smooth_damp(
            self._size, self._target_size, self._size_vel, self.size_tau, dt)

    def render_overlay(self, frame_wh: Tuple[int, int]) -> np.ndarray:
        """RGBA overlay [H,W,4] uint8 with the smoothed mask placement."""
        fw, fh = frame_wh
        out = np.zeros((fh, fw, 4), np.uint8)
        if self._cached_mask is None or not self._has_target:
            return out
        w = max(1, int(round(self._size[0])))
        h = max(1, int(round(self._size[1])))
        # smoothed center in image pixels (pos is (x, -screenY))
        cx = self._pos[0] + fw / 2.0
        cy = self._pos[1] + fh / 2.0
        x1, y1 = int(round(cx - w / 2)), int(round(cy - h / 2))
        # bilinear-resize the binary mask to the smoothed sprite size
        # (the reference texture is bilinear-filtered, IEMasker.cs:316-323)
        m = self._cached_mask.astype(np.float32)
        yi = np.clip((np.arange(h) + 0.5) * self.MASK_H / h - 0.5, 0,
                     self.MASK_H - 1)
        xi = np.clip((np.arange(w) + 0.5) * self.MASK_W / w - 0.5, 0,
                     self.MASK_W - 1)
        y0 = np.floor(yi).astype(int); y1f = np.minimum(y0 + 1, self.MASK_H - 1)
        x0 = np.floor(xi).astype(int); x1f = np.minimum(x0 + 1, self.MASK_W - 1)
        wy = (yi - y0)[:, None]; wx = (xi - x0)[None, :]
        big = (m[np.ix_(y0, x0)] * (1 - wy) * (1 - wx) +
               m[np.ix_(y1f, x0)] * wy * (1 - wx) +
               m[np.ix_(y0, x1f)] * (1 - wy) * wx +
               m[np.ix_(y1f, x1f)] * wy * wx)
        alpha = (big > 0.5)
        # paste with clipping
        fy1, fx1 = max(0, y1), max(0, x1)
        fy2, fx2 = min(fh, y1 + h), min(fw, x1 + w)
        if fy2 <= fy1 or fx2 <= fx1:
            return out
        sub = alpha[fy1 - y1:fy2 - y1, fx1 - x1:fx2 - x1]
        r, g, b = self._cached_color
        region = out[fy1:fy2, fx1:fx2]
        region[sub] = (r, g, b, 191)   # alpha 0.75 (IEMasker.cs:298)
        return out


def draw_masks_multi(boxes, masks, frame_wh: Tuple[int, int],
                     confidence_threshold: float = 0.5) -> np.ndarray:
    """Multi-object mask overlay (the reference's DrawMask variant,
    IEMasker.cs:82-119): every instance's 160x160 mask thresholded, cropped
    to its box, colored per class, composited into one RGBA overlay.

    boxes: sequence of BoundingBox; masks: [N,160,160] float.
    """
    fw, fh = frame_wh
    out = np.zeros((fh, fw, 4), np.uint8)
    masks = np.asarray(masks)
    H, W = masks.shape[1:]
    for b in boxes:
        if b.index < 0 or b.index >= len(masks):
            continue
        m = masks[b.index]
        sx, sy = W / fw, H / fh
        ccx = b.center_x * sx + W / 2
        ccy = H / 2 - b.center_y * sy
        hw = b.width * sx / 2
        hh = b.height * sy / 2
        xs = np.arange(W)[None, :]
        ys = np.arange(H)[:, None]
        inside = ((xs >= ccx - hw) & (xs <= ccx + hw) &
                  (ys >= ccy - hh) & (ys <= ccy + hh))
        binary = (m > confidence_threshold) & inside
        if not binary.any():
            continue
        # nearest-upscale to frame resolution and composite
        yi = np.clip((np.arange(fh) * H) // fh, 0, H - 1)
        xi = np.clip((np.arange(fw) * W) // fw, 0, W - 1)
        big = binary[np.ix_(yi, xi)]
        r, g, bl = class_color(b.label)
        out[big] = (r, g, bl, 191)
    return out


def composite_overlay(frame: np.ndarray, overlay_rgba: np.ndarray) -> np.ndarray:
    """Alpha-blend an RGBA overlay onto an RGB frame."""
    a = overlay_rgba[..., 3:4].astype(np.float32) / 255.0
    rgb = overlay_rgba[..., :3].astype(np.float32)
    out = frame.astype(np.float32) * (1 - a) + rgb * a
    return np.clip(out, 0, 255).astype(np.uint8)
