"""Box visualization onto numpy RGB frames (the IEBoxer equivalent).

The reference draws pooled uGUI panels (IEBoxer.cs:37-128); our output
surface is a plain [H,W,3] uint8 array (PNG-able, streamable), so "drawing"
is rasterizing rectangle outlines + label text. Caps mirror the reference:
200 drawn boxes (IEBoxer.cs:50).
"""
from __future__ import annotations

import colorsys
from typing import Optional, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.perception.tracking import BoundingBox
from xrseg_tpu_torch.viz.labels import COCO_LABELS

MAX_DRAWN_BOXES = 200   # ref: IEBoxer.cs:50


def class_color(label: int) -> Tuple[int, int, int]:
    """Deterministic well-spread palette per class id."""
    h = (label * 0.6180339887) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def _draw_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               color, thickness: int = 2) -> None:
    H, W = img.shape[:2]
    x1, x2 = sorted((max(0, min(W - 1, x1)), max(0, min(W - 1, x2))))
    y1, y2 = sorted((max(0, min(H - 1, y1)), max(0, min(H - 1, y2))))
    t = thickness
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(0, y2 - t + 1):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(0, x2 - t + 1):x2 + 1] = color


def _draw_text(img: np.ndarray, text: str, x: int, y: int, color) -> None:
    try:
        import cv2
        cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    color, 1, cv2.LINE_AA)
    except Exception:
        pass   # text is cosmetic; boxes carry the information


class Boxer:
    """Draws detection boxes + labels (IEBoxer.DrawBoxes equivalent)."""

    def __init__(self, labels: Optional[Sequence[str]] = None):
        self.labels = list(labels) if labels is not None else list(COCO_LABELS)

    def class_name(self, label_id: int) -> str:
        if label_id < 0 or label_id >= len(self.labels):
            return "unknown"
        return self.labels[label_id].replace(" ", "_")

    def draw_boxes(self, frame: np.ndarray, boxes: Sequence[BoundingBox],
                   thickness: int = 2) -> np.ndarray:
        """frame: [H,W,3] uint8 (modified copy returned). Boxes are
        center-origin screen coords (parse_boxes output); screen == frame."""
        img = np.array(frame, copy=True)
        H, W = img.shape[:2]
        for b in boxes[:MAX_DRAWN_BOXES]:
            # center-origin -> pixel coords; screen Y up -> image row down
            cx = b.center_x + W / 2.0
            cy = H / 2.0 - b.center_y
            x1 = int(round(cx - b.width / 2))
            x2 = int(round(cx + b.width / 2))
            y1 = int(round(cy - b.height / 2))
            y2 = int(round(cy + b.height / 2))
            color = class_color(b.label)
            _draw_rect(img, x1, y1, x2, y2, color, thickness)
            _draw_text(img, f"{b.class_name} {b.score:.2f}",
                       x1 + 3, max(12, y1 - 4), color)
        return img


def _draw_line(img: np.ndarray, x1: float, y1: float, x2: float, y2: float,
               color, thickness: int = 2) -> None:
    """Simple stepped line rasterizer (numpy, no cv2 dependency)."""
    H, W = img.shape[:2]
    n = int(max(abs(x2 - x1), abs(y2 - y1), 1))
    xs = np.linspace(x1, x2, n + 1)
    ys = np.linspace(y1, y2, n + 1)
    t = max(1, thickness // 2)
    for x, y in zip(xs, ys):
        xi, yi = int(round(x)), int(round(y))
        if -t < xi < W + t and -t < yi < H + t:
            img[max(0, yi - t):min(H, yi + t),
                max(0, xi - t):min(W, xi + t)] = color


def draw_rotated_boxes(frame: np.ndarray, boxes_xywhr: np.ndarray,
                       labels: np.ndarray, scores: np.ndarray,
                       count: int, thickness: int = 2) -> np.ndarray:
    """OBB overlay: rasterize each rotated box's 4 edges. boxes_xywhr
    [D,5] in frame-pixel coords (cx, cy, w, h, angle_rad), image-row-down
    convention."""
    img = np.array(frame, copy=True)
    for i in range(min(int(count), MAX_DRAWN_BOXES)):
        cx, cy, w, h, r = (float(v) for v in boxes_xywhr[i])
        ca, sa = np.cos(r), np.sin(r)
        corners = []
        for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2),
                       (w / 2, h / 2), (-w / 2, h / 2)):
            corners.append((cx + dx * ca - dy * sa,
                            cy + dx * sa + dy * ca))
        color = class_color(int(labels[i]))
        for a, b in zip(corners, corners[1:] + corners[:1]):
            _draw_line(img, a[0], a[1], b[0], b[1], color, thickness)
    return img


# COCO 17-keypoint skeleton (pairs of keypoint indices); other K values
# draw points only.
COCO_SKELETON_17 = [(15, 13), (13, 11), (16, 14), (14, 12), (11, 12),
                    (5, 11), (6, 12), (5, 6), (5, 7), (6, 8), (7, 9),
                    (8, 10), (1, 2), (0, 1), (0, 2), (1, 3), (2, 4),
                    (3, 5), (4, 6)]


def draw_keypoints(frame: np.ndarray, kpts: np.ndarray,
                   vis_threshold: float = 0.5, radius: int = 3,
                   color=(0, 255, 96), skeleton=None) -> np.ndarray:
    """Pose overlay: kpts [D,K,3] (x, y, vis) in frame-pixel coords.
    Draws visible keypoints as filled squares plus skeleton edges (the
    COCO 17-point skeleton by default when K==17)."""
    img = np.array(frame, copy=True)
    H, W = img.shape[:2]
    kpts = np.asarray(kpts)
    if kpts.ndim == 2:
        kpts = kpts[None]
    K = kpts.shape[1]
    if skeleton is None and K == 17:
        skeleton = COCO_SKELETON_17
    for inst in kpts:
        vis = inst[:, 2] >= vis_threshold
        if skeleton:
            for a, b in skeleton:
                if a < K and b < K and vis[a] and vis[b]:
                    _draw_line(img, inst[a, 0], inst[a, 1],
                               inst[b, 0], inst[b, 1], color, 1)
        for k in range(K):
            if not vis[k]:
                continue
            x, y = int(round(inst[k, 0])), int(round(inst[k, 1]))
            img[max(0, y - radius):min(H, y + radius),
                max(0, x - radius):min(W, x + radius)] = color
    return img
