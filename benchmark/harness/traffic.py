"""Traffic from the seed: the camera scene, its head poses, the batch
pools and the seeded samples of answers to check. numpy only.

The scene is modelled on the program's SyntheticCameraSource: solid
rectangles moving over a gradient, an fp16 depth frame and an orbiting
head pose with Quest-3-like intrinsics. One change: the depth background
is a tilted plane inside the fusion's 0.1-3.0 m range (the source puts
it at 3.5 m, out of range), so the tracked target's point cloud has
points on every frame wherever it lies.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

INTRINSICS = {"focal": (440.0, 440.0), "principal": (640.0, 480.0),
              "sensor": (1280, 960)}


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per use of the seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def scene_frames(seed: int, n: int, frame_hw: Tuple[int, int],
                 depth_hw: Tuple[int, int], n_objects: int = 3
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """`n` consecutive frames of one seeded scene: (rgb [H,W,3] uint8,
    depth [dh,dw] uint16 holding fp16 bits)."""
    rng = rng_for(seed, 1)
    H, W = frame_hw
    dh, dw = depth_hw
    centers = rng.uniform(0.25, 0.75, (n_objects, 2))
    vels = rng.uniform(-0.05, 0.05, (n_objects, 2))
    sizes = rng.uniform(0.08, 0.2, (n_objects, 2))
    colors = rng.integers(64, 255, (n_objects, 3))
    depths = rng.uniform(0.5, 1.4, n_objects)
    yy = np.linspace(0, 80, H, dtype=np.float32)[:, None]
    xx = np.linspace(0, 80, W, dtype=np.float32)[None, :]
    bg = np.clip(np.stack([yy + xx, 40 + 0 * yy + xx, 80 + yy - xx], -1),
                 0, 255).astype(np.uint8)
    plane = (1.5 + 0.5 * (np.arange(dw)[None, :] / max(dw - 1, 1)
                          + np.arange(dh)[:, None] / max(dh - 1, 1))
             ).astype(np.float32)
    out = []
    for t in range(n):
        frame = bg.copy()
        depth = plane.copy()
        c = (centers + vels * t) % 1.0
        for i in range(n_objects):
            (cy, cx), (hh, hw) = c[i], sizes[i]
            y1, y2 = int((cy - hh / 2) * H), int((cy + hh / 2) * H)
            x1, x2 = int((cx - hw / 2) * W), int((cx + hw / 2) * W)
            frame[max(0, y1):max(0, y2), max(0, x1):max(0, x2)] = colors[i]
            y1, y2 = int((cy - hh / 2) * dh), int((cy + hh / 2) * dh)
            x1, x2 = int((cx - hw / 2) * dw), int((cx + hw / 2) * dw)
            depth[max(0, y1):max(0, y2), max(0, x1):max(0, x2)] = depths[i]
        out.append((frame, depth.astype(np.float16).view(np.uint16)))
    return out


def head_pose(t: int) -> Tuple[np.ndarray, np.ndarray]:
    """The orbiting pose of source frame t: (position [3], quat [x,y,z,w])."""
    ang = 0.02 * t
    pos = np.array([0.1 * np.sin(ang), 1.6, 0.1 * np.cos(ang)], np.float32)
    half = 0.5 * 0.05 * np.sin(ang)
    quat = np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32)
    return pos, quat


def batch_pool(seed: int, n_batches: int, batch: int,
               frame_hw: Tuple[int, int]) -> List[np.ndarray]:
    """`n_batches` distinct uint8 batches [batch, H, W, 3] of scene frames
    in a seeded order."""
    frames = scene_frames(seed, n_batches * batch, frame_hw, (8, 8))
    order = rng_for(seed, 4).permutation(len(frames))
    rgb = np.stack([frames[i][0] for i in order])
    return [rgb[b * batch:(b + 1) * batch] for b in range(n_batches)]


def sample_ids(seed: int, n_items: int, n_sample: int) -> List[int]:
    """A seeded sample of item ids, without repeats, sorted; with the last
    item always in it (the latest answer, the one a late fault reaches)."""
    if n_items <= 0:
        return []
    rng = rng_for(seed, 3)
    k = min(n_sample, n_items)
    ids = set(rng.choice(n_items, k, replace=False).tolist())
    ids.discard(n_items - 1)
    ids = sorted(ids)[:k - 1] + [n_items - 1]
    return sorted(ids)
