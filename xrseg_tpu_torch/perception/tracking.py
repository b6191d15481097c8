"""Single-target tracking + screen-space box conventions.

Host-side perception layer mirroring the reference exactly:
  - BoundingBox in *center-origin screen coordinates* with Y flipped vs model
    space (ParseBoxes, Assets/Scripts/InferenceEngine/IEExecutor.cs:529-559)
  - IoU (TrackingUtils.cs:8-39)
  - same-class nearest-center lock with a 300 px gate
    (IEExecutor.cs:485-526)
  - selection by screen position with a 50 px margin
    (IEExecutor.cs:721-805)

These run on tiny slates (max 50 boxes) so they live on the host in numpy;
the device never waits on them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BoundingBox:
    """Center-origin screen-space box (ref: IEBoxer.cs:6-15)."""
    center_x: float
    center_y: float
    width: float
    height: float
    label: int = -1
    class_name: str = ""
    score: float = 0.0
    index: int = -1        # slot in the detection slate (for masks/coefs)


def parse_boxes(boxes_xywh_640: np.ndarray, labels: np.ndarray,
                scores: np.ndarray, count: int,
                screen_wh: Tuple[float, float],
                class_names: Sequence[str] = (),
                max_boxes: int = 50,
                model_size: Tuple[float, float] = (640.0, 640.0)
                ) -> List[BoundingBox]:
    """Model-space cxcywh -> center-origin screen space.

    Exact ParseBoxes math (IEExecutor.cs:534,543-544), with the reference's
    hardcoded 640/320 generalized to the configured model input size:
      offsetX = (cx - mw/2) * scaleX ; offsetY = (mh/2 - cy) * scaleY (Y flip)
    """
    sw, sh = screen_wh
    mh, mw = model_size
    sx, sy = sw / mw, sh / mh
    out: List[BoundingBox] = []
    n = min(int(count), max_boxes)
    for i in range(n):
        cx, cy, w, h = (float(v) for v in boxes_xywh_640[i])
        lab = int(labels[i])
        name = (class_names[lab].replace(" ", "_")
                if 0 <= lab < len(class_names) else "unknown")
        out.append(BoundingBox(
            center_x=(cx - mw / 2.0) * sx,
            center_y=(mh / 2.0 - cy) * sy,
            width=w * sx,
            height=h * sy,
            label=lab,
            class_name=name,
            score=float(scores[i]),
            index=i,
        ))
    return out


def box_to_model_space(box: BoundingBox, screen_wh: Tuple[float, float],
                       model_size: Tuple[float, float] = (640.0, 640.0)):
    """Inverse of parse_boxes (the mapping at IEExecutor.cs:585-588)."""
    sw, sh = screen_wh
    mh, mw = model_size
    sx, sy = sw / mw, sh / mh
    return (box.center_x / sx + mw / 2.0,
            mh / 2.0 - box.center_y / sy,
            box.width / sx,
            box.height / sy)


def iou(a: BoundingBox, b: BoundingBox) -> float:
    """TrackingUtils.CalculateIoU (TrackingUtils.cs:8-39)."""
    a_l, a_r = a.center_x - a.width / 2, a.center_x + a.width / 2
    a_t, a_b = a.center_y + a.height / 2, a.center_y - a.height / 2
    b_l, b_r = b.center_x - b.width / 2, b.center_x + b.width / 2
    b_t, b_b = b.center_y + b.height / 2, b.center_y - b.height / 2
    iw = max(0.0, min(a_r, b_r) - max(a_l, b_l))
    ih = max(0.0, min(a_t, b_t) - max(a_b, b_b))
    inter = iw * ih
    union = a.width * a.height + b.width * b.height - inter
    return inter / union if union > 0 else 0.0


class KalmanBoxFilter:
    """Constant-velocity Kalman filter over (cx, cy, w, h) — the SORT-style
    motion model (Bewley et al. 2016), on our center-origin screen boxes.

    State [cx, cy, w, h, vcx, vcy, vw, vh]; observations are the box
    itself. Velocities start unknown (large prior variance) and are learned
    from the measurement stream. Capability extension beyond the
    reference's memoryless nearest-center match (IEExecutor.cs:485-526):
    prediction carries a track through missed/occluded frames and keeps
    the match gate centered on where the object is *going*.
    """

    def __init__(self, box: BoundingBox, dt: float = 1.0,
                 process_var: float = 1.0, measure_var: float = 1.0):
        self.x = np.array([box.center_x, box.center_y,
                           box.width, box.height,
                           0.0, 0.0, 0.0, 0.0], np.float64)
        # position prior tight-ish (we just observed it), velocity wide open
        self.P = np.diag([10.0] * 4 + [1000.0] * 4)
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4) * dt
        self.H = np.eye(4, 8)
        # size velocities drift slower than position velocities
        self.Q = np.diag([1.0, 1.0, 1.0, 1.0,
                          0.1, 0.1, 0.01, 0.01]) * process_var
        self.R = np.eye(4) * measure_var

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.x[2:4] = np.maximum(self.x[2:4], 1e-3)   # sizes stay positive
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x[:4].copy()

    def update(self, box: BoundingBox) -> np.ndarray:
        z = np.array([box.center_x, box.center_y, box.width, box.height],
                     np.float64)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.x[2:4] = np.maximum(self.x[2:4], 1e-3)
        self.P = (np.eye(8) - K @ self.H) @ self.P
        return self.x[:4].copy()

    def as_box(self, like: BoundingBox) -> BoundingBox:
        """Current state as a BoundingBox carrying `like`'s metadata."""
        return dataclasses.replace(
            like, center_x=float(self.x[0]), center_y=float(self.x[1]),
            width=float(self.x[2]), height=float(self.x[3]))


@dataclasses.dataclass
class Track:
    """One tracked object (multi-target tracking extension)."""
    track_id: int
    box: BoundingBox
    hits: int = 1
    misses: int = 0
    age: int = 1
    kf: Optional[KalmanBoxFilter] = None
    embedding: Optional[np.ndarray] = None   # EMA'd appearance descriptor


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class MultiTargetTracker:
    """Greedy IoU tracker over the per-frame detection slate.

    Capability extension beyond the reference's single-target lock: the
    reference ships the IoU helper (TrackingUtils.cs:8-39) but only uses
    nearest-center matching for one object. This tracker matches every
    detection to existing tracks by best IoU (same class), spawns tracks
    for unmatched detections, and retires tracks after `max_misses` lost
    frames — the "keep last state briefly" behavior the reference applies
    to its single mask (IEMasker.cs:201-208), generalized.
    """

    def __init__(self, iou_threshold: float = 0.3, max_misses: int = 5,
                 min_hits: int = 2, motion: bool = False,
                 reid_threshold: float = 0.0,
                 embedding_momentum: float = 0.8,
                 high_score: float = 0.0):
        """motion=True attaches a constant-velocity KalmanBoxFilter to each
        track: matching runs against the *predicted* box and lost frames
        coast along the estimated velocity (SORT semantics), so fast movers
        survive short occlusions that break memoryless IoU matching.

        reid_threshold > 0 enables appearance re-identification: pass
        per-detection descriptor vectors to update(embeddings=...) — the
        mask-coefficient rows the segmentation head already computes are a
        free instance descriptor (det["coefs"], [D,32]) — and a coasting
        track that fails the IoU match re-acquires an unmatched
        SAME-CLASS detection whose cosine similarity to the track's EMA'd
        embedding exceeds the threshold. (A learned embedding head would
        be stronger; the coef vector is the zero-extra-FLOPs version.)

        high_score > 0 enables ByteTrack-style TWO-STAGE association
        (Zhang et al. ECCV 2022): feed the tracker EVERYTHING above a low
        detection gate (set the pipeline's score_threshold low); stage 1
        associates confident detections (score >= high_score) to tracks,
        stage 2 lets still-unmatched tracks recover through the LOW-score
        leftovers — exactly the detections an occluded or blurred object
        produces — while unmatched low-score detections are discarded
        (they never spawn tracks, so background noise stays out). This is
        the standard fix for occlusion-induced identity switches."""
        self.iou_threshold = iou_threshold
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.motion = motion
        self.reid_threshold = float(reid_threshold)
        self.embedding_momentum = float(embedding_momentum)
        self.high_score = float(high_score)
        self.tracks: List[Track] = []
        self._next_id = 1

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1

    @property
    def confirmed(self) -> List[Track]:
        return [t for t in self.tracks if t.hits >= self.min_hits]

    def update(self, boxes: Sequence[BoundingBox],
               embeddings: Optional[np.ndarray] = None) -> List[Track]:
        """Advance one frame; returns confirmed tracks.

        embeddings: optional [len(boxes), E] per-detection descriptors
        (e.g. det["coefs"] rows) — used for re-ID when reid_threshold > 0
        and EMA'd into each track's embedding on every match."""
        # with motion on, advance each track to its predicted box first —
        # matching and lost-frame coasting both use the prediction
        if self.motion:
            for t in self.tracks:
                if t.kf is not None:
                    t.kf.predict()
                    t.box = t.kf.as_box(t.box)
        used_t, used_d = set(), set()

        def score_pairs(det_ids) -> list:
            """(iou, track_idx, det_idx) for unmatched same-class pairs."""
            out = []
            for ti, t in enumerate(self.tracks):
                if ti in used_t:
                    continue
                for di in det_ids:
                    if di in used_d:
                        continue
                    d = boxes[di]
                    if d.class_name != t.box.class_name:
                        continue
                    v = iou(t.box, d)
                    if v >= self.iou_threshold:
                        out.append((v, ti, di))
            out.sort(reverse=True)
            return out

        if self.high_score > 0:
            high_ids = [i for i, d in enumerate(boxes)
                        if d.score >= self.high_score]
            low_ids = [i for i in range(len(boxes)) if i not in high_ids]
        else:
            high_ids, low_ids = list(range(len(boxes))), []
        pairs = score_pairs(high_ids)

        def match(ti: int, di: int) -> None:
            used_t.add(ti)
            used_d.add(di)
            t = self.tracks[ti]
            if t.kf is not None:
                t.kf.update(boxes[di])
                t.box = t.kf.as_box(boxes[di])   # filtered pos, det metadata
            else:
                t.box = boxes[di]
            if embeddings is not None:
                e = np.asarray(embeddings[di], np.float32)
                m = self.embedding_momentum
                t.embedding = (e if t.embedding is None
                               else m * t.embedding + (1 - m) * e)
            t.hits += 1
            t.misses = 0

        for v, ti, di in pairs:          # greedy best-first assignment
            if ti in used_t or di in used_d:
                continue
            match(ti, di)

        # ByteTrack stage 2: tracks the confident detections missed get a
        # second chance at the LOW-score leftovers (occluded/blurred
        # objects still detect — just below the confidence gate)
        if low_ids:
            for v, ti, di in score_pairs(low_ids):
                if ti in used_t or di in used_d:
                    continue
                match(ti, di)

        # re-ID pass: lost tracks reacquire unmatched same-class detections
        # by appearance when the IoU gate failed (e.g. after long occlusion)
        if (self.reid_threshold > 0 and embeddings is not None
                and len(boxes)):
            cands = []
            for ti, t in enumerate(self.tracks):
                if ti in used_t or t.embedding is None:
                    continue
                for di in high_ids:      # low-score dets never re-ID
                    d = boxes[di]
                    if di in used_d or d.class_name != t.box.class_name:
                        continue
                    s = cosine_similarity(t.embedding,
                                          np.asarray(embeddings[di],
                                                     np.float32))
                    if s >= self.reid_threshold:
                        cands.append((s, ti, di))
            cands.sort(reverse=True)
            for s, ti, di in cands:
                if ti in used_t or di in used_d:
                    continue
                match(ti, di)
                t = self.tracks[ti]
                if t.kf is not None:     # teleport the filter to the det
                    t.kf = KalmanBoxFilter(boxes[di])
                    t.box = boxes[di]

        # unmatched tracks age out (coasting on the prediction when motion)
        for ti, t in enumerate(self.tracks):
            t.age += 1
            if ti not in used_t:
                t.misses += 1
        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        # unmatched CONFIDENT detections spawn tracks (ByteTrack: leftover
        # low-score detections are discarded — background noise must not
        # seed identities)
        for di in high_ids:
            if di not in used_d:
                d = boxes[di]
                emb = (np.asarray(embeddings[di], np.float32)
                       if embeddings is not None else None)
                self.tracks.append(Track(
                    self._next_id, d,
                    kf=KalmanBoxFilter(d) if self.motion else None,
                    embedding=emb))
                self._next_id += 1
        return self.confirmed


class TargetTracker:
    """Single-target lock state machine (IEExecutor.cs:228-238,470-526)."""

    def __init__(self, gate_px: float = 300.0, select_margin_px: float = 50.0):
        self.gate_px = gate_px
        self.select_margin_px = select_margin_px
        self.is_tracking = False
        self.locked_box: Optional[BoundingBox] = None

    def reset(self) -> None:
        """ResetTracking (IEExecutor.cs:703-712)."""
        self.is_tracking = False
        self.locked_box = None

    def _hit_test(self, boxes: Sequence[BoundingBox],
                  screen_pos: Tuple[float, float],
                  screen_wh: Tuple[float, float]) -> Optional[BoundingBox]:
        """Nearest box whose (margin-expanded) bounds contain the point.

        screen_pos is in bottom-left-origin pixels (Unity Screen space); the
        reference recenters it (IEExecutor.cs:776-778).
        """
        px = screen_pos[0] - screen_wh[0] / 2.0
        py = screen_pos[1] - screen_wh[1] / 2.0
        m = self.select_margin_px
        best, best_d = None, float("inf")
        for b in boxes:
            if (px >= b.center_x - b.width / 2 - m and
                    px <= b.center_x + b.width / 2 + m and
                    py >= b.center_y - b.height / 2 - m and
                    py <= b.center_y + b.height / 2 + m):
                d = float(np.hypot(px - b.center_x, py - b.center_y))
                if d < best_d:
                    best, best_d = b, d
        return best

    def select_target(self, boxes: Sequence[BoundingBox],
                      screen_pos: Tuple[float, float],
                      screen_wh: Tuple[float, float]) -> bool:
        """SelectTargetFromScreenPos (IEExecutor.cs:768-805)."""
        if not boxes:
            return False
        best = self._hit_test(boxes, screen_pos, screen_wh)
        if best is None:
            return False
        self.locked_box = best
        self.is_tracking = True
        return True

    def find_at_screen_pos(self, boxes: Sequence[BoundingBox],
                           screen_pos: Tuple[float, float],
                           screen_wh: Tuple[float, float]
                           ) -> Optional[BoundingBox]:
        """ExtractPointCloudAtScreenPos hit test (IEExecutor.cs:721-763)."""
        if not boxes:
            return None
        return self._hit_test(boxes, screen_pos, screen_wh)

    def update(self, boxes: Sequence[BoundingBox]) -> Optional[BoundingBox]:
        """Per-frame tracking step (IEExecutor.cs:485-526).

        Returns the matched box (and re-locks onto it), or None on a lost
        frame (lock retained — the reference keeps the last mask/points).
        """
        if not self.is_tracking or self.locked_box is None:
            return None
        best, best_d = None, float("inf")
        for b in boxes:
            if b.class_name != self.locked_box.class_name:
                continue
            d = float(np.hypot(b.center_x - self.locked_box.center_x,
                               b.center_y - self.locked_box.center_y))
            if d < best_d:
                best, best_d = b, d
        if best is not None and best_d < self.gate_px:
            self.locked_box = best
            return best
        return None
