"""Multi-object-tracking metrics: CLEAR MOT (MOTA, ID switches) + IDF1
(the port's copy of xrseg_tpu/eval/mot.py; numpy, scipy when present).

Quantifies perception.tracking.MultiTargetTracker — the capability
extension beyond the reference's single-target lock (TrackingUtils.cs
ships only the IoU helper; IEExecutor locks one object). The detector
already has mAP (eval.metrics); this is the corresponding score for the
tracking layer: how well track IDENTITIES persist over a sequence.

Protocol (the standard one, py-motmetrics semantics):
- Per frame, GT-to-hypothesis correspondence: matches carried over from
  the previous frame are kept while their IoU still clears the gate
  (CLEAR's continuity rule), then the remainder is matched by Hungarian
  assignment on IoU. A GT whose carried match changes hypothesis id
  counts one ID SWITCH.
- MOTA = 1 - (FN + FP + IDSW) / n_gt  (can be negative).
- IDF1 (Ristani): a GLOBAL bipartite assignment between GT ids and
  hypothesis ids over per-frame GATED OVERLAPS — independent of the
  CLEAR correspondence, so a consistent-identity hypothesis is credited
  even where CLEAR's continuity rule matched a different one — giving
  IDTP; IDF1 = 2*IDTP / (n_gt + n_pred).

Inputs are per-frame lists of (id, box cxcywh) in any consistent pixel
space — run the tracker however you like and hand its confirmed tracks
here (tests/test_torch_eval.py drives MultiTargetTracker end to end).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from xrseg_tpu_torch.eval.metrics import box_iou_xywh

Frame = Sequence[Tuple[int, np.ndarray]]   # [(id, box cxcywh [4])]


def _hungarian_max(score: np.ndarray, gate: float
                   ) -> List[Tuple[int, int]]:
    """Maximum-score assignment of score[i,j] pairs with score >= gate.
    scipy's linear_sum_assignment when present, else a self-contained
    exact Jonker-Volgenant-style solver (`_lsa_maximize`, the plain twin,
    tested equal to scipy: scipy is not one of the port's base
    dependencies)."""
    if score.size == 0:
        return []
    try:
        from scipy.optimize import linear_sum_assignment
        ri, ci = linear_sum_assignment(-score)
    except ImportError:
        ri, ci = _lsa_maximize(score)
    return [(int(i), int(j)) for i, j in zip(ri, ci)
            if score[i, j] >= gate]


def _lsa_maximize(score: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact rectangular max-sum assignment (augmenting-path Hungarian on
    the negated, square-padded matrix). O(n^3); matrices here are tiny
    (per-frame detections / distinct track-id counts)."""
    r, c = score.shape
    n = max(r, c)
    cost = np.zeros((n, n))
    cost[:r, :c] = -score
    # Jonker-Volgenant shortest augmenting path (1-indexed internals)
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)     # p[j] = row matched to column j
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], np.inf, 0
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            p[j0] = p[way[j0]]
            j0 = way[j0]
    rows, cols = [], []
    for j in range(1, n + 1):
        if p[j] and p[j] <= r and j <= c:
            rows.append(p[j] - 1)
            cols.append(j - 1)
    return np.asarray(rows, int), np.asarray(cols, int)


def evaluate_mot(gt_frames: Sequence[Frame],
                 pred_frames: Sequence[Frame],
                 iou_threshold: float = 0.5) -> Dict[str, float]:
    """Score a tracked sequence. Returns {MOTA, IDF1, IDP, IDR,
    id_switches, fp, fn, n_gt, n_pred, n_frames}."""
    if len(gt_frames) != len(pred_frames):
        raise ValueError(f"{len(gt_frames)} GT frames vs "
                         f"{len(pred_frames)} predicted")
    fn = fp = idsw = n_gt = n_pred = 0
    last_match: Dict[int, int] = {}            # gt_id -> hyp_id
    pair_frames: Dict[Tuple[int, int], int] = {}   # (gt,hyp) co-matches
    for gts, preds in zip(gt_frames, pred_frames):
        gts, preds = list(gts), list(preds)
        n_gt += len(gts)
        n_pred += len(preds)
        gid = [g[0] for g in gts]
        pid = [p[0] for p in preds]
        iou = np.zeros((len(gts), len(preds)))
        for i, (_, gb) in enumerate(gts):
            for j, (_, pb) in enumerate(preds):
                iou[i, j] = box_iou_xywh(np.asarray(gb, np.float64),
                                         np.asarray(pb, np.float64))
        # 1) continuity: keep last frame's correspondences that still
        # hold. A hypothesis can carry over to ONE GT only (two GTs may
        # both remember the same hyp id after occlusions — first in gid
        # order wins, the other falls through to the Hungarian stage).
        matches: Dict[int, int] = {}
        used_g, used_p = set(), set()
        for i, g in enumerate(gid):
            want = last_match.get(g)
            if want is None or want not in pid:
                continue
            j = pid.index(want)
            if j not in used_p and iou[i, j] >= iou_threshold:
                matches[i] = j
                used_g.add(i)
                used_p.add(j)
        # 2) Hungarian over the remainder
        free_g = [i for i in range(len(gid)) if i not in used_g]
        free_p = [j for j in range(len(pid)) if j not in used_p]
        sub = iou[np.ix_(free_g, free_p)] if free_g and free_p \
            else np.zeros((0, 0))
        for si, sj in _hungarian_max(sub, iou_threshold):
            matches[free_g[si]] = free_p[sj]
        # 3) count
        fn += len(gid) - len(matches)
        fp += len(pid) - len(matches)
        for i, j in matches.items():
            g, p = gid[i], pid[j]
            if g in last_match and last_match[g] != p:
                idsw += 1
            last_match[g] = p
        # IDF1 association is INDEPENDENT of the CLEAR correspondence
        # (Ristani semantics): every gated (gt,hyp) overlap counts as a
        # potential co-frame; the global assignment below resolves ids
        for i in range(len(gid)):
            for j in range(len(pid)):
                if iou[i, j] >= iou_threshold:
                    key = (gid[i], pid[j])
                    pair_frames[key] = pair_frames.get(key, 0) + 1
    # IDF1: global one-to-one gt_id <-> hyp_id assignment maximizing
    # total potentially-co-matched frames (IDTP)
    g_ids = sorted({k[0] for k in pair_frames})
    p_ids = sorted({k[1] for k in pair_frames})
    idtp = 0
    if pair_frames:
        m = np.zeros((len(g_ids), len(p_ids)))
        for (g, p), c in pair_frames.items():
            m[g_ids.index(g), p_ids.index(p)] = c
        idtp = int(sum(m[i, j] for i, j in _hungarian_max(m, 1)))
    idp = idtp / n_pred if n_pred else 0.0
    idr = idtp / n_gt if n_gt else 0.0
    return {
        "MOTA": 1.0 - (fn + fp + idsw) / n_gt if n_gt else float("nan"),
        "IDF1": (2 * idtp / (n_gt + n_pred)) if (n_gt + n_pred) else 0.0,
        "IDP": idp, "IDR": idr,
        "id_switches": idsw, "fp": fp, "fn": fn,
        "n_gt": n_gt, "n_pred": n_pred, "n_frames": len(gt_frames),
    }


def load_motchallenge(path: str, min_conf: float = 0.0
                      ) -> List[Frame]:
    """MOTChallenge txt (`frame,id,left,top,w,h,conf,...`) -> per-frame
    [(id, box cxcywh)] lists, 1-indexed frames densified from 1..max.
    GT files mark inactive boxes with conf 0 — those rows are dropped;
    raise min_conf to gate detector confidence in result files."""
    rows: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    max_f = 0
    with open(path) as f:
        for line in f:
            parts = line.replace(";", ",").split(",")
            if len(parts) < 6:
                continue
            fr, tid = int(float(parts[0])), int(float(parts[1]))
            l, t, w, h = (float(v) for v in parts[2:6])
            conf = float(parts[6]) if len(parts) > 6 else 1.0
            if conf <= min_conf:
                continue
            rows.setdefault(fr, []).append(
                (tid, np.asarray([l + w / 2, t + h / 2, w, h],
                                 np.float64)))
            max_f = max(max_f, fr)
    return [rows.get(i, []) for i in range(1, max_f + 1)]


def _main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="CLEAR-MOT + IDF1 over MOTChallenge-format files")
    ap.add_argument("--gt", required=True, help="MOTChallenge gt.txt")
    ap.add_argument("--pred", required=True,
                    help="MOTChallenge tracker-output txt")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--min-conf", type=float, default=0.0,
                    help="drop prediction rows at or below this conf")
    args = ap.parse_args()
    gt = load_motchallenge(args.gt)
    pred = load_motchallenge(args.pred, min_conf=args.min_conf)
    n = max(len(gt), len(pred))
    gt += [[] for _ in range(n - len(gt))]
    pred += [[] for _ in range(n - len(pred))]
    r = evaluate_mot(gt, pred, iou_threshold=args.iou)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in r.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())


def track_sequence(det_frames: Sequence[Frame], *,
                   labels: int = 0, **tracker_kwargs) -> List[Frame]:
    """Convenience: run MultiTargetTracker over per-frame detection
    boxes (id field of the input tuples is ignored — detections carry no
    identity; that is the tracker's job) and return its confirmed tracks
    as (track_id, box) frames, directly scoreable by evaluate_mot."""
    from xrseg_tpu_torch.perception.tracking import BoundingBox, \
        MultiTargetTracker
    tr = MultiTargetTracker(**tracker_kwargs)
    out: List[Frame] = []
    for dets in det_frames:
        bbs = [BoundingBox(float(b[0]), float(b[1]), float(b[2]),
                           float(b[3]), label=labels) for _, b in dets]
        tracks = tr.update(bbs)
        out.append([(t.track_id,
                     np.asarray([t.box.center_x, t.box.center_y,
                                 t.box.width, t.box.height], np.float64))
                    for t in tracks])
    return out
