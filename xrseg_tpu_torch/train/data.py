"""Dataset readers: the reader half of the JAX package's train/data.py,
as the port's own copy (the port imports nothing of the JAX package).

What evaluation reaches is here, line for line the JAX package's:

  label parsers   — parse_yolo_label_file (detect boxes / segment
                    polygons), parse_yolo_pose_label_file,
                    parse_yolo_obb_label_file (DOTA-style corners).
  file datasets   — YoloDataset (ultralytics images/ + labels/),
                    CocoDataset (instances JSON, iscrowd as ignore
                    regions), CocoPoseDataset, YoloPoseDataset,
                    ImageFolderDataset (classify), YoloOBBDataset.
  synthetic sets  — SyntheticShapesDataset, SyntheticPoseDataset,
                    SyntheticOBBDataset, SyntheticClassifyDataset: exact
                    GT drawn from a seed, no files.
  helpers         — decode_coco_rle / encode_coco_rle, letterbox_sample,
                    rasterize_mask (GT polygon fill at proto resolution),
                    _resize_uint8 (the port's native 2-tap resize,
                    io/native.resize2tap_native) and _resize2tap_numpy,
                    its plain twin on ops/preprocess._tap_indices.

Samples are dicts: image uint8 [H,W,3]; boxes [N,4] cxcywh normalized
[0,1]; labels [N] int32; polys: list of [P,2] normalized polygons (or
None); pose adds kpts [N,K,3], obb carries boxes_xywhr [N,5], classify
{image, label}.

Not here yet: the training half (augmentation, mosaic, copy-paste, the
collates and the prefetching Loader, JAX data.py:553-990 and
:1078-1214). They come with the port of training.

Image files decode through PIL, imported lazily where a file is read,
as in the JAX package; the synthetic datasets need no PIL.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

Sample = Dict[str, np.ndarray]
# sample dict: image uint8 [H,W,3]; boxes [N,4] cxcywh normalized [0,1];
# labels [N] int32; polys: list of [P,2] normalized polygons (or None).

# ---------------------------------------------------------------------------
# Dataset (ultralytics directory layout)
# ---------------------------------------------------------------------------

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def parse_yolo_label_file(path: str) -> Tuple[np.ndarray, np.ndarray, list]:
    """Parse one ultralytics label .txt.

    Each line: `cls cx cy w h` (detect) or `cls x1 y1 x2 y2 ... xn yn`
    (segment polygon, >= 3 points). All coordinates normalized to [0,1].
    Returns (boxes [N,4] cxcywh, labels [N], polys list of [P,2]|None).
    Polygon lines derive their box from the polygon extent (ultralytics
    semantics: the box is implied by the segment).
    """
    boxes, labels, polys = [], [], []
    if not os.path.exists(path):
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), [])
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            cls = int(float(vals[0]))
            coords = np.asarray([float(v) for v in vals[1:]], np.float32)
            if coords.size == 4:
                boxes.append(coords)
                polys.append(None)
            elif coords.size >= 6 and coords.size % 2 == 0:
                pts = coords.reshape(-1, 2)
                lo, hi = pts.min(0), pts.max(0)
                boxes.append(np.concatenate([(lo + hi) / 2, hi - lo]))
                polys.append(pts)
            else:
                continue
            labels.append(cls)
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), [])
    return (np.stack(boxes).astype(np.float32),
            np.asarray(labels, np.int32), polys)


class YoloDataset:
    """Ultralytics-format dataset: `root/images/*.jpg` + `root/labels/*.txt`
    (same stem). Flat `root/*.jpg` with sibling `.txt` files also works."""

    def __init__(self, root: str):
        self.root = root
        img_dir = os.path.join(root, "images")
        if os.path.isdir(img_dir):
            pats = [os.path.join(img_dir, "*" + e) for e in IMG_EXTS]
            self._label_for = lambda p: os.path.join(
                root, "labels", os.path.splitext(os.path.basename(p))[0]
                + ".txt")
        else:
            pats = [os.path.join(root, "*" + e) for e in IMG_EXTS]
            self._label_for = lambda p: os.path.splitext(p)[0] + ".txt"
        self.images: List[str] = sorted(
            p for pat in pats for p in glob.glob(pat))
        if not self.images:
            raise FileNotFoundError(f"no images under {root!r}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Sample:
        from PIL import Image
        path = self.images[i % len(self.images)]
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        boxes, labels, polys = parse_yolo_label_file(self._label_for(path))
        return {"image": img, "boxes": boxes, "labels": labels,
                "polys": polys}


def decode_coco_rle(rle: Dict) -> np.ndarray:
    """COCO RLE {counts, size:[h,w]} -> bool [h,w]. Column-major runs
    starting with zeros. counts may be the uncompressed int list (how the
    official annotation files store iscrowd regions) or the mask-API
    compressed string (6-bit chunks offset by 48, bit 5 continuation,
    bit 4 sign, values delta-coded from the 3rd on)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        s = counts.decode() if isinstance(counts, bytes) else counts
        vals, pos = [], 0
        while pos < len(s):
            x, k, more = 0, 0, True
            while more:
                c = ord(s[pos]) - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                pos += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(vals) > 2:
                x += vals[-2]
            vals.append(x)
        counts = vals
    flat = np.zeros(h * w, bool)
    i, val = 0, False
    for c in counts:
        flat[i:i + c] = val
        i += c
        val = not val
    return flat.reshape(w, h).T        # column-major


def encode_coco_rle(mask: np.ndarray) -> Dict:
    """bool [h,w] -> COCO RLE {size, counts: compressed string} (the
    mask-API rleToString form pycocotools loads directly) — inverse of
    decode_coco_rle; round-trip pinned in tests."""
    mask = np.asarray(mask, bool)
    h, w = mask.shape
    f = mask.T.reshape(-1).astype(np.int8)         # column-major
    edges = np.flatnonzero(np.diff(f)) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(f)]])).tolist()
    if len(f) and f[0] == 1:
        runs = [0] + runs
    s = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return {"size": [h, w], "counts": "".join(s)}


class CocoDataset:
    """COCO instances-JSON dataset (the val2017 annotation format), stdlib
    json only — the missing piece between this framework's eval/train
    harness and real COCO ground truth (docs/ROADMAP.md "Parity/quality").

    Speaks the same Sample contract as YoloDataset: {image uint8 [H,W,3],
    boxes [N,4] cxcywh normalized, labels [N] contiguous class indices,
    polys list of [P,2] normalized | None}, so it plugs into
    `evaluate_dataset` and the eval CLI unchanged:

        python -m xrseg_tpu_torch.eval --data val2017/ \\
            --ann annotations/instances_val2017.json --weights w.pt

    Category ids map to contiguous indices by SORTED category id —
    ultralytics' coco91-to-80 convention (COCO ids 1..90 with gaps ->
    0..79), so a model trained on ultralytics COCO labels scores
    directly. Per instance the bbox is authoritative ([x,y,w,h] absolute
    -> cxcywh normalized); segmentation polygons ride along for mask GT
    (multi-part instances use the largest-area part — rasterize_mask
    takes one polygon; the bbox is unaffected). iscrowd=1 annotations
    ride along as ignore_boxes/ignore_labels/ignore_masks (RLE decoded):
    never trained on, and `evaluate_dataset` feeds them to the matcher
    as COCO ignore regions per the official protocol.
    """

    def __init__(self, ann_json: str, images_dir: str):
        import json

        with open(ann_json) as f:
            coco = json.load(f)
        self._categories: List[Dict] = sorted(coco.get("categories", []),
                                              key=lambda c: c["id"])
        self.cat_index: Dict[int, int] = {
            c["id"]: i for i, c in enumerate(self._categories)}
        self.class_names: List[str] = [c["name"]
                                       for c in self._categories]
        self.cat_ids: List[int] = sorted(self.cat_index)   # index -> COCO id
        self._images: List[Dict] = sorted(coco["images"],
                                          key=lambda im: im["id"])
        self._dir = images_dir
        self._anns: Dict[int, List[Dict]] = {}
        self._crowds: Dict[int, List[Dict]] = {}
        for a in coco.get("annotations", []):
            dst = self._crowds if a.get("iscrowd", 0) else self._anns
            dst.setdefault(a["image_id"], []).append(a)
        if not self._images:
            raise FileNotFoundError(f"no images listed in {ann_json!r}")

    def __len__(self) -> int:
        return len(self._images)

    def image_id(self, i: int) -> int:
        """COCO image id of sample i (for results-JSON export)."""
        return int(self._images[i % len(self._images)]["id"])

    def _load_image(self, i: int):
        from PIL import Image
        info = self._images[i % len(self._images)]
        path = os.path.join(self._dir, info["file_name"])
        return info, np.asarray(Image.open(path).convert("RGB"), np.uint8)

    def _instances(self, info: Dict, W: int, H: int):
        """Yield (ann, box cxcywh-normalized, label) for each non-crowd,
        non-degenerate annotation of `info` — the shared walk for the
        instance and keypoint variants."""
        for a in self._anns.get(info["id"], []):
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            yield (a, [(x + w / 2) / W, (y + h / 2) / H, w / W, h / H],
                   self.cat_index[a["category_id"]])

    def _ignore_entries(self, info: Dict, W: int, H: int,
                        with_masks: bool = True):
        """(boxes, labels, masks) for the image's iscrowd regions."""
        ig_boxes, ig_labels, ig_masks = [], [], []
        for a in self._crowds.get(info["id"], []):
            x, y, w, h = a["bbox"]
            ig_boxes.append([(x + w / 2) / W, (y + h / 2) / H,
                             max(w, 1e-6) / W, max(h, 1e-6) / H])
            ig_labels.append(self.cat_index[a["category_id"]])
            seg = a.get("segmentation")
            ig_masks.append(decode_coco_rle(seg)
                            if with_masks and isinstance(seg, dict)
                            and "counts" in seg else None)
        return ig_boxes, ig_labels, ig_masks

    def __getitem__(self, i: int) -> Sample:
        info, img = self._load_image(i)
        H, W = img.shape[:2]
        boxes, labels, polys = [], [], []
        for a, box, label in self._instances(info, W, H):
            boxes.append(box)
            labels.append(label)
            seg = a.get("segmentation")
            poly = None
            if isinstance(seg, list) and seg:
                # polygon format: list of flat [x1,y1,...] rings; keep the
                # largest-area ring (shoelace) for the single-poly contract
                best, best_area = None, -1.0
                for ring in seg:
                    p = np.asarray(ring, np.float32).reshape(-1, 2)
                    if len(p) < 3:
                        continue
                    q = np.roll(p, -1, 0)      # shoelace
                    area = abs(float(
                        (p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]).sum())) / 2
                    if area > best_area:
                        best, best_area = p, area
                if best is not None:
                    poly = best / (W, H)
            polys.append(poly)
        # COCO iscrowd regions: ignore-matched by the evaluator (never
        # trained on — the augment pipeline only reads boxes/labels/polys)
        ig_boxes, ig_labels, ig_masks = self._ignore_entries(info, W, H)
        out: Sample = {"image": img,
                       "boxes": (np.asarray(boxes, np.float32) if boxes
                                 else np.zeros((0, 4), np.float32)),
                       "labels": (np.asarray(labels, np.int32) if boxes
                                  else np.zeros((0,), np.int32)),
                       "polys": polys}
        if ig_boxes:
            out["ignore_boxes"] = np.asarray(ig_boxes, np.float32)
            out["ignore_labels"] = np.asarray(ig_labels, np.int32)
            out["ignore_masks"] = ig_masks
        return out


class CocoPoseDataset:
    """COCO person_keypoints-JSON dataset (val2017 keypoint format) for
    the pose task: same JSON machinery as CocoDataset, samples speak the
    SyntheticPoseDataset/YoloPoseDataset contract ({image, boxes, labels,
    kpts [N,K,3]}, all normalized; visibility kept as COCO's 0/1/2 — the
    loss and OKS eval treat v>0 as labeled). kpt count K comes from the
    category's `keypoints` list (COCO person: 17).

    pycocotools' keypoint eval marks BOTH iscrowd=1 and num_keypoints==0
    annotations as ignore (an unlabeled person can never be OKS-matched
    but would cap recall if counted as GT — about half of val2017's
    person boxes). Both land in ignore_boxes/ignore_labels here."""

    def __init__(self, ann_json: str, images_dir: str):
        self._base = CocoDataset(ann_json, images_dir)
        ks = [len(c.get("keypoints", []))
              for c in self._base._categories if c.get("keypoints")]
        self.kpt_shape: Tuple[int, int] = ((ks[0], 3) if ks else (17, 3))
        self.cat_index = self._base.cat_index
        self.class_names = self._base.class_names
        self.cat_ids = self._base.cat_ids

    def __len__(self) -> int:
        return len(self._base)

    def image_id(self, i: int) -> int:
        return self._base.image_id(i)

    def __getitem__(self, i: int) -> Sample:
        info, img = self._base._load_image(i)
        H, W = img.shape[:2]
        K = self.kpt_shape[0]
        boxes, labels, kpts = [], [], []
        ig_boxes, ig_labels, _ = self._base._ignore_entries(
            info, W, H, with_masks=False)
        for a, box, label in self._base._instances(info, W, H):
            k = np.asarray(a.get("keypoints", [0.0] * (K * 3)),
                           np.float32).reshape(-1, 3)[:K]
            if len(k) < K:
                k = np.concatenate(
                    [k, np.zeros((K - len(k), 3), np.float32)])
            if not (k[:, 2] > 0).any():        # num_keypoints == 0
                ig_boxes.append(box)
                ig_labels.append(label)
                continue
            k[:, 0] /= W
            k[:, 1] /= H
            boxes.append(box)
            labels.append(label)
            kpts.append(k)
        out: Sample = {
            "image": img,
            "boxes": (np.asarray(boxes, np.float32) if boxes
                      else np.zeros((0, 4), np.float32)),
            "labels": (np.asarray(labels, np.int32) if boxes
                       else np.zeros((0,), np.int32)),
            "kpts": (np.stack(kpts) if kpts
                     else np.zeros((0, K, 3), np.float32))}
        if ig_boxes:
            out["ignore_boxes"] = np.asarray(ig_boxes, np.float32)
            out["ignore_labels"] = np.asarray(ig_labels, np.int32)
            out["ignore_masks"] = [None] * len(ig_boxes)
        return out


class SyntheticShapesDataset:
    """Procedural stand-in with exact GT (circles/rectangles on noise) —
    the dataset analogue of SyntheticCameraSource: lets the full training
    pipeline run (and be tested) without real data on disk."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (160, 160),
                 n_classes: int = 3, max_objects: int = 3, seed: int = 0):
        self.n, self.hw = n, hw
        self.n_classes, self.max_objects = n_classes, max_objects
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Sample:
        rng = np.random.default_rng((self.seed, i % self.n))
        h, w = self.hw
        img = (rng.uniform(0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
        n_obj = int(rng.integers(1, self.max_objects + 1))
        boxes, labels, polys = [], [], []
        for _ in range(n_obj):
            r = rng.uniform(0.08, 0.18) * min(h, w)
            cx = rng.uniform(r, w - r)
            cy = rng.uniform(r, h - r)
            cls = int(rng.integers(0, self.n_classes))
            color = (np.eye(3)[cls] * rng.uniform(0.7, 1.0) * 255)
            yy, xx = np.mgrid[0:h, 0:w]
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
            img[inside] = color.astype(np.uint8)
            boxes.append([cx / w, cy / h, 2 * r / w, 2 * r / h])
            labels.append(cls)
            ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
            polys.append(np.stack([(cx + r * np.cos(ang)) / w,
                                   (cy + r * np.sin(ang)) / h], -1
                                  ).astype(np.float32))
        return {"image": img,
                "boxes": np.asarray(boxes, np.float32),
                "labels": np.asarray(labels, np.int32),
                "polys": polys}

# ---------------------------------------------------------------------------
# Geometry helpers (normalized-coordinate space; shapes stay fixed)
# ---------------------------------------------------------------------------

def _resize_uint8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Host stretch-resize with the SAME 2-tap bilinear sampling as the
    on-device preprocess (ops/preprocess._tap_indices; half-pixel centers,
    cv2.INTER_LINEAR semantics) so training/eval images see exactly the
    deployment resampling — no train/serve skew. The port's C++ kernel
    (io/native.resize2tap_native, native/src/augment.cpp); a failed build
    raises. _resize2tap_numpy is its plain twin, held bit-equal in the
    tests."""
    if img.shape[:2] == tuple(hw):
        return img
    from xrseg_tpu_torch.io import native
    return native.resize2tap_native(img, hw)


def _resize2tap_numpy(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Numpy 2-tap gather (the native kernel's parity oracle), bit-equal to
    it: the sample positions in float32 as the C++ plan computes them
    (JAX's twin takes them in float64 and differs by 1 at rare pixels)."""
    from xrseg_tpu_torch.ops.preprocess import _tap_indices
    y0, y1, fy = _tap_indices(img.shape[0], hw[0], np.float32)
    x0, x1, fx = _tap_indices(img.shape[1], hw[1], np.float32)
    a = img.astype(np.float32)
    top = a[y0][:, x0] + fx[None, :, None] * (a[y0][:, x1] - a[y0][:, x0])
    bot = a[y1][:, x0] + fx[None, :, None] * (a[y1][:, x1] - a[y1][:, x0])
    return (top + fy[:, None, None] * (bot - top) + 0.5).astype(np.uint8)


def letterbox_sample(s: Sample, out_hw: Tuple[int, int]) -> Sample:
    """Aspect-preserving resize + gray(114) pad to out_hw (ultralytics
    letterbox semantics), with normalized boxes/polys remapped into the
    padded canvas. After this transform the default stretch pipeline is
    geometry-neutral (the image is already out_hw), so ONE transform
    gives both train-time and eval-time letterboxing — the A/B against
    the reference's stretch deploy (ToTensor, IEExecutor.cs:370)."""
    ih, iw = s["image"].shape[:2]
    oh, ow = out_hw
    r = min(oh / ih, ow / iw)
    ch, cw = max(1, round(ih * r)), max(1, round(iw * r))
    top, left = (oh - ch) // 2, (ow - cw) // 2
    img = np.full((oh, ow, 3), 114, np.uint8)
    img[top:top + ch, left:left + cw] = _resize_uint8(s["image"], (ch, cw))
    out = dict(s, image=img)
    sx, sy = cw / ow, ch / oh
    ox, oy = left / ow, top / oh
    if "boxes" in s:
        b = np.asarray(s["boxes"], np.float32).copy()
        if len(b):
            b[:, 0] = b[:, 0] * sx + ox
            b[:, 1] = b[:, 1] * sy + oy
            b[:, 2] *= sx
            b[:, 3] *= sy
        out["boxes"] = b
    if "polys" in s:
        out["polys"] = [None if p is None else
                        np.stack([p[:, 0] * sx + ox, p[:, 1] * sy + oy],
                                 -1).astype(np.float32)
                        for p in s["polys"]]
    return out



def rasterize_mask(poly: Optional[np.ndarray], box: np.ndarray,
                   mask_hw: Tuple[int, int]) -> np.ndarray:
    """GT instance mask at proto resolution: polygon fill when the label
    has one (PIL rasterizer), else the box itself (detect-format labels
    still give the seg loss a meaningful target)."""
    mh, mw = mask_hw
    if poly is not None and len(poly) >= 3:
        from PIL import Image, ImageDraw
        img = Image.new("L", (mw, mh), 0)
        pts = [(float(x * mw), float(y * mh)) for x, y in poly]
        ImageDraw.Draw(img).polygon(pts, fill=1)
        return np.asarray(img, np.float32)
    m = np.zeros((mh, mw), np.float32)
    x1 = int(np.clip((box[0] - box[2] / 2) * mw, 0, mw))
    x2 = int(np.ceil(np.clip((box[0] + box[2] / 2) * mw, 0, mw)))
    y1 = int(np.clip((box[1] - box[3] / 2) * mh, 0, mh))
    y2 = int(np.ceil(np.clip((box[1] + box[3] / 2) * mh, 0, mh)))
    m[y1:y2, x1:x2] = 1.0
    return m


# ---------------------------------------------------------------------------
# Task-family synthetic datasets (pose / obb / classify) — the exact-GT
# procedural stand-ins that let the tasks' eval paths run and be tested
# without real annotated data on disk.
# ---------------------------------------------------------------------------

class SyntheticPoseDataset:
    """Circles with K=5 keypoints each: center + 4 rim points (N/E/S/W),
    all visible. Normalized coords; exact GT."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (160, 160),
                 n_classes: int = 2, max_objects: int = 2, seed: int = 0):
        self.base = SyntheticShapesDataset(n, hw, n_classes, max_objects,
                                           seed)
        self.kpt_shape = (5, 3)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int):
        s = self.base[i]
        kpts = []
        for b in s["boxes"]:
            cx, cy, w, h = b
            r = w / 2
            pts = np.asarray([[cx, cy], [cx, cy - h / 2], [cx + r, cy],
                              [cx, cy + h / 2], [cx - r, cy]], np.float32)
            kpts.append(np.concatenate(
                [pts, np.ones((5, 1), np.float32)], -1))
        s = dict(s)
        s["kpts"] = (np.stack(kpts) if kpts
                     else np.zeros((0, 5, 3), np.float32))
        return s


class SyntheticOBBDataset:
    """Rotated filled rectangles with exact (cx, cy, w, h, angle) GT."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (160, 160),
                 n_classes: int = 2, max_objects: int = 2, seed: int = 0):
        self.n, self.hw = n, hw
        self.n_classes, self.max_objects = n_classes, max_objects
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng((self.seed, 7, i % self.n))
        h, w = self.hw
        img = (rng.uniform(0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
        n_obj = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(n_obj):
            bw = rng.uniform(0.15, 0.35) * w
            bh = rng.uniform(0.08, 0.18) * h
            ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4)
            m = max(bw, bh)
            cx = rng.uniform(m, w - m)
            cy = rng.uniform(m, h - m)
            cls = int(rng.integers(0, self.n_classes))
            ca, sa = np.cos(ang), np.sin(ang)
            # point-in-rotated-rect: rotate offsets into the box frame
            dx, dy = xx - cx, yy - cy
            u = dx * ca + dy * sa
            v = -dx * sa + dy * ca
            inside = (np.abs(u) < bw / 2) & (np.abs(v) < bh / 2)
            color = (np.eye(3)[cls] * rng.uniform(0.7, 1.0) * 255)
            img[inside] = color.astype(np.uint8)
            boxes.append([cx / w, cy / h, bw / w, bh / h, ang])
            labels.append(cls)
        return {"image": img,
                "boxes_xywhr": np.asarray(boxes, np.float32),
                "labels": np.asarray(labels, np.int32)}


class SyntheticClassifyDataset:
    """One dominant shape per image; label = its class."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (64, 64),
                 n_classes: int = 3, seed: int = 0):
        self.base = SyntheticShapesDataset(n, hw, n_classes,
                                           max_objects=1, seed=seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int):
        s = self.base[i]
        return {"image": s["image"], "label": int(s["labels"][0])}


# ---------------------------------------------------------------------------
# Ultralytics on-disk label formats for the extended tasks
# ---------------------------------------------------------------------------

def parse_yolo_pose_label_file(path: str, kpt_shape: Tuple[int, int]
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ultralytics pose label line: `cls cx cy w h x1 y1 v1 x2 y2 v2 ...`
    (normalized coords; v = 0/1/2 COCO visibility, or the 2-dim variant
    `x y` pairs without visibility). Returns (boxes [N,4] cxcywh,
    labels [N], kpts [N,K,3] with vis in {0,1} — v>=1 counts visible)."""
    K, D = kpt_shape
    boxes, labels, kpts = [], [], []
    if not os.path.exists(path):
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                np.zeros((0, K, 3), np.float32))
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 1 + 4 + K * D:
                continue
            labels.append(int(vals[0]))
            boxes.append(vals[1:5])
            k = np.asarray(vals[5:], np.float32).reshape(K, D)
            if D == 2:
                k = np.concatenate(
                    [k, np.ones((K, 1), np.float32)], -1)
            else:
                k = np.concatenate(
                    [k[:, :2], (k[:, 2:3] >= 1).astype(np.float32)], -1)
            kpts.append(k)
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                np.zeros((0, K, 3), np.float32))
    return (np.asarray(boxes, np.float32), np.asarray(labels, np.int32),
            np.stack(kpts))


def parse_yolo_obb_label_file(path: str,
                              img_hw: Tuple[int, int] = (1, 1)
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Ultralytics OBB label line (DOTA-style): `cls x1 y1 x2 y2 x3 y3
    x4 y4` — four normalized corner points in order. Geometry (edge
    lengths, angle) is computed in PIXEL space via `img_hw` — computing
    it on normalized coords would skew w/h/angle on non-square images —
    then re-normalized per-axis to match the SyntheticOBBDataset
    contract (cx/W, cy/H, w/W, h/H, angle in image radians). Returns
    (boxes_xywhr [N,5], labels [N])."""
    H, W = img_hw
    boxes, labels = [], []
    if not os.path.exists(path):
        return np.zeros((0, 5), np.float32), np.zeros((0,), np.int32)
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 9:
                continue
            pts = np.asarray(vals[1:], np.float32).reshape(4, 2)
            pts *= (W, H)
            # corners -> (cx, cy, w, h, angle): w along edge p0->p1,
            # h along p1->p2 (ultralytics xyxyxyxy2xywhr convention)
            cx, cy = pts.mean(0)
            e0 = pts[1] - pts[0]
            e1 = pts[2] - pts[1]
            w = float(np.hypot(*e0))
            h = float(np.hypot(*e1))
            ang = float(np.arctan2(e0[1], e0[0]))
            # fold into the model's (-pi/4, 3pi/4) angle range: the range
            # spans pi, and a rect at angle a == the same rect at a +/- pi
            while ang >= 3 * np.pi / 4:
                ang -= np.pi
            while ang < -np.pi / 4:
                ang += np.pi
            labels.append(int(vals[0]))
            boxes.append([cx / W, cy / H, w / W, h / H, ang])
    if not boxes:
        return np.zeros((0, 5), np.float32), np.zeros((0,), np.int32)
    return np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


class YoloPoseDataset:
    """Ultralytics pose dataset directory (images/ + labels/*.txt with
    keypoint lines). Samples speak the SyntheticPoseDataset contract."""

    def __init__(self, root: str, kpt_shape: Tuple[int, int] = (17, 3)):
        self._base = YoloDataset(root)
        self.kpt_shape = kpt_shape

    def __len__(self) -> int:
        return len(self._base)

    def __getitem__(self, i: int):
        from PIL import Image
        path = self._base.images[i % len(self._base.images)]
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        boxes, labels, kpts = parse_yolo_pose_label_file(
            self._base._label_for(path), self.kpt_shape)
        return {"image": img, "boxes": boxes, "labels": labels,
                "kpts": kpts}


class ImageFolderDataset:
    """Ultralytics classify layout: `root/<class_name>/*.jpg`, one folder
    per class, class ids assigned by sorted folder name. Samples speak
    the SyntheticClassifyDataset contract ({image, label})."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class folders under {root!r}")
        self.items: List[Tuple[str, int]] = []
        for cls_id, name in enumerate(self.classes):
            for ext in IMG_EXTS:
                for p in sorted(glob.glob(
                        os.path.join(root, name, "*" + ext))):
                    self.items.append((p, cls_id))
        if not self.items:
            raise FileNotFoundError(f"no images under {root!r}")

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        from PIL import Image
        path, label = self.items[i % len(self.items)]
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        return {"image": img, "label": label}


class YoloOBBDataset:
    """Ultralytics OBB dataset directory (DOTA-style 8-point labels).
    Samples speak the SyntheticOBBDataset contract."""

    def __init__(self, root: str):
        self._base = YoloDataset(root)

    def __len__(self) -> int:
        return len(self._base)

    def __getitem__(self, i: int):
        from PIL import Image
        path = self._base.images[i % len(self._base.images)]
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        boxes, labels = parse_yolo_obb_label_file(
            self._base._label_for(path), img.shape[:2])
        return {"image": img, "boxes_xywhr": boxes, "labels": labels}
