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

The training half (JAX data.py:496-982 and :1078-1208), line for line
the JAX package's numpy, so seeded host batches are bit-equal to its:

  augmentations   — hflip_sample, hsv_jitter (the port's C++ kernel,
                    io/native.hsv_jitter_native; _hsv_jitter_numpy is its
                    twin), scale_translate, mosaic4, copy_paste, mixup2,
                    and the task flips hflip_pose_sample/hflip_obb_sample.
  assembly        — AugmentConfig, _base_sample, augment_sample,
                    augment_task_sample; collate (detect/segment),
                    collate_pose, collate_obb, collate_classify.
  Loader          — the seeded epoch iterator: default_rng((seed, epoch,
                    i)) per sample, scale buckets, drop_last=False padding
                    with sample_weight, a prefetch thread, and the batches
                    as torch tensors on the Loader's device (pinned host
                    staging, non_blocking copies on a card).

Image files decode through PIL, imported lazily where a file is read,
as in the JAX package; the synthetic datasets need no PIL.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xrseg_tpu_torch.config import ModelConfig
from xrseg_tpu_torch.device import resolve_device

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


def hflip_sample(s: Sample) -> Sample:
    out = dict(s)
    out["image"] = s["image"][:, ::-1]
    b = s["boxes"].copy()
    if len(b):
        b[:, 0] = 1.0 - b[:, 0]
    out["boxes"] = b
    out["polys"] = [None if p is None else
                    np.stack([1.0 - p[:, 0], p[:, 1]], -1)
                    for p in s["polys"]]
    return out


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               h_gain: float = 0.015, s_gain: float = 0.7,
               v_gain: float = 0.4) -> np.ndarray:
    """Random HSV gains (the YOLO-family color augmentation) through the
    port's single-pass C++ kernel (io/native.hsv_jitter_native, the
    loader's hottest host op); a failed build raises. _hsv_jitter_numpy is
    its plain twin."""
    gains = rng.uniform(-1, 1, 3) * (h_gain, s_gain, v_gain) + 1.0
    from xrseg_tpu_torch.io import native
    return native.hsv_jitter_native(img, *gains)


def _hsv_jitter_numpy(img: np.ndarray, gains: np.ndarray) -> np.ndarray:
    """Vectorized numpy HSV round-trip on uint8 (the native kernel's
    twin: equal on all but rare hue-sextant boundary pixels, one step
    apart there)."""
    x = img.astype(np.float32) / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    c = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    hue = np.where(mx == r, ((g - b) / c) % 6,
                   np.where(mx == g, (b - r) / c + 2, (r - g) / c + 4)) / 6
    sat = np.where(mx > 0, c / (mx + 1e-12), 0.0)
    hue = (hue * gains[0]) % 1.0
    sat = np.clip(sat * gains[1], 0, 1)
    val = np.clip(mx * gains[2], 0, 1)
    k = (hue * 6).astype(np.int32) % 6
    f = hue * 6 - np.floor(hue * 6)
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    k = k[..., None]
    rgb = np.select(
        [k == 0, k == 1, k == 2, k == 3, k == 4, k == 5],
        [np.stack([val, t, p], -1), np.stack([q, val, p], -1),
         np.stack([p, val, t], -1), np.stack([p, q, val], -1),
         np.stack([t, p, val], -1), np.stack([val, p, q], -1)])
    return (rgb * 255.0 + 0.5).astype(np.uint8)


def scale_translate(s: Sample, rng: np.random.Generator,
                    scale: float = 0.4, translate: float = 0.1) -> Sample:
    """Random zoom + shift (normalized space), nearest-sampled on the pixel
    grid; boxes/polys follow the same affine. GT falling outside the view
    is dropped (degenerate boxes filtered by collate's min-size gate)."""
    h, w = s["image"].shape[:2]
    z = 1.0 + rng.uniform(-scale, scale)
    tx = rng.uniform(-translate, translate)
    ty = rng.uniform(-translate, translate)
    # output pixel (u,v) samples input at ((u/w - 0.5 - tx)/z + 0.5)*w
    uu = ((np.arange(w) / w - 0.5 - tx) / z + 0.5) * w
    vv = ((np.arange(h) / h - 0.5 - ty) / z + 0.5) * h
    ui = np.clip(np.round(uu).astype(np.int64), 0, w - 1)
    vi = np.clip(np.round(vv).astype(np.int64), 0, h - 1)
    oob_u = (uu < -0.5) | (uu > w - 0.5)
    oob_v = (vv < -0.5) | (vv > h - 0.5)
    img = s["image"][vi][:, ui]
    img[oob_v, :] = 114        # gray fill, the YOLO letterbox color
    img[:, oob_u] = 114
    out = dict(s)
    out["image"] = img

    def fwd_xy(xy: np.ndarray) -> np.ndarray:
        return (xy - 0.5) * z + 0.5 + np.asarray([tx, ty], np.float32)

    b = s["boxes"].copy()
    if len(b):
        b[:, :2] = fwd_xy(b[:, :2])
        b[:, 2:] = b[:, 2:] * z
        # clip to the visible frame, preserving cxcywh
        x1 = np.clip(b[:, 0] - b[:, 2] / 2, 0, 1)
        y1 = np.clip(b[:, 1] - b[:, 3] / 2, 0, 1)
        x2 = np.clip(b[:, 0] + b[:, 2] / 2, 0, 1)
        y2 = np.clip(b[:, 1] + b[:, 3] / 2, 0, 1)
        b = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    out["boxes"] = b
    out["polys"] = [None if p is None else fwd_xy(p) for p in s["polys"]]
    return out


def mosaic4(samples: Sequence[Sample], rng: np.random.Generator,
            out_hw: Tuple[int, int]) -> Sample:
    """Standard 4-image mosaic: each input is stretch-resized to out_hw,
    the four are placed around a random center on a [2H,2W] canvas, and
    the canvas is resized back down to out_hw. GT transforms per quadrant."""
    assert len(samples) == 4
    H, W = out_hw
    canvas = np.full((2 * H, 2 * W, 3), 114, np.uint8)
    cy = int(rng.uniform(0.5, 1.5) * H)
    cx = int(rng.uniform(0.5, 1.5) * W)
    # quadrant corner placements (y0, y1, x0, x1) on the canvas
    quads = [(0, cy, 0, cx), (0, cy, cx, 2 * W),
             (cy, 2 * H, 0, cx), (cy, 2 * H, cx, 2 * W)]
    boxes, labels, polys = [], [], []
    for s, (y0, y1, x0, x1) in zip(samples, quads):
        qh, qw = y1 - y0, x1 - x0
        canvas[y0:y1, x0:x1] = _resize_uint8(s["image"], (qh, qw))
        # normalized-in-quadrant -> normalized-in-canvas
        sx, sy = qw / (2 * W), qh / (2 * H)
        ox, oy = x0 / (2 * W), y0 / (2 * H)
        b = s["boxes"].copy()
        if len(b):
            b[:, 0] = b[:, 0] * sx + ox
            b[:, 1] = b[:, 1] * sy + oy
            b[:, 2] = b[:, 2] * sx
            b[:, 3] = b[:, 3] * sy
            boxes.append(b)
            labels.append(s["labels"])
            polys.extend(
                None if p is None else
                np.stack([p[:, 0] * sx + ox, p[:, 1] * sy + oy], -1)
                for p in s["polys"])
    out: Sample = {
        "image": _resize_uint8(canvas, (H, W)),
        "boxes": (np.concatenate(boxes) if boxes
                  else np.zeros((0, 4), np.float32)),
        "labels": (np.concatenate(labels) if labels
                   else np.zeros((0,), np.int32)),
        "polys": polys,
    }
    return out


def copy_paste(dst: Sample, src: Sample, rng: np.random.Generator,
               p: float = 0.5, max_paste: int = 3) -> Sample:
    """Segment copy-paste augmentation (Ghiasi et al. 2021; ultralytics'
    `copy_paste` option): donor instances that carry a polygon are
    rasterized at dst resolution and their pixels pasted into dst, with
    box/label/polygon appended to dst's GT. Both samples use normalized
    coordinates so no geometry conversion is needed; like ultralytics,
    pre-existing GT occluded by a paste is left as-is (the assigner's
    IoU weighting absorbs the noise)."""
    donors = [i for i, pl in enumerate(src["polys"])
              if pl is not None and len(pl) >= 3]
    if not donors or p <= 0:
        return dst
    h, w = dst["image"].shape[:2]
    src_img = _resize_uint8(src["image"], (h, w))
    img = dst["image"].copy()
    from PIL import Image, ImageDraw
    add_b, add_l, add_p = [], [], []
    for i in donors:
        if len(add_b) >= max_paste or rng.uniform() >= p:
            continue
        poly = src["polys"][i]
        m = Image.new("L", (w, h), 0)
        ImageDraw.Draw(m).polygon(
            [(float(x * w), float(y * h)) for x, y in poly], fill=1)
        m = np.asarray(m, bool)
        if not m.any():
            continue
        img[m] = src_img[m]
        add_b.append(src["boxes"][i])
        add_l.append(src["labels"][i])
        add_p.append(poly)
    if not add_b:
        return dst
    return {
        "image": img,
        "boxes": np.concatenate([dst["boxes"].reshape(-1, 4),
                                 np.stack(add_b)]).astype(np.float32),
        "labels": np.concatenate([dst["labels"],
                                  np.asarray(add_l, np.int32)]),
        "polys": list(dst["polys"]) + add_p,
    }


# ---------------------------------------------------------------------------
# Augmentation pipeline + collate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    mosaic: float = 1.0          # probability of 4-image mosaic
    mixup: float = 0.0           # probability of 2-image mixup blend
    hflip: float = 0.5
    hsv: bool = True
    scale: float = 0.4
    translate: float = 0.1
    copy_paste: float = 0.0      # per-instance paste probability (segment)
    min_box_px: float = 2.0      # drop GT smaller than this after augment
    # aspect-preserving letterbox of every raw sample (incl. mosaic
    # tiles) before augmentation, instead of the default stretch — the
    # ultralytics-training geometry (see letterbox_sample)
    letterbox: bool = False


def mixup2(a: Sample, b: Sample, rng: np.random.Generator) -> Sample:
    """YOLO-style mixup: pixel blend with lambda ~ Beta(32,32) (so ~0.5),
    GT sets CONCATENATED unweighted (ultralytics semantics — the loss
    sees both images' objects at full strength). Inputs must share HxW.
    kpts (pose) and boxes_xywhr (obb) merge too when both sides carry
    them."""
    lam = float(rng.beta(32.0, 32.0))
    img = np.clip(lam * a["image"].astype(np.float32)
                  + (1.0 - lam) * b["image"].astype(np.float32),
                  0, 255).astype(np.uint8)
    out: Sample = {
        "image": img,
        "labels": np.concatenate([a["labels"], b["labels"]], 0),
    }
    for key in ("boxes", "boxes_xywhr", "kpts"):
        if key in a and key in b:
            out[key] = np.concatenate([a[key], b[key]], 0)
    if "polys" in a and "polys" in b:
        out["polys"] = list(a["polys"]) + list(b["polys"])
    return out


def _base_sample(get, i: int, rng: np.random.Generator,
                 input_hw: Tuple[int, int], aug: AugmentConfig,
                 n_total: int) -> Sample:
    """mosaic-or-plain base image at input_hw (shared by main + mixup)."""
    if aug.letterbox:
        raw_get = get
        get = lambda j: letterbox_sample(raw_get(j), input_hw)  # noqa: E731
    if aug.mosaic > 0 and rng.uniform() < aug.mosaic:
        idx = [i] + list(rng.integers(0, n_total, 3))
        return mosaic4([get(j) for j in idx], rng, input_hw)
    s = get(i)
    return dict(s, image=_resize_uint8(s["image"], input_hw))


def augment_sample(get, i: int, rng: np.random.Generator,
                   input_hw: Tuple[int, int], aug: AugmentConfig,
                   n_total: int) -> Sample:
    """Assemble one augmented sample. `get(j)` fetches raw sample j."""
    s = _base_sample(get, i, rng, input_hw, aug, n_total)
    if aug.mixup > 0 and rng.uniform() < aug.mixup:
        other = _base_sample(get, int(rng.integers(0, n_total)), rng,
                             input_hw, aug, n_total)
        s = mixup2(s, other, rng)
    if aug.copy_paste > 0:
        donor = get(int(rng.integers(0, n_total)))
        s = copy_paste(s, donor, rng, aug.copy_paste)
    if aug.scale > 0 or aug.translate > 0:
        s = scale_translate(s, rng, aug.scale, aug.translate)
    if rng.uniform() < aug.hflip:
        s = hflip_sample(s)
    if aug.hsv:
        s = dict(s, image=hsv_jitter(s["image"], rng))
    return s


def collate(samples: Sequence[Sample], cfg: ModelConfig, max_gt: int,
            min_box_px: float = 2.0, with_masks: Optional[bool] = None,
            input_hw: Optional[Tuple[int, int]] = None
            ) -> Dict[str, np.ndarray]:
    """Fixed-shape padded batch in the train_step contract (model-pixel
    boxes, -1-padded labels, proto-resolution masks). `input_hw` overrides
    cfg.input_size for multi-scale training; the mask target tracks it at
    proto resolution (H//4, W//4)."""
    H, W = input_hw or cfg.input_size
    mh, mw = H // 4, W // 4
    if with_masks is None:
        with_masks = cfg.task == "segment"
    B = len(samples)
    images = np.zeros((B, H, W, 3), np.float32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.full((B, max_gt), -1, np.int32)
    masks = (np.zeros((B, max_gt, mh, mw), np.float32) if with_masks
             else None)
    for b, s in enumerate(samples):
        images[b] = _resize_uint8(s["image"], (H, W)).astype(np.float32) / 255
        n = 0
        for g in range(len(s["labels"])):
            bx = s["boxes"][g]
            if bx[2] * W < min_box_px or bx[3] * H < min_box_px:
                continue
            if n >= max_gt:
                break
            boxes[b, n] = bx * (W, H, W, H)
            labels[b, n] = s["labels"][g]
            if with_masks:
                poly = s["polys"][g] if g < len(s["polys"]) else None
                masks[b, n] = rasterize_mask(poly, bx, (mh, mw))
            n += 1
    out = {"images": images, "boxes_xywh": boxes, "labels": labels}
    if with_masks:
        out["masks"] = masks
    return out


# ---------------------------------------------------------------------------
# Prefetching loader
# ---------------------------------------------------------------------------

class Loader:
    """Epoch iterator: deterministic shuffled order, per-sample seeded
    augmentation, background prefetch, batches as torch tensors on
    `device`.

    Determinism: sample i of epoch e is augmented with
    rng = default_rng((seed, e, i)) regardless of thread timing, so runs
    reproduce exactly (and checkpoint-resume sees the same stream). The
    host batches are the JAX package's Loader's, bit for bit.
    """

    def __init__(self, dataset, cfg: ModelConfig, batch: int,
                 max_gt: int = 16, aug: AugmentConfig = AugmentConfig(),
                 seed: int = 0, mesh=None, prefetch: int = 2,
                 drop_last: bool = True,
                 scales: Optional[Sequence[Tuple[int, int]]] = None,
                 kpt_flip_idx: Optional[Sequence[int]] = None,
                 device="cuda"):
        """`scales`: optional multi-scale bucket list, e.g.
        [(512,512),(576,576),(640,640),(704,704)]. Each batch picks one
        bucket deterministically from (seed, epoch, step); the model's
        forward_train takes its anchors from the batch shape. All entries
        must be multiples of 32 (P5 stride).

        cfg.task selects the sample contract: detect/segment use the
        full augmentation pipeline + `collate`; pose/obb/classify use
        augment_task_sample + their task collate. `kpt_flip_idx`: pose
        keypoint left/right permutation applied on hflip.

        `mesh` (parallel/mesh.Mesh): each batch comes split over the data
        axis, a list of one dict per data row on the row's first device
        (the train step's sharded form; across processes, None for
        another process's rows); `device` is then the mesh's."""
        self.mesh = mesh
        if mesh is not None:
            if batch % mesh.shape["data"]:
                raise ValueError(f"batch {batch} not divisible by the "
                                 f"mesh's data axis {mesh.shape['data']}")
            self.device = mesh.first_device
        else:
            self.device = resolve_device(device)
        self.ds = dataset
        self.cfg = cfg
        self.batch = batch
        self.max_gt = max_gt
        self.aug = aug
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        if scales is not None:
            for hw in scales:
                if hw[0] % 32 or hw[1] % 32:
                    raise ValueError(f"scale {hw} not a multiple of 32")
        self.scales = list(scales) if scales else None
        self.kpt_flip_idx = kpt_flip_idx

    def steps_per_epoch(self) -> int:
        n = len(self.ds)
        return n // self.batch if self.drop_last else -(-n // self.batch)

    def _host_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        order = np.random.default_rng((self.seed, epoch)).permutation(n)
        for step, b0 in enumerate(
                range(0, n - (self.batch - 1) * self.drop_last, self.batch)):
            idx = order[b0:b0 + self.batch]
            if len(idx) == 0:
                break
            if self.scales:
                srng = np.random.default_rng((self.seed, epoch, step, 7))
                input_hw = self.scales[int(srng.integers(len(self.scales)))]
            else:
                input_hw = self.cfg.input_size
            task = self.cfg.task
            samples = []
            for i in idx:
                rng = np.random.default_rng((self.seed, epoch, int(i)))
                if task in ("pose", "obb", "classify"):
                    samples.append(augment_task_sample(
                        self.ds.__getitem__, int(i), rng, input_hw,
                        self.aug, task, self.kpt_flip_idx, n_total=n))
                else:
                    samples.append(augment_sample(
                        self.ds.__getitem__, int(i), rng, input_hw,
                        self.aug, n))
            if task == "pose":
                batch = collate_pose(samples, input_hw, self.max_gt)
            elif task == "obb":
                batch = collate_obb(samples, input_hw, self.max_gt)
            elif task == "classify":
                batch = collate_classify(samples, input_hw)
            else:
                batch = collate(samples, self.cfg, self.max_gt,
                                self.aug.min_box_px, input_hw=input_hw)
            if not self.drop_last:
                batch = self._pad_batch(batch, len(samples))
            yield batch

    def _pad_batch(self, batch: Dict[str, np.ndarray], n_real: int
                   ) -> Dict[str, np.ndarray]:
        """drop_last=False: pad the (possibly partial) batch to the
        configured size so every step shares one compiled shape and the
        leading axis stays divisible by the mesh data axis. Padding rows
        are zero images with no GT and sample_weight 0 — the loss removes
        them exactly (losses.detection_loss)."""
        pad = self.batch - n_real
        if pad > 0:
            out = {}
            for k, v in batch.items():
                fill = np.full((pad,) + v.shape[1:], -1 if k == "labels"
                               else 0, v.dtype)
                out[k] = np.concatenate([v, fill])
            batch = out
        # constant pytree structure across ALL steps (full batches too):
        # one jit trace per geometry, not one per remainder
        batch["sample_weight"] = np.concatenate(
            [np.ones(n_real, np.float32),
             np.zeros(self.batch - n_real, np.float32)])
        return batch

    def _staged(self, hb: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch as torch tensors, in pinned memory for a card."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in hb.items()}
        devices = ([self.device] if self.mesh is None
                   else list(self.mesh.devices.flat))
        if any(d.type == "cuda" for d in devices):
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _upload(self, hb: Dict[str, torch.Tensor]):
        """A staged batch on the Loader's device, or split over the mesh's
        data axis (parallel/mesh.shard_batch)."""
        if self.mesh is None:
            return {k: v.to(self.device, non_blocking=True)
                    for k, v in hb.items()}
        from xrseg_tpu_torch.parallel.mesh import shard_batch
        return shard_batch(hb, self.mesh)

    def epoch(self, epoch: int = 0) -> Iterator:
        """Batches of one epoch as tensors on the Loader's device (over a
        mesh, split over its data axis), made and staged (pinned, on a
        card) off-thread, copied with non_blocking.

        Abandoning the generator early (break / next(iter(...))) is safe:
        the finally block signals the producer and drains the queue so the
        thread always exits (bounded puts would otherwise block forever).
        A producer's exception is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        stop = threading.Event()
        failure: list = []             # producer exception, re-raised here

        def _put(item) -> bool:
            """stop-aware bounded put; False if the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for hb in self._host_batches(epoch):
                    if not _put(self._staged(hb)):
                        return
            except BaseException as e:   # surface to the training loop —
                failure.append(e)        # a swallowed error silently
            finally:                     # truncates every epoch
                # the SENTINEL must not be dropped when the queue is full
                # (the consumer would block forever). If stop is set the
                # consumer is gone and no longer reads the queue.
                _put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                hb = q.get()
                if hb is SENTINEL:
                    if failure:
                        raise failure[0]
                    break
                yield self._upload(hb)
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)


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


def collate_pose(samples: Sequence, input_hw: Tuple[int, int],
                 max_gt: int = 8) -> Dict[str, np.ndarray]:
    """Pose batch: images + px boxes/labels + kpts [B,G,K,3] (px, vis)."""
    H, W = input_hw
    B = len(samples)
    K = samples[0]["kpts"].shape[1] if samples[0]["kpts"].size else 5
    images = np.zeros((B, H, W, 3), np.float32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.full((B, max_gt), -1, np.int32)
    kpts = np.zeros((B, max_gt, K, 3), np.float32)
    for b, s in enumerate(samples):
        images[b] = _resize_uint8(s["image"], (H, W)).astype(np.float32) / 255
        n = min(len(s["labels"]), max_gt)
        boxes[b, :n] = s["boxes"][:n] * (W, H, W, H)
        labels[b, :n] = s["labels"][:n]
        k = s["kpts"][:n].copy()
        k[..., 0] *= W
        k[..., 1] *= H
        kpts[b, :n] = k
    return {"images": images, "boxes_xywh": boxes, "labels": labels,
            "kpts": kpts}


def collate_obb(samples: Sequence, input_hw: Tuple[int, int],
                max_gt: int = 8) -> Dict[str, np.ndarray]:
    """OBB batch: images + rotated px boxes [B,G,5] + labels."""
    H, W = input_hw
    B = len(samples)
    images = np.zeros((B, H, W, 3), np.float32)
    boxes = np.zeros((B, max_gt, 5), np.float32)
    labels = np.full((B, max_gt), -1, np.int32)
    for b, s in enumerate(samples):
        images[b] = _resize_uint8(s["image"], (H, W)).astype(np.float32) / 255
        n = min(len(s["labels"]), max_gt)
        bx = s["boxes_xywhr"][:n].copy()
        bx[:, 0] *= W
        bx[:, 1] *= H
        bx[:, 2] *= W
        bx[:, 3] *= H
        boxes[b, :n] = bx
        labels[b, :n] = s["labels"][:n]
    return {"images": images, "boxes_xywhr": boxes, "labels": labels}


def collate_classify(samples: Sequence, input_hw: Tuple[int, int]
                     ) -> Dict[str, np.ndarray]:
    H, W = input_hw
    images = np.stack([_resize_uint8(s["image"], (H, W)) for s in samples]
                      ).astype(np.float32) / 255
    labels = np.asarray([s["label"] for s in samples], np.int32)
    return {"images": images, "labels": labels}


# ---------------------------------------------------------------------------
# Task-family augmentation (geometry-aware hflip + color)
# ---------------------------------------------------------------------------

def hflip_pose_sample(s, flip_idx: Optional[Sequence[int]] = None):
    """Horizontal flip of a pose sample: image mirrored, box centers and
    visible keypoint x mirrored in normalized space. `flip_idx` permutes
    keypoints into their left/right-symmetric slots (COCO-style skeletons
    swap left/right joints under a mirror — without the permutation the
    flipped GT would label a left wrist as a right wrist)."""
    out = dict(s)
    out["image"] = s["image"][:, ::-1]
    b = s["boxes"].copy()
    if len(b):
        b[:, 0] = 1.0 - b[:, 0]
    out["boxes"] = b
    k = s["kpts"].copy()
    if k.size:
        # invisible slots (v=0) are zero-filled; leave them at 0 so the
        # padding contract survives the flip
        k[..., 0] = np.where(k[..., 2] > 0, 1.0 - k[..., 0], k[..., 0])
        if flip_idx is not None:
            k = k[:, np.asarray(flip_idx)]
    out["kpts"] = k
    return out


def hflip_obb_sample(s):
    """Horizontal flip of an OBB sample: the w-edge direction
    (cos a, sin a) mirrors to (-cos a, sin a), i.e. a -> pi - a, folded
    back into the model's (-pi/4, 3pi/4) range by the rectangle's pi
    symmetry."""
    out = dict(s)
    out["image"] = s["image"][:, ::-1]
    b = s["boxes_xywhr"].copy()
    if len(b):
        b[:, 0] = 1.0 - b[:, 0]
        a = np.pi - b[:, 4]
        a = np.where(a >= 3 * np.pi / 4, a - np.pi, a)
        a = np.where(a < -np.pi / 4, a + np.pi, a)
        b[:, 4] = a
    out["boxes_xywhr"] = b
    return out


def augment_task_sample(get, i: int, rng: np.random.Generator,
                        input_hw: Tuple[int, int], aug: AugmentConfig,
                        task: str,
                        flip_idx: Optional[Sequence[int]] = None,
                        n_total: int = 0):
    """Task-family counterpart of augment_sample: stretch-resize +
    mixup (pose/obb) + geometry-aware hflip + HSV jitter. Mosaic /
    affine / copy-paste are detect/segment-only (they operate on polygon
    masks); classify rejects mixup (hard int labels — soft-label CE is a
    different loss contract). The task path keeps the same deterministic
    per-(seed, epoch, i) RNG contract."""
    s = get(i)
    s = dict(s, image=_resize_uint8(s["image"], input_hw))
    if aug.mixup > 0:
        if task == "classify":
            raise ValueError("mixup is unsupported for the classify task"
                             " (labels are hard ints; soft-label CE is a"
                             " different loss contract)")
        if n_total > 0 and rng.uniform() < aug.mixup:
            other = get(int(rng.integers(0, n_total)))
            other = dict(other,
                         image=_resize_uint8(other["image"], input_hw))
            s = mixup2(s, other, rng)
    if rng.uniform() < aug.hflip:
        if task == "pose":
            s = hflip_pose_sample(s, flip_idx)
        elif task == "obb":
            s = hflip_obb_sample(s)
        else:                                    # classify: image only
            s = dict(s, image=s["image"][:, ::-1])
    if aug.hsv:
        s = dict(s, image=hsv_jitter(s["image"], rng))
    return s


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
