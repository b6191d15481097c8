"""Class-label registry (ref: IEBoxer label asset loading, IEBoxer.cs:31-35,
Assets/Resources/Model/yolo11n-labels.txt). The standard 80-class COCO list
is embedded as the default; a custom list can be loaded from file.
"""
from __future__ import annotations

from typing import List, Sequence

COCO_LABELS: List[str] = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


def load_labels(path: str | None = None) -> List[str]:
    """Load labels from a newline-separated file, or the COCO default."""
    if path is None:
        return list(COCO_LABELS)
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def class_name(labels: Sequence[str], label_id: int) -> str:
    """GetClassName semantics incl. space->underscore and 'unknown' fallback
    (IEBoxer.cs:183-188)."""
    if label_id < 0 or label_id >= len(labels):
        return "unknown"
    return labels[label_id].replace(" ", "_")
