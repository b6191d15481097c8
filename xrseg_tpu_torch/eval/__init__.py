"""Evaluation of the port (counterpart of xrseg_tpu/eval): COCO-style
mAP, OKS AP, rotated AP and top-1 through the deployed pipeline on a
dataset, MOT metrics for the tracker, and parity reports against an
independent CPU oracle. `python -m xrseg_tpu_torch.eval --help`."""
from xrseg_tpu_torch.eval import dataset_eval, metrics, mot  # noqa: F401
from xrseg_tpu_torch.eval.dataset_eval import (evaluate_dataset,  # noqa: F401
                                               evaluate_task_dataset)
from xrseg_tpu_torch.eval.metrics import (Detection,  # noqa: F401
                                          GroundTruth, evaluate)
from xrseg_tpu_torch.eval.mot import evaluate_mot, track_sequence  # noqa: F401
