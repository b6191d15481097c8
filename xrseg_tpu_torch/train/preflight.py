"""Device-memory preflight for the train step (counterpart of
xrseg_tpu/train/preflight.py).

Before the first step the trainer estimates the step's peak device memory
and raises `grad_accum` (smaller microbatches, the same effective batch)
with a logged line instead of dying out of memory mid-run.

The JAX package estimates from a jaxpr, by a liveness scan over the traced
step. Eager PyTorch has no such program to walk, so the port measures:
the step's forward and backward (its microbatches in turn) on zero-filled
inputs on the card, between `torch.cuda.reset_peak_memory_stats` and
`max_memory_allocated`, plus what the optimizer's update adds on top (its
moments if they are not allocated yet, and its temporaries). The
parameters and the optimizer state are left as they were. The choice of
grad_accum is the JAX package's (`auto_grad_accum`: the same valid accums,
the 0.6 margin, the same log lines).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# the update's temporaries, in parameter-sized tensors: the clipped grads,
# their squares, the denominator, the update and the weight-decay term
# (train_step.Optimizer.update)
UPDATE_TEMPORARIES = 5


def batch_shapes(cfg, batch: int, max_gt: int,
                 input_hw: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{key: (shape, dtype)} of data.collate's fixed-shape batch."""
    H, W = input_hw or cfg.input_size
    if cfg.task == "classify":
        return {"images": ((batch, H, W, 3), torch.float32),
                "labels": ((batch,), torch.int32),
                "sample_weight": ((batch,), torch.float32)}
    out = {"images": ((batch, H, W, 3), torch.float32),
           "boxes_xywh": ((batch, max_gt, 4), torch.float32),
           "labels": ((batch, max_gt), torch.int32),
           "sample_weight": ((batch,), torch.float32)}
    if cfg.task == "segment":
        out["masks"] = ((batch, max_gt, H // 4, W // 4), torch.float32)
    elif cfg.task == "pose":
        # JAX reads cfg.num_keypoints, which ModelConfig does not have (its
        # pose preflight raises and is skipped); the port reads kpt_shape
        out["kpts"] = ((batch, max_gt, cfg.kpt_shape[0], 3), torch.float32)
    elif cfg.task == "obb":
        out["boxes_xywhr"] = ((batch, max_gt, 5), torch.float32)
    return out


def estimate_step_bytes(step_fn, state, batch_shapes) -> int:
    """Peak device bytes of one step of `step_fn` (train_step.TrainStep):
    its forward and backward over a zero-filled batch (labels -1: no GT),
    one microbatch at a time as the step runs them, measured on the card,
    plus the optimizer's moments if not yet allocated and its update's
    temporaries. Raises without a card: there is nothing to measure on the
    CPU.

    A step over a mesh is measured by its `shard_step` on the first
    device, with `batch_shapes` one data shard's batch, and with the
    state's FSDP leaves gathered, as they are during a step."""
    from xrseg_tpu_torch.train.train_step import full_weights

    step_fn = getattr(step_fn, "shard_step", step_fn)
    with full_weights(state) as model:
        return _measure(step_fn, state, model, batch_shapes)


def _measure(step_fn, state, model, batch_shapes) -> int:
    params = list(model.parameters())
    dev = params[0].device
    if dev.type != "cuda":
        raise RuntimeError("the step's peak memory is measured on the card; "
                           f"the model is on {dev}")
    batch = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k, (shape, dtype) in batch_shapes.items()}
    batch["labels"].fill_(-1)
    saved = [p.grad for p in params]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        step_fn.compute_grads(model, batch)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for p, g in zip(params, saved):
            p.grad = g
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    moments = 0 if state.opt_state.get("mu") else 2 * param_bytes
    return int(peak + moments + UPDATE_TEMPORARIES * param_bytes)


def hbm_budget_bytes(device=None) -> Optional[int]:
    """The card's memory in bytes; None on the CPU (no meaningful limit)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def auto_grad_accum(build_step, state, batch_sds, budget: int,
                    batch: int, start: int = 1, data_shards: int = 1,
                    margin: float = 0.6,
                    log=print) -> Tuple[int, int]:
    """Smallest valid grad_accum whose estimated step fits margin*budget.

    build_step(grad_accum) -> step_fn. Valid accum values divide `batch`
    and keep the microbatch divisible by `data_shards`. Returns
    (grad_accum, estimated_bytes); if nothing fits, returns the largest
    valid accum with a warning — the step may still fit.

    margin=0.6 leaves room for the allocator's fragmentation, cuDNN
    workspaces and what the measured step does not hold (the EMA copy,
    the validation pipeline, the prefetched batches)."""
    cap = int(margin * budget)

    def valid(a):
        return batch % a == 0 and (batch // a) % data_shards == 0

    accums = [a for a in range(start, batch + 1) if valid(a)]
    if not accums:
        accums = [start]
    est = 0
    for a in accums:
        est = estimate_step_bytes(build_step(a), state, batch_sds)
        if est <= cap:
            if a != start:
                log(f"preflight: estimated step peak {est/1e9:.2f} GB > "
                    f"{margin:.0%} of {budget/1e9:.2f} GB HBM at "
                    f"grad_accum={start}; auto-split to grad_accum={a} "
                    f"(microbatch {batch//a})")
            return a, est
    log(f"preflight: WARNING no grad_accum fits — best estimate "
        f"{est/1e9:.2f} GB vs budget {budget/1e9:.2f} GB; proceeding "
        f"with grad_accum={accums[-1]}")
    return accums[-1], est
