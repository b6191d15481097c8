"""Active-learning A/B: does spending the label budget on the most
UNCERTAIN frames beat spending it at random? (the port's
tools/ab_active.py)

Measured end to end on in-repo exact GT (synthetic shapes):

  1. SEED model: yolo11n grafted from the donor (80 -> 3 classes),
     fine-tuned on a small fixed seed set S0.
  2. The seed model RANKS the rest of the pool by uncertainty
     (train/active.rank_frames, flip consistency by default) and
     PSEUDO-LABELS it (train/pseudo.generate_pseudo_samples); on the card
     both run K1 per frame.
  3. Students CONTINUE from the seed model (new labels arrive, training
     resumes), each from an untouched copy of it, equalized to the same
     optimizer step count; the arms differ ONLY in which frames carry
     real GT:
       random_k_only : S0 + K random pool frames, GT only (rest unused)
       active_k_only : S0 + K most-uncertain frames, GT only
       pseudo_only   : S0 GT + pseudo labels everywhere else
       random_k_mix  : S0 + K random GT + pseudo rest
       active_k_mix  : S0 + K most-uncertain GT + pseudo rest
       full_gt       : every frame GT (the supervision ceiling)
     The *_only pair is the clean active-learning claim (identical
     budget, selection the only variable); the *_mix pair prices the
     combination with self-training.
  4. Every student is evaluated through the deployed pipeline on
     held-out GT.

The donor is required (there is no random-init route): --weights takes
any file io/weights.load_params_auto reads (.sentis, .npz, .pt, .onnx);
unset, the reference's deployed .sentis under $XRSEG_REFERENCE.

    python -m xrseg_tpu_torch.tools.ab_active --size 640 --batch 8
    python -m xrseg_tpu_torch.tools.ab_active --device cpu --size 96 \\
        --weights donor.npz
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from xrseg_tpu_torch.tools._donor import required_donor


class _ListDataset:
    """A train-ready Sample list as a dataset (the data.Loader protocol)."""

    def __init__(self, samples):
        self._s = list(samples)

    def __len__(self):
        return len(self._s)

    def __getitem__(self, i):
        return self._s[i]


def _row(r: dict) -> dict:
    return {k: round(float(v), 4) for k, v in r.items()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--n-train", type=int, default=128,
                    help="pool size (incl. the seed set)")
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--seed-set", type=int, default=8,
                    help="frames every arm gets GT for (trains the "
                         "seed/ranking model)")
    ap.add_argument("--budget", type=int, default=16,
                    help="K: additional GT labels per arm")
    ap.add_argument("--strategy", default="flip",
                    choices=["margin", "flip"])
    ap.add_argument("--epochs", type=int, default=12,
                    help="student epochs (all arms identical)")
    ap.add_argument("--seed-epochs", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weights", default=None,
                    help="donor weights (default: the reference's .sentis "
                         "under $XRSEG_REFERENCE)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    import numpy as np

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.device import resolve_device
    from xrseg_tpu_torch.eval.dataset_eval import evaluate_dataset
    from xrseg_tpu_torch.io import weights as W
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train.active import rank_frames
    from xrseg_tpu_torch.train.pseudo import generate_pseudo_samples
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    path = required_donor(args.weights, "ab_active")
    hw = (args.size, args.size)
    mcfg = ModelConfig(scale="n", input_size=hw, num_classes=3,
                       dtype="float32")
    train_ds = D.SyntheticShapesDataset(n=args.n_train, hw=hw, n_classes=3)
    val_ds = D.SyntheticShapesDataset(n=args.n_val, hw=hw, n_classes=3,
                                      seed=1)
    S0 = list(range(args.seed_set))
    pool = list(range(args.seed_set, len(train_ds)))

    # --- 1. seed model on S0 ---
    donor_cfg = ModelConfig(scale="n", input_size=hw, num_classes=80,
                            dtype="float32")
    donor, _ = W.load_params_auto(path, donor_cfg)
    init, rep = W.transfer_params(donor, mcfg)
    print(f"graft: {rep['copied']} leaves copied", flush=True)
    seed_tr = Trainer(mcfg, TrainConfig(epochs=args.seed_epochs,
                                        batch=min(args.batch, len(S0)),
                                        lr=args.lr, max_gt=8,
                                        ckpt_dir=None),
                      params=init, device=dev)
    seed_tr.fit(_ListDataset([train_ds[i] for i in S0]), val_dataset=None,
                verbose=False)
    seed_params = seed_tr.eval_params
    print(json.dumps({"config": "seed_model", **_row(evaluate_dataset(
        mcfg, seed_params, val_ds, batch=8, device=dev))}), flush=True)

    # --- 2. rank + pseudo-label the pool with the seed model ---
    ecfg = ExecutorConfig(model=mcfg)
    ranked = rank_frames(ecfg, seed_params,
                         (train_ds[i]["image"] for i in pool),
                         strategy=args.strategy, device=dev)
    ranked_pool = [pool[i] for i, _ in ranked]      # most-uncertain first
    pseudo = generate_pseudo_samples(
        ecfg, seed_params, (train_ds[i]["image"] for i in pool),
        score_gate=0.5, device=dev)
    pseudo_by_idx = dict(zip(pool, pseudo))
    n_det = sum(len(s["labels"]) for s in pseudo)
    print(f"pool {len(pool)}: {n_det} pseudo detections; "
          f"top-uncertain {ranked_pool[:args.budget][:8]}...", flush=True)

    rng = np.random.default_rng(0)
    random_k = [int(i) for i in rng.choice(pool, args.budget,
                                           replace=False)]
    active_k = ranked_pool[:args.budget]
    overlap = len(set(random_k) & set(active_k))
    # (gt_indices, include_pseudo_for_the_rest)
    arms = {
        "random_k_only": (set(random_k), False),
        "active_k_only": (set(active_k), False),
        "pseudo_only": (set(), True),
        "random_k_mix": (set(random_k), True),
        "active_k_mix": (set(active_k), True),
        "full_gt": (set(pool), False),
    }

    # --- 3. one student per arm: continue FROM the seed model, equal
    # optimizer steps (datasets differ in size, so epochs are derived) ---
    target_steps = args.epochs * (len(train_ds) // args.batch)
    results = {"protocol": {
        "size": args.size, "pool": len(pool), "seed_set": len(S0),
        "budget": args.budget, "strategy": args.strategy,
        "target_steps": target_steps, "random_active_overlap": overlap}}
    for arm, (labeled, with_pseudo) in arms.items():
        samples = []
        for i in range(len(train_ds)):
            if i in labeled or i < args.seed_set:
                samples.append(train_ds[i])          # real GT
            elif with_pseudo:
                samples.append(pseudo_by_idx[i])     # seed-model labels
        bs = min(args.batch, len(samples))
        steps_per_epoch = max(len(samples) // bs, 1)
        epochs = max(round(target_steps / steps_per_epoch), 1)
        # Trainer trains a copy of `params`: every arm starts from the
        # seed model as the seed trainer left it
        tr = Trainer(mcfg, TrainConfig(epochs=epochs, batch=bs,
                                       lr=args.lr, max_gt=8,
                                       ckpt_dir=None),
                     params=seed_params, device=dev)
        tr.fit(_ListDataset(samples), val_dataset=None, verbose=False)
        r = evaluate_dataset(mcfg, tr.eval_params, val_ds, batch=8,
                             device=dev)
        results[arm] = {k: float(v) for k, v in r.items()}
        print(json.dumps({"config": arm, "n_train_images": len(samples),
                          "epochs": epochs, **_row(r)}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
