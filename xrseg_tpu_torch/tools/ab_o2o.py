"""NMS-free against NMS accuracy A/B: ONE dual-head checkpoint, two
deploys (the port's tools/ab_o2o.py).

Trains a dual-head model (ModelConfig.o2o: the one-to-many head and the
YOLOv10-style one-to-one head) on the synthetic-shapes dataset's exact
GT, then evaluates the SAME weights through both deploy modes, each at
the deploy gate and at 0.005:

  o2o_nms_free  top-K from the one-to-one head, no NMS in the program
  classic_nms   the classic head + exact greedy NMS (K1 on the card)

The delta prices what the NMS-free convenience costs (or does not) in
mAP. The donor defaults to the reference's deployed .sentis under
$XRSEG_REFERENCE; without it (or with --weights none) training starts
from random init at lr >= 5e-4. --out also writes <out>.student.npz, the
trained weights in the JAX package's npz layout.

    python -m xrseg_tpu_torch.tools.ab_o2o --size 640 --epochs 18
    python -m xrseg_tpu_torch.tools.ab_o2o --device cpu --size 96 \\
        --epochs 18
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from xrseg_tpu_torch.tools._donor import optional_donor, rounded


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=18)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weights", default=None,
                    help="donor weights ('none' for random init; default: "
                         "the reference's .sentis under $XRSEG_REFERENCE). "
                         "The o2o head starts from the donor's detect head")
    ap.add_argument("--score-gate", type=float, default=0.05,
                    help="eval score threshold (applies to BOTH deploys)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.device import resolve_device
    from xrseg_tpu_torch.eval.dataset_eval import evaluate_dataset
    from xrseg_tpu_torch.io import weights as W
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    size = args.size
    cfg = ModelConfig(scale="n", input_size=(size, size), num_classes=3,
                      dtype="float32", o2o=True)
    train_ds = D.SyntheticShapesDataset(n=args.n_train, hw=(size, size),
                                        n_classes=3)
    val_ds = D.SyntheticShapesDataset(n=args.n_val, hw=(size, size),
                                      n_classes=3, seed=1)

    params = None
    lr = args.lr
    path = optional_donor(args.weights)
    if path is not None:
        donor_cfg = ModelConfig(scale="n", input_size=(size, size),
                                num_classes=80, dtype="float32")
        donor, _ = W.load_params_auto(path, donor_cfg)
        params, rep = W.transfer_params(donor, cfg)
        print(f"graft from {path}: {rep['copied']} copied, "
              f"{len(rep['reinit'])} reinit (incl. the o2o head)",
              flush=True)
    else:
        lr = max(lr, 5e-4)                  # random init needs more

    tr = Trainer(cfg, TrainConfig(epochs=args.epochs, batch=args.batch,
                                  lr=lr, max_gt=8, ckpt_dir=None),
                 params=params, device=dev)
    tr.fit(train_ds, val_dataset=None)
    trained = tr.eval_params

    if args.out:
        W.save_npz(args.out + ".student.npz", trained)

    # short schedules leave the o2o head's ABSOLUTE confidence low (one
    # positive per GT calibrates slowly; YOLOv10 trains 500 epochs); mAP
    # ranks, so each mode is scored at the deploy gate AND at a low gate
    # that admits the uncalibrated but ranked detections
    results = {}
    classic = dataclasses.replace(cfg, o2o=False)
    for mode, mcfg in (("o2o_nms_free", cfg), ("classic_nms", classic)):
        model = W.with_config(trained, mcfg)   # classic: no o2o head
        for gate in sorted({args.score_gate, 0.005}, reverse=True):
            r = evaluate_dataset(mcfg, model, val_ds, batch=8,
                                 score_threshold=gate, device=dev)
            key = f"{mode}@{gate}"
            results[key] = r
            print(json.dumps({"config": key, **rounded(r)}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
