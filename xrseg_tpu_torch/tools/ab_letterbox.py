"""Letterbox-against-stretch A/B on in-repo ground truth (the port's
tools/ab_letterbox.py).

The reference STRETCHES frames into the model square (ToTensor,
IEExecutor.cs:370); ultralytics models are letterbox-trained. This tool
prices each train/deploy geometry on the synthetic-shapes dataset's
exact GT (train/data.py): the same init is trained twice on NON-SQUARE
3:4 source frames, stretch-augmented and letterbox-augmented, and each
checkpoint is evaluated under BOTH deploy geometries
(eval/dataset_eval.py resize_mode), giving the 2x2 matrix

              deploy=stretch   deploy=letterbox
  train=stretch      A                B
  train=letterbox    C                D

A against D is the like-for-like comparison; B and C price a train/deploy
geometry MISMATCH (an ultralytics letterbox-trained checkpoint run
through the reference's stretch deploy).

Both arms fine-tune from the donor (80 -> 3 classes through
io/weights.transfer_params): by default the reference's deployed .sentis
under $XRSEG_REFERENCE; --weights none, or no such file, trains from
random init (lr 5e-4 unless --lr).

    python -m xrseg_tpu_torch.tools.ab_letterbox --size 640 --epochs 12
    python -m xrseg_tpu_torch.tools.ab_letterbox --device cpu --size 128 \\
        --epochs 8
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from xrseg_tpu_torch.tools._donor import optional_donor, rounded


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 1e-4 fine-tune / 5e-4 random init")
    ap.add_argument("--weights", default=None,
                    help="donor weights to fine-tune from ('none' for "
                         "random init; default: the reference's .sentis "
                         "under $XRSEG_REFERENCE)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.device import resolve_device
    from xrseg_tpu_torch.eval.dataset_eval import evaluate_dataset
    from xrseg_tpu_torch.io import weights as W
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    size = args.size
    # 3:4 source frames: the stretch/letterbox distinction is real
    data_hw = (int(size * 0.75) // 32 * 32 or 32, size)
    cfg = ModelConfig(scale="n", input_size=(size, size),
                      num_classes=3, dtype="float32")
    train_ds = D.SyntheticShapesDataset(n=args.n_train, hw=data_hw,
                                        n_classes=3)
    val_ds = D.SyntheticShapesDataset(n=args.n_val, hw=data_hw,
                                      n_classes=3, seed=1)
    print(f"source frames {data_hw}, model {size}x{size}, "
          f"{args.n_train} train / {args.n_val} val", flush=True)

    init_params = None
    path = optional_donor(args.weights)
    if path is not None:
        donor_cfg = ModelConfig(scale="n", input_size=(size, size),
                                num_classes=80, dtype="float32")
        donor, _ = W.load_params_auto(path, donor_cfg)
        init_params, rep = W.transfer_params(donor, cfg)
        print(f"fine-tuning from {path}: {rep['copied']} leaves "
              f"copied, {len(rep['reinit'])} reinitialized", flush=True)
    lr = args.lr if args.lr is not None else \
        (1e-4 if init_params is not None else 5e-4)

    results = {}
    params_by_mode = {}
    for mode in ("stretch", "letterbox"):
        aug = D.AugmentConfig(letterbox=(mode == "letterbox"))
        tcfg = TrainConfig(epochs=args.epochs, batch=args.batch,
                           lr=lr, max_gt=8, aug=aug, ckpt_dir=None)
        # the same init for both arms: Trainer copies init_params, and
        # without one both draw from TrainConfig.seed
        tr = Trainer(cfg, tcfg, params=init_params, device=dev)
        tr.fit(train_ds, val_dataset=None)
        params_by_mode[mode] = tr.eval_params
        print(f"trained {mode}: final loss "
              f"{tr.history[-1].get('loss'):.4f}", flush=True)

    for tmode, params in params_by_mode.items():
        for dmode in ("stretch", "letterbox"):
            r = evaluate_dataset(cfg, params, val_ds, batch=8,
                                 resize_mode=dmode, device=dev)
            key = f"train_{tmode}__deploy_{dmode}"
            results[key] = rounded(r)
            print(json.dumps({"config": key, **results[key]}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
