"""Distillation A/B: does teacher supervision beat GT-only training? (the
port's tools/ab_distill.py)

Protocol (in-repo exact GT, synthetic-shapes dataset):
  1. TEACHER: yolo11n fine-tuned from the donor (80 -> 3 class graft)
     until it is good on the dataset.
  2. yolov8n STUDENTS from the SAME init (init_train_state, generator
     seed 1), trained step for step on the SAME batch stream
     (np.random.default_rng(0)) with the SAME optimizer:
       scratch: ground-truth detection loss only
       distill: ground-truth loss + teacher response KL
                (train/distill.py, det_weight=1)
     and with --pure-arm, --pseudo-arm, --combo-arm: teacher responses
     only; the teacher's hard detections as GT; both.
  3. Every student, and the teacher, is evaluated through the deployed
     pipeline (eval/dataset_eval.py; K1 on the card) on a held-out split.

The delta prices distillation honestly on data whose GT is exact.
Cross-generation on purpose (v11 teacher -> v8 student): the expected
migration use. --label-fraction < 1 masks the GT of the images past that
fraction in every collated batch (the semi-supervised setting).

The donor is required (there is no random-init route): --weights takes
any file io/weights.load_params_auto reads (.sentis, .npz, .pt, .onnx);
unset, the reference's deployed .sentis under $XRSEG_REFERENCE.

    python -m xrseg_tpu_torch.tools.ab_distill --size 640 --steps 600
    python -m xrseg_tpu_torch.tools.ab_distill --device cpu --size 96 \\
        --steps 300 --weights donor.npz
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from xrseg_tpu_torch.tools._donor import required_donor, rounded


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--steps", type=int, default=300,
                    help="student steps per arm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--teacher-epochs", type=int, default=6)
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--det-weight", type=float, default=1.0)
    ap.add_argument("--cls-weight", type=float, default=1.0)
    ap.add_argument("--box-weight", type=float, default=1.0)
    ap.add_argument("--fg-power", type=float, default=1.0)
    ap.add_argument("--temp", type=float, default=2.0)
    ap.add_argument("--label-fraction", type=float, default=1.0,
                    help="fraction of train images whose GT the students "
                         "see (the rest are unlabeled; the distill arm "
                         "still gets teacher responses on ALL of them: "
                         "the semi-supervised setting)")
    ap.add_argument("--pure-arm", action="store_true",
                    help="add a det_weight=0 arm: teacher responses "
                         "ONLY, zero labels")
    ap.add_argument("--pseudo-arm", action="store_true",
                    help="add a self-training arm: the teacher's HARD "
                         "detections (incl. polygonized masks) replace "
                         "GT entirely; zero labels, standard loss")
    ap.add_argument("--combo-arm", action="store_true",
                    help="add a hard+soft arm: pseudo-label GT plus the "
                         "response KL, still zero real labels")
    ap.add_argument("--weights", default=None,
                    help="teacher donor weights (default: the reference's "
                         ".sentis under $XRSEG_REFERENCE)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from xrseg_tpu_torch.config import ExecutorConfig, ModelConfig
    from xrseg_tpu_torch.device import resolve_device
    from xrseg_tpu_torch.eval.dataset_eval import evaluate_dataset
    from xrseg_tpu_torch.io import weights as W
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train import distill as dst
    from xrseg_tpu_torch.train import train_step as ts
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    path = required_donor(args.weights, "ab_distill")
    size = args.size
    hw = (size, size)
    tcfg_model = ModelConfig(scale="n", input_size=hw, num_classes=3,
                             dtype="float32")
    scfg = ModelConfig(arch="yolov8", scale="n", input_size=hw,
                       num_classes=3, dtype="float32")
    train_ds = D.SyntheticShapesDataset(n=args.n_train, hw=hw, n_classes=3)
    val_ds = D.SyntheticShapesDataset(n=args.n_val, hw=hw, n_classes=3,
                                      seed=1)

    # --- 1. teacher: fine-tune from the donor ---
    donor_cfg = ModelConfig(scale="n", input_size=hw, num_classes=80,
                            dtype="float32")
    donor, _ = W.load_params_auto(path, donor_cfg)
    t_init, rep = W.transfer_params(donor, tcfg_model)
    print(f"teacher graft: {rep['copied']} leaves copied", flush=True)
    tr = Trainer(tcfg_model,
                 TrainConfig(epochs=args.teacher_epochs, batch=args.batch,
                             lr=1e-4, max_gt=8, ckpt_dir=None),
                 params=t_init, device=dev)
    tr.fit(train_ds, val_dataset=None)
    teacher_params = tr.eval_params
    t_eval = evaluate_dataset(tcfg_model, teacher_params, val_ds, batch=8,
                              device=dev)
    print(json.dumps({"config": "teacher", **rounded(t_eval)}), flush=True)

    # --- 2. students: same init, same batches, same optimizer ---
    n_labeled = max(int(len(train_ds) * args.label_fraction), 0)

    def batch_stream(seed=0):
        """Identical batches for every arm; images with index >=
        n_labeled have their GT masked out (unlabeled)."""
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(0, len(train_ds), args.batch)
            b = D.collate([train_ds[int(i)] for i in idx], scfg, max_gt=8)
            unlabeled = np.asarray(idx) >= n_labeled
            if unlabeled.any():
                b["labels"] = b["labels"].copy()
                b["labels"][unlabeled] = -1
                b["boxes_xywh"] = b["boxes_xywh"].copy()
                b["boxes_xywh"][unlabeled] = 0.0
                if "masks" in b:
                    b["masks"] = b["masks"].copy()
                    b["masks"][unlabeled] = 0.0
            yield b

    if args.label_fraction < 1.0:
        print(f"label fraction {args.label_fraction}: {n_labeled}/"
              f"{len(train_ds)} train images keep their GT", flush=True)

    pseudo_ds = None
    if args.combo_arm:
        args.pseudo_arm = True             # combo needs the pseudo set
    if args.pseudo_arm:
        from xrseg_tpu_torch.train.pseudo import generate_pseudo_samples
        ecfg = ExecutorConfig(model=tcfg_model)
        pseudo_ds = generate_pseudo_samples(
            ecfg, teacher_params,
            (train_ds[i]["image"] for i in range(len(train_ds))),
            score_gate=0.5, device=dev)
        n_lab = sum(len(s["labels"]) for s in pseudo_ds)
        print(f"pseudo-labeled {len(pseudo_ds)} images: {n_lab} "
              f"teacher detections", flush=True)

    def pseudo_stream(seed=0):
        rng = np.random.default_rng(seed)     # same index sequence
        while True:
            idx = rng.integers(0, len(train_ds), args.batch)
            yield D.collate([pseudo_ds[int(i)] for i in idx], scfg,
                            max_gt=8)

    results = {"teacher": t_eval}
    students = {}
    arms = (["scratch", "distill"] + (["pure"] if args.pure_arm else [])
            + (["pseudo"] if args.pseudo_arm else [])
            + (["combo"] if args.combo_arm else []))
    for arm in arms:
        opt = ts.make_optimizer(lr=args.lr, warmup_steps=args.steps // 20,
                                total_steps=args.steps)
        state = ts.init_train_state(torch.Generator().manual_seed(1), scfg,
                                    opt, device=dev)
        if arm in ("scratch", "pseudo"):
            step = ts.make_train_step(scfg, opt, device=dev)

            def do_step(state, batch):
                return step(state, batch)
        else:
            dstep = dst.make_distill_step(
                scfg, tcfg_model, opt,
                dst.DistillConfig(temperature=args.temp,
                                  cls_weight=args.cls_weight,
                                  box_weight=args.box_weight,
                                  fg_power=args.fg_power,
                                  det_weight=(0.0 if arm == "pure"
                                              else args.det_weight)),
                device=dev)

            def do_step(state, batch):
                return dstep(state, teacher_params, batch)

        # pseudo: the teacher's hard labels, standard loss; combo: hard
        # labels AND soft responses (det_weight applies to the pseudo GT
        # inside the distill step)
        stream = (pseudo_stream(seed=0) if arm in ("pseudo", "combo")
                  else batch_stream(seed=0))  # identical images per arm
        m = {}
        for i in range(args.steps):
            state, m = do_step(state, next(stream))
            if i % 50 == 0 or i == args.steps - 1:
                print(f"{arm} step {i:4d} loss {float(m['loss']):.4f}",
                      flush=True)
        students[arm] = state.params

    # --- 3. every student through the deployed pipeline ---
    for arm, params in students.items():
        r = evaluate_dataset(scfg, params, val_ds, batch=8, device=dev)
        results[arm] = r
        print(json.dumps({"config": f"student_{arm}", **rounded(r)}),
              flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
