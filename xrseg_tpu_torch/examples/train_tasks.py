"""Task-family training (the port's examples/train_tasks.py): pose, obb
or classify on synthetic data or an ultralytics-format directory.

  python -m xrseg_tpu_torch.examples.train_tasks --task pose [--steps 60] \
      [--size 64] [--device cuda]
  python -m xrseg_tpu_torch.examples.train_tasks --task obb [--steps 60]
  python -m xrseg_tpu_torch.examples.train_tasks --task classify

With --data DIR it trains on an on-disk dataset (pose/obb: DIR/images +
DIR/labels; classify: DIR/<class_name>/*.jpg), cycling through it. With
--epochs N it trains through the full Trainer (augmentation, EMA,
per-epoch validation with --eval, checkpoints under --ckpt, --resume)
instead of the raw step loop. --weights grafts a donor checkpoint
(backbone, neck and box branches kept, the task head fresh:
io/weights.transfer_params). Prints the loss per step (and accuracy for
classify); --out saves the final weights as npz. --fsdp (with --epochs)
shards the Trainer's params and optimizer moments over every visible
card (on --device cpu, a mesh of the one CPU).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

COCO17_FLIP = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def _infer_classes(ds, floor: int = 1) -> int:
    """Max label id + 1 across the dataset (bounded scan)."""
    hi = floor - 1
    for i in range(min(len(ds), 256)):
        labels = ds[i]["labels"]
        if len(labels):
            hi = max(hi, int(labels.max()))
    return hi + 1


def _donor_params(args, cfg):
    """--weights: a donor checkpoint grafted onto the task model (an
    80-class segmenter of cfg's network unless its head fits cfg)."""
    if not args.weights:
        return None
    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.io.weights import load_for_config
    donor_cfg = ModelConfig(arch=cfg.arch, scale=cfg.scale,
                            input_size=cfg.input_size, dtype="float32")
    params, _, rep = load_for_config(args.weights, cfg, donor_cfg)
    if rep is not None:
        print(f"transfer: {rep['copied']} leaves from {args.weights}; "
              f"{len(rep['reinit'])} reinitialized")
    return params


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", required=True,
                    choices=["pose", "obb", "classify"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--n-samples", type=int, default=8)
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="ultralytics-format dataset dir (pose/obb: "
                         "images+labels; classify: folder-per-class). "
                         "Default: synthetic exact-GT data")
    ap.add_argument("--ann", default=None, metavar="JSON",
                    help="pose: COCO person_keypoints annotations; "
                         "--data is then the images directory")
    ap.add_argument("--dump", default=None, metavar="JSON",
                    help="pose with --eval: also write detections as a "
                         "COCO keypoint-results JSON")
    ap.add_argument("--tta", action="store_true",
                    help="--eval with 2-view TTA (pose uses the COCO-17 "
                         "flip permutation for 17-kpt models, identity "
                         "otherwise)")
    ap.add_argument("--classes", type=int, default=None,
                    help="num classes (default: synthetic preset, or "
                         "inferred from --data labels)")
    ap.add_argument("--kpt-shape", type=int, nargs=2, default=None,
                    metavar=("K", "D"),
                    help="pose keypoint shape in the label files "
                         "(default: 5 3 synthetic, 17 3 with --data)")
    ap.add_argument("--epochs", type=int, default=0, metavar="N",
                    help="train with the FULL Trainer for N epochs "
                         "instead of the raw --steps loop")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="Trainer mode: checkpoint dir (resume with "
                         "--resume)")
    ap.add_argument("--resume", action="store_true",
                    help="Trainer mode: resume from --ckpt")
    ap.add_argument("--out", default=None, help="save final params (.npz)")
    ap.add_argument("--weights", default=None,
                    help="donor checkpoint (.npz/.onnx/.pt/.sentis) to "
                         "transfer from, e.g. the deployed 80-class "
                         "segmenter")
    ap.add_argument("--eval", type=int, default=0, metavar="N",
                    help="after training, score N dataset images through "
                         "the deployed pipeline (OKS AP / rotated AP / "
                         "top-1 accuracy)")
    ap.add_argument("--render", default=None, metavar="DIR",
                    help="pose/obb: write overlay PNGs for a few dataset "
                         "images")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 state sharding over the devices (with "
                         "--epochs)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step")
    ap.add_argument("--tb", default=None, metavar="DIR",
                    help="TensorBoard scalar logdir ('auto' = <ckpt>/tb)")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype (params stay f32 master weights)")
    ap.add_argument("--label-smoothing", type=float, default=0.0,
                    help="classify: CE target smoothing eps")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np
    import torch

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train import train_step as ts

    hw = (args.size, args.size)
    if args.task == "pose":
        kpt = tuple(args.kpt_shape or ((17, 3) if args.data else (5, 3)))
        if args.data and args.ann:
            ds = D.CocoPoseDataset(args.ann, args.data)
            kpt = ds.kpt_shape
            ncls = args.classes or len(ds.class_names) or 1
        elif args.data:
            ds = D.YoloPoseDataset(args.data, kpt_shape=kpt)
            ncls = args.classes or _infer_classes(ds, 1)
        else:
            ds = D.SyntheticPoseDataset(n=args.n_samples, hw=hw,
                                        max_objects=1)
            ncls = args.classes or 2
        # the model stores (K, 3); D=2 label files get vis=1 on load
        cfg = ModelConfig(arch=args.arch, scale="n", input_size=hw,
                          dtype=args.dtype, task="pose",
                          kpt_shape=(kpt[0], 3), num_classes=ncls)
        collate = lambda samples: D.collate_pose(samples, hw)   # noqa: E731
    elif args.task == "obb":
        if args.data:
            ds = D.YoloOBBDataset(args.data)
            ncls = args.classes or _infer_classes(ds, 1)
        else:
            ds = D.SyntheticOBBDataset(n=args.n_samples, hw=hw,
                                       max_objects=1)
            ncls = args.classes or 2
        cfg = ModelConfig(arch=args.arch, scale="n", input_size=hw,
                          dtype=args.dtype, task="obb", num_classes=ncls)
        collate = lambda samples: D.collate_obb(samples, hw)    # noqa: E731
    else:
        if args.data:
            ds = D.ImageFolderDataset(args.data)
            ncls = args.classes or len(ds.classes)
        else:
            ds = D.SyntheticClassifyDataset(n=args.n_samples, hw=hw)
            ncls = args.classes or 3
        cfg = ModelConfig(arch=args.arch, scale="n", input_size=hw,
                          dtype=args.dtype, task="classify",
                          num_classes=ncls)
        collate = lambda samples: D.collate_classify(samples,   # noqa: E731
                                                     hw)

    if args.epochs:
        # the full Trainer: Loader augmentation (geometry-aware hflip),
        # EMA, per-epoch validation on the task metric, checkpoints
        from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer
        flip_idx = (COCO17_FLIP if args.task == "pose"
                    and cfg.kpt_shape[0] == 17 else None)
        tcfg = TrainConfig(
            epochs=args.epochs, batch=args.batch, lr=args.lr,
            warmup_steps=2, use_remat=False, ckpt_dir=args.ckpt,
            val_max_images=args.eval or 8, kpt_flip_idx=flip_idx,
            fsdp=args.fsdp, grad_accum=args.grad_accum, tb_dir=args.tb,
            label_smoothing=args.label_smoothing,
            aug=D.AugmentConfig(mosaic=0.0, scale=0.0, translate=0.0))
        mesh = None
        if args.fsdp:
            from xrseg_tpu_torch.parallel import mesh as mesh_lib
            mesh = (mesh_lib.make_mesh(devices=[torch.device("cpu")])
                    if torch.device(device).type == "cpu"
                    else mesh_lib.make_mesh())
        tr = Trainer(cfg, tcfg, mesh=mesh, params=_donor_params(args, cfg),
                     device=device)
        t0 = time.perf_counter()
        tr.fit(ds, val_dataset=ds if args.eval else None,
               resume=args.resume)
        print(f"{args.epochs} epochs in {time.perf_counter() - t0:.1f}s")
        params = tr.eval_params
    else:
        params = None                       # raw step loop below

    perm = np.random.default_rng(0).permutation(len(ds))

    def batch_at(step_i: int):
        if not args.data:
            # synthetic demo: one fixed batch, exact convergence check
            idx = range(args.batch)
        else:
            # deterministic shuffle so folder-sorted datasets mix classes
            start = (step_i * args.batch) % len(ds)
            idx = [perm[(start + j) % len(ds)] for j in range(args.batch)]
        return collate([ds[i] for i in idx])

    if params is None:
        opt = ts.make_optimizer(args.lr, warmup_steps=2,
                                total_steps=args.steps)
        donor = _donor_params(args, cfg)
        if donor is not None:
            donor = donor.to(device)
            state = ts.TrainState(params=donor, opt_state=opt.init(donor),
                                  step=0)
        else:
            state = ts.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, opt, device=device)
        step = ts.make_train_step(cfg, opt, use_remat=False,
                                  label_smoothing=args.label_smoothing,
                                  device=device)

        t0 = time.perf_counter()
        batch = batch_at(0)
        for i in range(args.steps):
            if args.data and i:
                batch = batch_at(i)
            state, m = step(state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                extra = (f" acc={float(m['acc']):.3f}"
                         if "acc" in m else "")
                print(f"step {i}: loss={float(m['loss']):.4f}{extra}",
                      flush=True)
        print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s")
        params = state.params

    if args.eval:
        from xrseg_tpu_torch.eval.dataset_eval import evaluate_task_dataset
        kfi = None
        if args.tta and args.task == "pose":
            kfi = (COCO17_FLIP if cfg.kpt_shape[0] == 17
                   else tuple(range(cfg.kpt_shape[0])))
        r = evaluate_task_dataset(cfg, params, ds,
                                  max_images=args.eval,
                                  batch=min(4, args.eval),
                                  score_threshold=0.005,
                                  coco_dump=(args.dump if args.task ==
                                             "pose" else None),
                                  tta=(args.tta and
                                       args.task != "classify"),
                                  tta_kpt_flip_idx=kfi, device=device)
        print("eval:", {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in r.items()})

    if args.render and args.task in ("pose", "obb"):
        from PIL import Image

        from xrseg_tpu_torch.compile import build_pipeline
        from xrseg_tpu_torch.config import ExecutorConfig, PostprocessConfig
        from xrseg_tpu_torch.viz.boxer import (draw_keypoints,
                                               draw_rotated_boxes)
        os.makedirs(args.render, exist_ok=True)
        pipe = build_pipeline(
            ExecutorConfig(model=cfg, post=PostprocessConfig(
                score_threshold=0.005)),
            params, batch=1, device=device)
        for i in range(min(4, len(ds))):
            frame = np.asarray(ds[i]["image"])
            det = {k: v.cpu().numpy() for k, v in pipe(frame[None]).items()}
            n = int(det["count"][0])
            if args.task == "obb":
                img = draw_rotated_boxes(frame, det["boxes_xywhr"][0],
                                         det["labels"][0],
                                         det["scores"][0], n)
            else:
                img = draw_keypoints(frame, det["kpts"][0][:n])
            path = os.path.join(args.render, f"{args.task}_{i}.png")
            Image.fromarray(img).save(path)
            print(f"rendered {path} ({n} detections)")

    if args.out:
        from xrseg_tpu_torch.io.weights import save_npz
        save_npz(args.out, params)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
