"""Fine-tune YOLO11 on a YOLO-format dataset directory with Trainer.fit()
(the port's examples/train.py).

  python -m xrseg_tpu_torch.examples.train --data /path/train \
      [--val /path/val] --scale n --size 640 --epochs 50 --batch 16 \
      --out /tmp/run [--weights init.npz|.onnx|.pt] [--resume] \
      [--device cuda]

Dataset layout (ultralytics): root/images/*.jpg + root/labels/*.txt
(`cls cx cy w h` normalized, or `cls x1 y1 x2 y2 ...` seg polygons), or a
COCO images directory with --ann. With --synthetic it trains on the
procedural shapes dataset instead (no data needed). --weights whose head
does not fit --classes/--task are transfer-grafted
(io/weights.transfer_params: backbone, neck and box branch kept, the class
conv drawn anew); an .npz is read as a tree whatever head it holds.
--mesh N trains data-parallel over N devices (on --device cpu the CPU
repeated N times), with --fsdp its params and optimizer moments sharded
over them; .sentis and orbax weights raise (item 13).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", help="train dataset dir (YOLO format; or "
                    "COCO images dir with --ann)")
    ap.add_argument("--ann", default=None, metavar="JSON",
                    help="COCO instances annotations for --data (and "
                         "--val-ann for --val)")
    ap.add_argument("--val", help="validation dataset dir")
    ap.add_argument("--val-ann", default=None, metavar="JSON")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the procedural shapes dataset")
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--task", default="segment",
                    choices=["segment", "detect"])
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--classes", type=int, default=80)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-gt", type=int, default=16)
    ap.add_argument("--weights", help="initial weights (.npz/.onnx/.pt); "
                    "heads that do not match --classes/--task are "
                    "transfer-grafted (backbone+neck kept, class conv reinit)")
    ap.add_argument("--donor-task", default="segment",
                    choices=["segment", "detect", "pose", "obb", "classify"],
                    help="task the --weights artifact was built for, when "
                         "it differs from --task (default: segment, the "
                         "reference's deployed head)")
    ap.add_argument("--donor-classes", type=int, default=80,
                    help="class count of the --weights artifact when it "
                         "differs from --classes (default: 80, COCO)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel over N devices (0 = single device)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params + optimizer moments over the mesh "
                         "data axis (ZeRO-3; requires --mesh)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step (batch must "
                         "divide evenly)")
    ap.add_argument("--out", default="/tmp/xrseg_run")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-mosaic", action="store_true")
    ap.add_argument("--mixup", type=float, default=0.0,
                    help="2-image mixup probability (blend + GT union)")
    ap.add_argument("--close-mosaic", type=int, default=0, metavar="N",
                    help="disable mosaic/mixup for the last N epochs")
    ap.add_argument("--copy-paste", type=float, default=0.0,
                    help="per-instance segment copy-paste probability")
    ap.add_argument("--scales", type=int, nargs="+", default=None,
                    help="multi-scale bucket sizes (multiples of 32), e.g. "
                         "--scales 512 576 640 704")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for smoke tests)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    ap.add_argument("--tb", default=None, metavar="DIR",
                    help="TensorBoard scalar logdir ('auto' = <out>/tb)")
    ap.add_argument("--resize-mode", default="stretch",
                    choices=["stretch", "letterbox"],
                    help="train-time sample geometry: stretch (the "
                         "reference's deploy semantics) or aspect-"
                         "preserving letterbox (ultralytics training)")
    ap.add_argument("--data-hw", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="synthetic dataset source frame size")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype (params stay f32 master weights)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = ModelConfig(arch=args.arch, scale=args.scale, task=args.task,
                      input_size=(args.size, args.size),
                      num_classes=args.classes, dtype=args.dtype)

    if args.synthetic:
        data_hw = tuple(args.data_hw) if args.data_hw \
            else (args.size, args.size)
        train_ds = D.SyntheticShapesDataset(n=256, hw=data_hw,
                                            n_classes=min(3, args.classes))
        val_ds = D.SyntheticShapesDataset(n=32, hw=data_hw,
                                          n_classes=min(3, args.classes),
                                          seed=1)
    else:
        if not args.data:
            ap.error("--data or --synthetic required")
        train_ds = (D.CocoDataset(args.ann, args.data) if args.ann
                    else D.YoloDataset(args.data))
        val_ds = (None if not args.val
                  else D.CocoDataset(args.val_ann, args.val)
                  if args.val_ann else D.YoloDataset(args.val))

    params = None
    if args.weights:
        from xrseg_tpu_torch.io.weights import load_for_config
        donor_cfg = ModelConfig(arch=args.arch, scale=args.scale,
                                task=args.donor_task,
                                input_size=cfg.input_size,
                                num_classes=args.donor_classes,
                                dtype="float32")
        params, cfg, rep = load_for_config(args.weights, cfg, donor_cfg)
        if rep is not None:
            print(f"transfer: {rep['copied']} leaves from {args.weights}; "
                  f"reinitialized {len(rep['reinit'])} "
                  f"({', '.join(sorted({k.split('/')[0] for k in rep['reinit']}))})")

    mesh = None
    if args.mesh:
        from xrseg_tpu_torch.parallel.mesh import device_mesh
        mesh = device_mesh((args.mesh, 1), device)

    aug = D.AugmentConfig(mosaic=0.0 if args.no_mosaic else 1.0,
                          mixup=args.mixup, copy_paste=args.copy_paste,
                          letterbox=(args.resize_mode == "letterbox"))
    scales = (tuple((s, s) for s in args.scales) if args.scales else None)
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, lr=args.lr,
                       max_gt=args.max_gt, aug=aug, ckpt_dir=args.out,
                       scales=scales, fsdp=args.fsdp,
                       grad_accum=args.grad_accum, tb_dir=args.tb,
                       close_mosaic=args.close_mosaic)
    tr = Trainer(cfg, tcfg, mesh=mesh, params=params, device=device)
    tr.fit(train_ds, val_dataset=val_ds, resume=args.resume)
    print(f"done: {len(tr.history)} epochs, checkpoints in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
