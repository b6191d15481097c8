"""Distill a teacher into a smaller or other-generation student (the
port's examples/distill.py). The teacher's responses are the supervision,
so unlabelled frames work.

  # pure-response distillation on an unlabelled image directory:
  python -m xrseg_tpu_torch.examples.distill --teacher teacher.npz \
      --teacher-scale s --images frames/ --arch yolov8 --scale n \
      --steps 500 --out /tmp/stu [--device cuda]

  # the synthetic-shapes dataset (exact GT): mix ground truth in:
  python -m xrseg_tpu_torch.examples.distill --teacher ckpt.npz \
      --synthetic --det-weight 1.0 --steps 200 --out /tmp/stu

The student lands at <out>/student.npz in the JAX package's npz layout
(every CLI of either package reads it). An .npz teacher carries no
config: --teacher-arch/--teacher-scale/--teacher-task name it, its class
count is read from its head. --mesh N distills data-parallel over N
devices (on --device cpu the CPU repeated N times). A .sentis teacher
(the reference's artifact) loads; orbax teachers raise (ROADMAP item
13b).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--teacher", required=True,
                    help="teacher weights (.npz/.onnx/.pt/.sentis)")
    ap.add_argument("--images", help="UNLABELED image dir (pure-response "
                                     "distillation)")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic-shapes dataset (has GT; enables "
                         "--det-weight mixing)")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"], help="student arch")
    ap.add_argument("--scale", default="n", choices=list("nsmlx"),
                    help="student scale")
    ap.add_argument("--task", default=None,
                    help="student task (default: teacher's task)")
    ap.add_argument("--classes", type=int, default=None,
                    help="student classes (default: teacher's)")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--temp", type=float, default=2.0)
    ap.add_argument("--cls-weight", type=float, default=1.0)
    ap.add_argument("--box-weight", type=float, default=1.0)
    ap.add_argument("--fg-power", type=float, default=1.0)
    ap.add_argument("--det-weight", type=float, default=0.0,
                    help="> 0 mixes the ground-truth detection loss "
                         "(needs a labeled source, i.e. --synthetic)")
    ap.add_argument("--student-weights", default=None,
                    help="initialize the student from a checkpoint "
                         "(otherwise random init)")
    ap.add_argument("--teacher-arch", default=None,
                    help="teacher arch for metadata-free checkpoints "
                         "(.npz; .onnx/.pt describe themselves, a .sentis "
                         "is read as YOLO11n-seg)")
    ap.add_argument("--teacher-scale", default=None)
    ap.add_argument("--teacher-task", default=None)
    ap.add_argument("--mesh", type=int, default=0,
                    help="DP mesh size (0 = single device)")
    ap.add_argument("--out", default="/tmp/xrseg_distill")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    if not args.images and not args.synthetic:
        ap.error("--images or --synthetic required")
    if args.det_weight > 0 and not args.synthetic:
        ap.error("--det-weight needs a labeled source (--synthetic)")

    import numpy as np
    import torch

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.io import weights as W
    from xrseg_tpu_torch.io.bridge import params_from_jax
    from xrseg_tpu_torch.train import data as D
    from xrseg_tpu_torch.train.distill import DistillConfig, make_distill_step
    from xrseg_tpu_torch.train.train_step import (TrainState,
                                                  init_train_state,
                                                  make_optimizer)

    hw = (args.size, args.size)
    if args.teacher.endswith(".npz"):     # metadata-free npz teacher
        with np.load(args.teacher) as z:
            ttree = W.dequantize_int8(W.unflatten_params(
                {k: z[k] for k in z.files}))
        tcfg = ModelConfig(
            arch=args.teacher_arch or args.arch,
            scale=args.teacher_scale or args.scale,
            task=args.teacher_task or (args.task or "segment"),
            num_classes=W.donor_num_classes(ttree) or 80, input_size=hw)
        teacher = params_from_jax(ttree, tcfg)
    else:
        teacher, tcfg = W.load_params_auto(args.teacher)
        tcfg = dataclasses.replace(tcfg, input_size=hw)
        teacher = W.with_config(teacher, tcfg)
    teacher = teacher.to(device).requires_grad_(False)
    task = args.task or tcfg.task
    nc = args.classes or tcfg.num_classes
    if nc != tcfg.num_classes:
        ap.error(f"student classes ({nc}) must match the teacher's "
                 f"({tcfg.num_classes}): responses ARE the labels")
    scfg = ModelConfig(arch=args.arch, scale=args.scale, task=task,
                       num_classes=nc, input_size=hw)
    print(f"teacher: {tcfg.arch}-{tcfg.scale} {tcfg.task} nc={nc}  ->  "
          f"student: {scfg.arch}-{scfg.scale} {scfg.task}")

    opt = make_optimizer(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                         total_steps=args.steps)
    state = init_train_state(torch.Generator().manual_seed(0), scfg, opt,
                             device=device)
    if args.student_weights:
        smodel, _ = W.load_params_auto(args.student_weights, scfg)
        smodel = smodel.to(device)
        state = TrainState(params=smodel, opt_state=opt.init(smodel),
                           step=0)
    dcfg = DistillConfig(temperature=args.temp, cls_weight=args.cls_weight,
                         box_weight=args.box_weight,
                         fg_power=args.fg_power, det_weight=args.det_weight)
    mesh = None
    if args.mesh:
        from xrseg_tpu_torch.parallel.mesh import device_mesh
        mesh = device_mesh((args.mesh, 1), device)
    step = make_distill_step(scfg, tcfg, opt, dcfg, mesh=mesh, device=device)

    # --- batch source ---
    rng = np.random.default_rng(0)
    if args.synthetic:
        ds = D.SyntheticShapesDataset(n=max(args.batch * 8, 64), hw=hw,
                                      n_classes=min(3, nc))

        def batches():
            while True:
                idx = rng.integers(0, len(ds), args.batch)
                yield D.collate([ds[int(i)] for i in idx], scfg, max_gt=8)
    else:
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        files = sorted(os.path.join(args.images, f)
                       for f in os.listdir(args.images)
                       if f.lower().endswith(exts))
        if not files:
            ap.error(f"no images in {args.images}")
        from PIL import Image

        def load(f):
            return np.asarray(Image.open(f).convert("RGB"), np.uint8)

        def batches():
            while True:
                idx = rng.integers(0, len(files), args.batch)
                imgs = [D._resize_uint8(load(files[int(i)]), hw)
                        for i in idx]
                yield {"images": np.stack(imgs).astype(np.float32) / 255}

    os.makedirs(args.out, exist_ok=True)
    it = batches()
    m = {}
    for i in range(args.steps):
        state, m = step(state, teacher, next(it))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"cls {float(m['distill_cls']):.4f}  "
                  + (f"box {float(m['distill_box']):.4f}  "
                     if "distill_box" in m else "")
                  + f"agree {float(m['teacher_agreement']):.3f}")

    out_path = os.path.join(args.out, "student.npz")
    W.save_npz(out_path, state.params)
    summary = {"steps": args.steps,
               "final_loss": round(float(m["loss"]), 5),
               "teacher_agreement": round(float(m["teacher_agreement"]), 4),
               "student": f"{scfg.arch}-{scfg.scale}-{scfg.task}",
               "out": out_path}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
