"""Fine-tuning example (the port's examples/train_toy.py): train
YOLO11n-seg on batches of synthetic circles with the raw train step, then
save the weights as npz (the JAX package's layout).

  python -m xrseg_tpu_torch.examples.train_toy --steps 60 \
      --out /tmp/xrseg_train [--size 160] [--device cuda]

Exits 0 when the last logged loss is below the first. --mesh N above 1
trains data-parallel over N devices (on --device cpu the CPU repeated N
times). --size (default 160, the JAX script's fixed size) is the port's
addition.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np


def make_batch(rng, B, size=160, n_obj=2):
    """Solid circles on noise; GT boxes/labels/masks. Class = color bucket."""
    G = n_obj
    imgs = rng.uniform(0, 0.3, (B, size, size, 3)).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -1, np.int32)
    mh = mw = size // 4
    masks = np.zeros((B, G, mh, mw), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(B):
        for g in range(G):
            r = rng.uniform(size * 0.08, size * 0.18)
            cx = rng.uniform(r, size - r)
            cy = rng.uniform(r, size - r)
            cls = rng.integers(0, 3)
            color = np.eye(3)[cls] * rng.uniform(0.7, 1.0)
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
            imgs[b][inside] = color
            boxes[b, g] = (cx, cy, 2 * r, 2 * r)
            labels[b, g] = cls
            myy, mxx = np.mgrid[0:mh, 0:mw]
            masks[b, g] = (((mxx * 4 - cx) ** 2 + (myy * 4 - cy) ** 2)
                           < r ** 2).astype(np.float32)
    return {"images": imgs, "boxes_xywh": boxes, "labels": labels,
            "masks": masks}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--out", default="/tmp/xrseg_train")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel shards (0 = single device)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from xrseg_tpu_torch.config import ModelConfig
    from xrseg_tpu_torch.io.weights import save_npz
    from xrseg_tpu_torch.parallel import mesh as mesh_lib
    from xrseg_tpu_torch.train import train_step as ts

    os.makedirs(args.out, exist_ok=True)
    cfg = ModelConfig(scale="n", input_size=(args.size, args.size),
                      num_classes=3, dtype="float32")
    opt = ts.make_optimizer(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps)
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device=args.device)
    mesh = None
    if args.mesh > 1:
        mesh = mesh_lib.device_mesh((args.mesh, 1), args.device)
        state = ts.shard_train_state(state, mesh)
        print(f"training over mesh {dict(mesh.shape)}")
    step_fn = ts.make_train_step(cfg, opt, mesh=mesh, use_remat=False,
                                 device=args.device)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    first = last = None
    for i in range(args.steps):
        batch = make_batch(rng, args.batch, args.size)
        if mesh is not None:
            batch = mesh_lib.shard_batch(batch, mesh)
        state, metrics = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i:4d}  loss={m['loss']:8.3f}  box={m['box']:.3f} "
                  f"cls={m['cls']:.3f} dfl={m['dfl']:.3f} "
                  f"seg={m.get('seg', 0):.3f}", flush=True)
            if first is None:
                first = m["loss"]
            last = m["loss"]
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch / dt:.1f} img/s); "
          f"loss {first:.2f} -> {last:.2f}")

    ckpt = os.path.join(args.out, "toy_ckpt.npz")
    save_npz(ckpt, ts.gathered_params(state))
    print(f"checkpoint -> {ckpt}")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
