"""Track a video clip or an image directory into MOTChallenge rows (the
port's tools/track_video.py).

A VideoFrameSource (or FileFrameSource) feeds the Executor with the
multi-target tracker (ExecutorConfig.multi_tracking; K1 on the card each
frame), and every track of every frame becomes a MOTChallenge row
(frame,id,left,top,w,h,conf,-1,-1,-1; pixel coordinates, 1-based frames),
scored by `python -m xrseg_tpu_torch.eval.mot --gt gt.txt --pred
pred.txt`, or inline with --gt here.

  python -m xrseg_tpu_torch.tools.track_video --video clip.y4m \\
      --out pred.txt --ckpt model.npz [--device cuda]
  python -m xrseg_tpu_torch.tools.track_video --images frames/ \\
      --out pred.txt --gt gt.txt

--sentis loads the reference's .sentis artifact (io/sentis).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", help="clip (.y4m / MJPEG .avi)")
    ap.add_argument("--images", help="image dir (alternative to --video)")
    ap.add_argument("--out", required=True, help="MOTChallenge pred file")
    ap.add_argument("--gt", default=None,
                    help="MOTChallenge GT file: score inline (CLEAR-MOT "
                         "+ IDF1) after tracking")
    ap.add_argument("--scale", default="n", choices=list("nsmlx"))
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--ckpt", default=None,
                    help="weights (.npz/.onnx/.pt/.sentis)")
    ap.add_argument("--sentis", default=None,
                    help=".sentis model file (the reference's artifact)")
    ap.add_argument("--seed", type=int, default=0,
                    help="random weights from this seed without --ckpt")
    ap.add_argument("--score-threshold", type=float, default=None)
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop after N frames (0 = all)")
    ap.add_argument("--motion", action="store_true",
                    help="Kalman motion model in the tracker")
    ap.add_argument("--byte-track", type=float, default=0.0,
                    metavar="HIGH",
                    help="ByteTrack two-stage association: HIGH is the "
                         "confident gate (e.g. 0.25); the pipeline gate "
                         "drops to 0.1 so low-score detections reach "
                         "the tracker's recovery stage")
    ap.add_argument("--save-video", default=None, metavar="OUT.AVI",
                    help="also write an annotated MJPEG clip")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.video and not args.images:
        ap.error("--video or --images required")

    from xrseg_tpu_torch.config import (TEST_PRESET, ExecutorConfig,
                                        ModelConfig)
    from xrseg_tpu_torch.runtime.executor import Executor

    if args.video:
        from xrseg_tpu_torch.runtime.video import VideoFrameSource
        src = VideoFrameSource(args.video)
    else:
        from xrseg_tpu_torch.runtime.frame_source import FileFrameSource
        src = FileFrameSource(args.images, interval_s=0.0, loop=False)
    if not src.open():
        print("no frames found", file=sys.stderr)
        return 2

    mcfg = ModelConfig(arch=args.arch, scale=args.scale)
    params = None
    weights = args.ckpt or args.sentis
    if weights:
        from xrseg_tpu_torch.io.weights import load_params_auto
        params, _ = load_params_auto(weights, mcfg)

    post = TEST_PRESET.post
    if args.score_threshold is not None:
        post = dataclasses.replace(post,
                                   score_threshold=args.score_threshold)
    if args.byte_track > 0:
        post = dataclasses.replace(
            post, score_threshold=min(post.score_threshold, 0.1))
    cfg = ExecutorConfig(model=mcfg, post=post, multi_tracking=True,
                         motion_model=args.motion,
                         track_high_score=args.byte_track)

    first = next(src.frames())
    fh, fw = first.rgb.shape[:2]
    ex = Executor(cfg, params=params, frame_hw=(fh, fw), seed=args.seed,
                  device=args.device)
    print(f"tracking {fw}x{fh} frames ({args.arch}-{args.scale}, "
          f"{ex.device})", flush=True)

    writer = None
    if args.save_video:
        from xrseg_tpu_torch.runtime.video import MJPEGWriter
        writer = MJPEGWriter(args.save_video,
                             fps=getattr(src, "fps", 0) or 25.0)

    rows = []
    n = 0
    for fd in src.frames():
        if args.max_frames and n >= args.max_frames:
            break
        r = ex.run_sync(fd)
        if writer is not None:
            writer.add(ex.boxer.draw_boxes(fd.rgb, r.boxes))
        for t in (r.tracks or []):
            b = t.box
            # centre-origin screen space (Y up) -> pixel left/top
            left = (b.center_x + fw / 2.0) - b.width / 2.0
            top = (fh / 2.0 - b.center_y) - b.height / 2.0
            rows.append(f"{n + 1},{t.track_id},{left:.2f},{top:.2f},"
                        f"{b.width:.2f},{b.height:.2f},{b.score:.4f},"
                        f"-1,-1,-1")
        n += 1
        if n % 25 == 0:
            print(f"  frame {n}: {len(rows)} rows so far", flush=True)
    src.close()
    if writer is not None:
        writer.close()
        print(f"annotated clip: {args.save_video} ({writer.n} frames)")

    with open(args.out, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    print(f"{n} frames -> {len(rows)} track rows -> {args.out}")

    if args.gt:
        from xrseg_tpu_torch.eval.mot import evaluate_mot, load_motchallenge
        m = evaluate_mot(load_motchallenge(args.gt),
                         load_motchallenge(args.out))
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in m.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
