"""End-to-end demo: the reference's two scenes as CLI modes (the port's
examples/demo.py).

  --mode test    TestScene: run images from a directory (or one named
                 image), or a --video clip, through the Executor and
                 write box/mask overlay PNGs.
  --mode xr      XRScene: stream the synthetic passthrough camera (frames
                 + depth + pose) or a V4L2 --camera through an XRLoop,
                 aim the controller at the first detection, pull the
                 trigger to lock it, track it, and write overlay PNGs and
                 the point cloud as PLY.

  python -m xrseg_tpu_torch.examples.demo --mode test --images imgs/ \\
      --out out/ [--device cuda]
  python -m xrseg_tpu_torch.examples.demo --mode xr --frames 90 --out out/

--ckpt takes .npz, .pt/.pth or .onnx weights, --sentis the reference's
.sentis artifact (io/sentis).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("test", "xr"), default="test")
    ap.add_argument("--images", default=None, help="image dir for test mode")
    ap.add_argument("--video", default=None, metavar="CLIP",
                    help="test mode: run a video clip (.y4m or MJPEG .avi)"
                         " instead of an image dir")
    ap.add_argument("--image-name", default=None)
    ap.add_argument("--out", default="xrseg_demo")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--arch", default="yolo11",
                    choices=["yolo11", "yolov8"])
    ap.add_argument("--ckpt", default=None,
                    help="weights to load (.npz/.pt/.onnx/.sentis)")
    ap.add_argument("--sentis", default=None,
                    help=".sentis model file (the reference's artifact)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--camera", default=None, metavar="/dev/videoN",
                    help="xr mode: use a live V4L2 camera instead of the "
                         "synthetic source (no depth/pose -> detection+"
                         "tracking only)")
    ap.add_argument("--score-threshold", type=float, default=None,
                    help="override the preset NMS score threshold")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from xrseg_tpu_torch.config import (TEST_PRESET, XR_PRESET,
                                        ExecutorConfig, ModelConfig)
    from xrseg_tpu_torch.runtime.executor import Executor
    from xrseg_tpu_torch.runtime.frame_source import (FileFrameSource,
                                                      SyntheticCameraSource)
    from xrseg_tpu_torch.viz.masker import (composite_overlay,
                                            draw_masks_multi)
    from xrseg_tpu_torch.viz.pointcloud import write_ply

    os.makedirs(args.out, exist_ok=True)
    mcfg = ModelConfig(arch=args.arch, scale=args.scale)
    params = None
    if args.ckpt or args.sentis:
        from xrseg_tpu_torch.io.weights import load_params_auto
        params, _ = load_params_auto(args.ckpt or args.sentis, mcfg)

    if args.mode == "test":
        cfg = ExecutorConfig(model=mcfg, post=TEST_PRESET.post,
                             enable_ui_rendering=True)
        if args.video:
            from xrseg_tpu_torch.runtime.video import VideoFrameSource
            src = VideoFrameSource(args.video)
        else:
            src = FileFrameSource(args.images or ".",
                                  image_name=args.image_name, loop=False)
        if not src.open():
            print(f"no frames found in {args.video or args.images}",
                  file=sys.stderr)
            return 2
        # the executor is built per frame geometry: frames of another size
        # are resized to the first one's
        first = next(src.frames())
        fh, fw = first.rgb.shape[:2]
        ex = Executor(cfg, params=params, frame_hw=(fh, fw), seed=args.seed,
                      device=args.device)
        print(f"model loaded ({args.arch}-{args.scale}, {ex.device}); "
              f"frame {fw}x{fh}")
        n = 0
        for fd in src.frames():
            if fd.rgb.shape[:2] != (fh, fw):
                fd.rgb = np.asarray(Image.fromarray(fd.rgb).resize((fw, fh)),
                                    np.uint8)
            t0 = time.perf_counter()
            r = ex.run_sync(fd)
            dt = time.perf_counter() - t0
            over = fd.rgb
            if r.count > 0 and "masks" in (ex.last_device_out or {}):
                masks = ex.last_device_out["masks"][0].float().cpu().numpy()
                over = composite_overlay(over, draw_masks_multi(
                    r.boxes, masks, (fw, fh), cfg.confidence_threshold))
            over = ex.boxer.draw_boxes(over, r.boxes)
            out_path = os.path.join(args.out, f"test_{n:03d}.png")
            Image.fromarray(over).save(out_path)
            print(f"frame {n}: {r.count} detections in {dt * 1e3:.1f} ms "
                  f"-> {out_path}")
            for b in r.boxes[:5]:
                print(f"   {b.class_name:14s} score={b.score:.2f} "
                      f"center=({b.center_x:+.0f},{b.center_y:+.0f}) "
                      f"size=({b.width:.0f}x{b.height:.0f})")
            n += 1
        print(ex.tracer.summary_json())
        return 0

    # --- xr mode ---
    post = XR_PRESET.post
    if args.score_threshold is not None:
        post = dataclasses.replace(post, score_threshold=args.score_threshold)
    cfg = ExecutorConfig(model=mcfg, post=post, depth=XR_PRESET.depth,
                         enable_ui_rendering=True)
    background = None
    if args.images:
        bg_src = FileFrameSource(args.images, image_name=args.image_name,
                                 loop=False)
        if bg_src.open():
            background = next(bg_src.frames()).rgb
            print(f"using real-image background from {args.images}")
    if args.camera:
        from xrseg_tpu_torch.runtime.v4l2 import V4L2CameraSource
        src = V4L2CameraSource(args.camera, max_frames=args.frames)
        src.request_resolution((640, 480))
        if not src.open():
            print(f"error: camera {args.camera} not available")
            return 1
        src.intrinsics = SyntheticCameraSource().intrinsics  # no calibration
        cam_hw = src.frame_hw or (480, 640)   # the driver may grant another
    else:
        src = SyntheticCameraSource(frame_hw=(480, 640), depth_hw=(128, 128),
                                    max_frames=args.frames, realtime=True,
                                    background_rgb=background)
        cam_hw = (480, 640)
    ex = Executor(cfg, params=params, frame_hw=cam_hw, seed=args.seed,
                  device=args.device)
    print(f"model loaded ({ex.device}); streaming the passthrough camera")
    # the app loop is runtime/xr_loop.py; the demo only scripts the
    # controller: once a detection appears, aim at it and pull the trigger
    # (point-cloud extraction and lock on the down edge)
    from xrseg_tpu_torch.runtime.xr_loop import (XRLoop,
                                                 aim_controller_at_frame_point)
    loop = XRLoop(ex, intrinsics=src.intrinsics)
    results = 0
    cloud = None
    ctl = None
    for fd in src.frames():
        r = loop.tick(fd, ctl)
        if r is None:
            continue
        results += 1
        # laser selection needs a camera pose; pose-less live cameras
        # (V4L2) run detection and tracking only
        if not loop.selected and r.count > 0 and fd.pose is not None:
            b = r.boxes[0]
            frame_sp = (b.center_x + ex.screen_wh[0] / 2,
                        b.center_y + ex.screen_wh[1] / 2)
            ctl = aim_controller_at_frame_point(src.intrinsics, fd.pose,
                                                frame_sp, ex.screen_wh)
            ctl.trigger = True
            loop.tick(fd, ctl)        # trigger-down edge: select + extract
            if loop.selected:
                print(f"laser-selected target: {b.class_name} @ frame "
                      f"{results} (laser screen pos "
                      f"{tuple(round(v, 1) for v in loop.last_laser_frame_pos)})")
        if r.tracked is not None and r.point_cloud is not None:
            cloud = r.point_cloud
        if results % 10 == 0:
            over = ex.boxer.draw_boxes(fd.rgb, r.boxes)
            if ex.masker.has_cached_mask:
                over = composite_overlay(
                    over, ex.masker.render_overlay((cam_hw[1], cam_hw[0])))
            Image.fromarray(over).save(
                os.path.join(args.out, f"xr_{results:03d}.png"))
    if cloud is not None and len(cloud.positions):
        ply = os.path.join(args.out, "cloud.ply")
        write_ply(ply, cloud.positions, cloud.colors)
        print(f"point cloud: {len(cloud.positions)} pts -> {ply}")
    print(f"{results} results from {args.frames} frames")
    print(ex.tracer.summary_json())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
