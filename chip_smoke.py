#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (xrseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as it finishes:

1. device: the card's name and power limit as nvidia-smi gives them, the
   torch and CUDA versions, and the seconds the nvcc build of
   xrseg_tpu_torch/csrc/ took (one nvcc per source, all started together;
   with ptxas's register/shared-memory report).
2. kernels, each against its plain torch version on the same card and
   inputs, and timed with CUDA events beside its plain version and its
   bound:
   - K1 (nms_select_batched_cuda) at B = 1, 8, 32, 128 with K = 8400 (the
     640x640 anchors; B = 128 is the launch plan's one-block-per-image
     end) and at B = 1, 8 with K = 21504 (the 1024x1024 anchors), and K2
     (nms_select_cuda) at K = 8400 and at a pre_topk-compacted K = 1024,
     on numpy-seeded inputs with bf16-quantised (tied) scores, below-gate
     candidates, zero-area boxes and an all-below-gate image. idx and ok
     must EQUAL the plain version's.
   - K3 (nms_rotated_batched_cuda) at K = 21504, B = 1, 8, 32, on rotated
     boxes with bf16-tied scores, zero-width boxes, thin near-parallel
     pairs and an all-below-gate image: idx and ok must EQUAL the plain
     version's.
   - Each NMS line names the cluster size (blocks per image) the launch
     plan chose and the microseconds per greedy step run. Then, per
     kernel, every cluster size 1, 2, 4, 8 forced at ragged K (8399, 8199,
     21503; B = 3 with an empty last image): idx and ok must EQUAL the
     plain version's, and a size whose blocks cannot hold K must raise.
     A K beyond the plan's largest must raise too.
   - K4 (mask_synth_crop_cuda) at B = 8, D = 50, 32 prototypes at 160x160
     on seeded inputs: the zeroed pixels must equal the plain version's
     and the values lie within 1e-5. Also timed beside the library
     formulation torch.sigmoid(coefs @ protos.T) + crop.
   - The conv epilogue (conv_epilogue_cuda) at the batch cells' shapes:
     every epilogue a YOLO11x-seg forward at b=32 and 640x640 runs (186)
     and every one a YOLO12x-seg forward at b=32 and 960x1280 runs (224,
     its 460-channel MLP on the 8-byte vectors), in the layout the
     forward gives each, on seeded inputs: every output must EQUAL the
     plain version's bit for bit. Each distinct shape is timed beside the
     plain version and its bytes bound, and the three are summed over the
     epilogues of each forward; then its launches for one call of the
     b=32 YOLO11x-seg and YOLO12x-seg pipelines and of the b=1 YOLO11n-seg
     one, counted from zero in ops/launches, every one of them on a
     channels-last output (its "channels_last" detail).
3. segment pipeline: YOLO11n-seg at full width (640x640, 80 classes, 32
   protos at 160x160, 8400 anchors, max_det 50) with detection_params
   weights, on 480x640 uint8 frames (stretch): build_pipeline at b=1 and
   b=8, once with emit_masks="none", and the b=1 postprocess() entry
   point. Launch counters are zeroed just before these runs and read just
   after: K1 and K2 must both have launched. Every slate must hold 50
   finite detections and equal the same pipeline built with
   nms_backend="scan". Then b=1 p50 latency and b=8 frames/s, each timed
   from host frames to a host copy of the slate. K4 is then checked on
   the coefs, protos and boxes of a coefs-only b=8 run of this path.
4. obb pipeline: YOLO11n-obb at full width (1024x1024, 15 classes, the
   angle branch, 21504 anchors, max_det 50) with detection_params
   weights, on 1024x1024 uint8 frames: build_pipeline at b=1 and b=8.
   Launch counters are zeroed just before these runs and read just after:
   K3 must have launched. Every slate must hold 50 finite detections and
   equal postprocess_obb_batch(backend="scan") on the same raw outputs.
   Then b=1 p50 latency and b=8 frames/s.
5. XR tick: the product path at full width. Two Executors on the segment
   model (emit_masks="none", 480x640 frames, a 128x128 depth plane,
   sampling_step 4), one with fused_tick (frame, re-lock, target mask and
   RGBD fusion as one program and one pinned readback on a copy stream),
   one classic (slate, then mask fetch, then fusion), each under an
   XRLoop: tick until a result, aim the controller at the first box, pull
   the trigger, check the lock, then 30 tracked ticks, fused and classic
   in turns on the same frames. Every fused tick must be tracked, carry a
   finite non-empty point cloud, and agree with the host TargetTracker on
   the same slate; classic must track the same index with the same
   points (valid equal; positions within one depth texel of the plane,
   2e-2 m, and all but 1% of them within 1e-4 m: the classic box goes
   through screen space and back, which can move a truncated depth index
   by one). K1's launches over the fused ticks must equal the dispatches.
   One tick runs from its uploads to its queued readback under torch's
   sync debug mode "error" (no operation may wait for the card); its
   packed output must equal its parts run apart on the card bit for bit, and extract_points must agree with extract_points_numpy
   (valid equal, positions within 1e-5 m). Prints tick p50/p95 and the
   tracer's per-stage means for both.
6. serving, on the segment model at full width on 480x640 frames:
   - the HTTP InferenceServer on 127.0.0.1 (ephemeral port) at
     micro_batch 8 (every bucket built first), then capped at 1 and at 8
     in turn, 16 client threads posting npy frames, 16 requests each. Every answer must equal the
     direct b=1 pipeline on its frame (count and labels equal, boxes
     within 0.5 px; the worst difference is printed); the micro-batch
     server must have run a batch of 8 and K1 must have launched with
     B=8. Prints requests/s and p50/p95 per micro-batch size. Then
     /reload of a save_npz of seed-1 weights must change the answers and
     make them equal a fresh b=1 pipeline on those weights, and with
     max_pending=1 and the device held a flood must get 503s and the
     server must answer again after it.
   - StreamingRunner at depth 1, 2, 3 over 64 b=1 frames and 32 b=8
     batches: every result equal to the direct call, in FIFO order;
     frames/s per depth; every batch staged through the pipeline's pinned
     ring once (`upload_staged`), printed with `slot_wait`.
   - PipelinedTickRunner at depth 1, 2, 3 over 60 tracked ticks: depth 1
     equal to the sequential fused executor (box and points), every depth
     locked on every tick; tick p50/p95 per depth.
   - the options: yuv420 planes give a full slate; params_dtype
     "bfloat16" against "float32" storage: launches per frame (the
     profiler's count), device ms and b=1 p50, and the launches must fall
     by at least the number of weight casts; mask_display_hw=(480, 640)
     gives finite masks of that shape; an o2o model (det_o2o seeded from
     det) gives 50/50 detections with no NMS launch.
   K1's launches are counted over the two timed server loads ("serve")
   and over the runners ("stream"): every reference, build, warm-up and
   lock comes first, and the counters are zeroed and read around each
   load and each runner's run alone, where K1 must have launched once a
   batch or a tick. The phase's numbers, and the seconds it spent on
   set-up and on its timed windows, are printed as one line
   "serve: {...}".
7. the task family and test-time augmentation, at full width on 480x640
   frames: YOLO11n-pose (1 class, 17 keypoints) and YOLOv8n-seg at
   640x640 and YOLO11n-cls (1000 classes) at 224x224, each at b=1 and
   b=8, and TTA pipelines: YOLO11n-seg with 2 views, YOLO11n-obb with 2
   views and with ULTRALYTICS_TTA_VIEWS (b=1 and b=8, K3 at 64512
   candidates), YOLO11n-pose with 2 views and the COCO-17 flip. Launch
   counters are zeroed just before the path and read just after: K1
   must have launched once per pose, YOLOv8, segment-TTA and pose-TTA
   batch, K3 once per obb-TTA batch, K2 and K4 never. Each launch's
   inputs are recorded, and one launch of each pipeline is then held
   against the plain version on its own inputs (idx and ok EQUAL) and
   timed. Every slate must be full and finite; pose and YOLOv8n-seg equal
   the plain NMS's decode of the same raw outputs; the classify b=8 rows
   equal the b=1 ones within 1e-4; each TTA NMS ran over views x anchors
   candidates. Then the server for pose and classify at micro-batch 1
   and 8 against the direct b=1 pipeline. One line "tasks: {...}" gives
   b=1 p50/p95 and b=8 frames/s per model beside the card's name and
   power limit, the server's numbers and the phase's seconds.
8. accuracy modes and model I/O, at full width (lines starting
   `accuracy:`):
   - K5 (wbf_scan_cuda) at K = 8400 (B = 1, 8) and 16800 (B = 1), K6
     (wbf_rotated_scan_cuda) at K = 21504 (B = 1, 8), on seeded clustered
     candidate streams (bf16-tied scores, about one in six above the gate,
     more clusters than max_det, for B > 1 an image with nothing above the
     gate): every output EQUAL to the plain scan's, timed beside the plain
     scan (run once) and the bound, with the microseconds per step of the
     live chain;
   - the split schedule (each label's chain apart, exact under the cap):
     the same seeded streams at K5 K = 8400 and K6 K = 21504, B = 1 and 8,
     relabelled three ways (one label, a skewed mix of 50/20/10/5% and the
     rest spread, uniform over the head's classes): every output EQUAL to
     the plain scan's (run once a case). Every case prints ms, the live
     steps, the longest chain, the chains pass B reran and the
     microseconds a step of the longest chain;
   - merge="wbf" on YOLO11n-seg at b=1 and b=8 (K5) and on YOLO11n-obb at
     1024x1024, b=1 (K6); the 2-member ensemble of YOLO11n-seg and
     YOLO11s-seg (640x640, 80 classes, detection_params from seeds 0 and
     1) merged by WBF (K5 at 16800) and by NMS (K1 at 16800). Launch
     counters are zeroed just before these runs and read just after: K5
     three times, K6 and K1 once each, at the paths' anchor widths. Every
     slate full, finite and equal to the plain merge on the same frames
     (the same pipeline with nms_backend="scan"; for obb,
     postprocess_obb_batch(backend="scan") on the same raw outputs); b=1
     p50/p95 and b=8 frames/s; K5 and K6 timed again on the paths' own
     candidate streams (every anchor live);
   - model I/O: a .pt of YOLO11n-seg written by the script's own inversion
     (the fused ultralytics form) and an .onnx from export_onnx each load
     back into a pipeline with the source slate; run_onnx on the card
     against the float32 forward (within ONNX_TOL); export_compiled and
     load_compiled on the card give the source slate through K1; the
     seconds of each;
   - Executor(depth_backend="native") on the phase-5 scene tracks the box
     of the torch backend with its points, held as phase 5 holds classic
     against fused.
   One line "accuracy: {...}" gives the pipelines' numbers beside the
   card's name and power limit, and the phase's seconds.
9. dataset evaluation and the host runtime surface (lines starting
   `eval:`):
   - evaluate_dataset on SyntheticShapesDataset(n=32, 480x640, 3
     classes) through YOLO11n-seg at 640x640 with detection_params
     weights, batch 8, with a COCO results dump. Launch counters are
     zeroed just before and read just after: K1 once per batch (at B=8)
     and nothing else. Every image's detections (at least one each) and
     the result dict equal the same eval with nms_backend="scan"; the
     dump, read back, has a row per detection;
   - evaluate_task_dataset for pose (a YOLO11n-pose with the synthetic
     set's 5-keypoint skeleton, 2 classes, 640x640; K1 once per batch of
     4) and obb (YOLO11n-obb at 1024x1024 on 1024x1024 images; K3 once
     per batch of 4), each equal to the eval through the same decode with
     the plain NMS;
   - parity_report on 4 augmented frames, the card pipeline in bf16 and
     in float32 without TF32 against the CPU float32 oracle (a reading);
   - a Y4M clip of the phase-5 frames through VideoFrameSource into an
     Executor(multi_tracking=True): every frame's boxes equal the direct
     b=1 pipeline's on the decoded frame, and the track ids persist;
   - check_environment(require_cuda=True) ok (its checks printed), a
     profile_fn trace of the b=1 pipeline naming K1's __global__, and
     `python -m xrseg_tpu_torch.eval --data synthetic --max-images 16`
     as a subprocess printing a JSON line with n_images 16.
   One line "eval: {...}" gives the results, the parity readings, the
   launches and the phase's seconds beside the card's name and power
   limit.
10. training (lines starting `train:`):
   - Trainer.fit on YOLO11n-seg at full width (640x640, 80 classes, bf16,
     remat, EMA, mosaic) with detection_params weights from seed 0, on
     SyntheticShapesDataset(n=32, 480x640, 3 classes) at batch 8 for 2
     epochs, validating each epoch on 8 other images. The launch counters
     are zeroed just before each validation and read just after: K1 once
     at B=8 and nothing else. Every step's loss and grad_norm finite; the
     memory preflight ran. The validation then equals the same eval
     through the plain NMS (nms_backend="scan"), image for image. A fresh
     Trainer resumes from state.pt for one epoch: the step count, the
     optimizer's count and the LR horizon continue (8 -> 12 steps).
   - the step time and images/s of bf16 remat steps at b=8 on one batch,
     with a profile of them (device ms, idle share, launches), beside the
     preflight estimate and the measured peak memory, and the Loader's
     host work alone (ms a batch of 8, augmentation included) beside fit's
     seconds a step;
   - one float32 "highest" step at b=2 (320x320 input) on the card
     against the same step on the CPU: metrics within rtol 1e-4, the
     clipped gradient within 1e-3 of each leaf's max abs, params and
     moments within rtol 1e-4, atol 1e-5;
   - two steps each of YOLO11n-obb (1024x1024, 15 classes), a YOLO11n-pose
     with the synthetic set's 5-keypoint skeleton and YOLO11n-cls (224x224,
     1000 classes) through Trainer.fit, finite losses; the obb one
     validates 4 images: K3 once and nothing else.
   One line "train: {...}" gives the history, every step's metrics, the
   readings and the phase's seconds beside the card's name and power
   limit.
11. fine-tuning and label efficiency (lines starting `label_efficiency:`):
   - transfer_params of a detection_params YOLO11n-seg (80 classes) on the
     card to a 3-class segmenter and to a 1-class pose model: each report
     equal to the same transfer of the donor on the CPU, every copied leaf
     bit-equal to the donor's, the 3-class convs at the YOLO prior bias;
     then one epoch of Trainer.fit from the 3-class model on 16 synthetic
     480x640 images at b=8 (bf16, remat), validating 8 (the counters
     zeroed around the validation: K1 once at B=8), losses finite;
   - model_info at 640x640: 2,868,648 parameters; its FLOP count (torch's
     FlopCounterMode) printed beside ultralytics' published 10.4 GFLOPs and
     held only to 8-13;
   - distillation of YOLO11n-seg from a YOLO11s-seg teacher at 640x640,
     bf16, remat, b=8 on random images: 10 timed steps (ms a step,
     images/s) and a profile of 3 (device ms, idle share, launches a
     step), losses finite; one float32 "highest" distill step at b=2
     (320x320) on the card against the CPU (the clipped gradient within
     1e-3 of each leaf's max abs); two steps of a YOLOv8n-seg student under
     the YOLO11n-seg model;
   - generate_pseudo_samples, rank_frames("margin") and
     rank_frames("flip") over 8 seeded 480x640 frames through the 80-class
     model, the counters zeroed around each: K1 8, 8 and 16 times at B=1
     and nothing else, each result equal to the same call through the
     plain NMS (boxes, labels, polygons; order and uncertainties); the
     pseudo-labels' COCO JSON read back through CocoDataset with the same
     labels;
   - each training script's main(argv) with --device cuda at 64-128 px on
     npz and PNG files under build/label_efficiency/scripts: examples.train
     (--weights an 80-class npz, --classes 3: the transfer reported),
     train_tasks (pose), train_toy, distill, tools.pseudo_label and
     tools.select_frames, each returning 0 and writing its output.
   One line "label_efficiency: {...}" gives the readings, the launches
   and the phase's seconds beside the card's name and power limit.
12. multi-device serving (lines starting `parallel:`), YOLO11n-seg at
   full width on 480x640 frames with detection_params weights from seed
   0, over meshes that repeat the one card ([cuda:0] * n). The launch
   counters are zeroed just before each path's run and read just after;
   every reference and warm-up comes first:
   - DP over (2, 1) at b=8: K1 once a shard (B=4), each shard's rows
     bit-equal to build_pipeline(batch=4) on them;
   - DP over (2, 1) at b=8, DP+TP over (1, 2) with tp_min_channels=256
     at b=4 and SP over 2 row bands at b=1, all float32 without TF32,
     against the unsharded pipeline: counts equal, scores within 1e-4
     (the JAX tests' bound);
   - PP over [cuda:0, cuda:0]: run_stream over 16 frames, each slate
     equal to the direct b=1 pipeline's, K1 once a frame;
   - MultiStreamRunner(n_streams=2): each stream equal to the b=1
     pipeline on its frame, K1 twice;
   - YOLO11n-obb at 1024x1024 over DP (2, 1) at b=4: K3 once a shard,
     each shard bit-equal to build_pipeline(batch=2);
   - the HTTP server with mesh_shape {"data": 1}: /healthz reports the
     mesh, 4 answers equal the direct b=1 pipeline's, K1 once each;
   - multihost at world size 1 over nccl: global_mesh, replicate_params,
     shard_host_batch and gather_to_hosts give the b=2 pipeline's slate;
   - each inference script's main(argv) with --device cuda: examples.demo
     (3 PNGs), examples.serve (3 paths), tools.track_video (a 4-frame
     Y4M clip) and tools.task_accuracy_report (its own 640x640), each
     with its K1 (and K3 for the obb table) launches. The report's tables
     are checked: 25 images each; pose and obb find as many detections as
     the CPU oracle, at mAP >= 0.95 (the script runs float32 at "default"
     precision, so TF32 may reorder near-tied scores among the 8400
     anchors that detection_params makes fire); classify agrees on every
     top-1 with probabilities within 1e-6. The same pose and obb tables
     with TF32 off must match the oracle exactly (mAP 1).
   With one card, the DP, PP and SP times measure what sharding costs in
   host work, not a speed-up. One line "parallel: {...}" gives them, the
   launches and the phase's seconds beside the card's name and power
   limit.
13. training over a mesh (lines starting `mesh_train:`), YOLO11n-seg at
   full width (640x640, 80 classes) at b=8 on 480x640 synthetic images,
   over meshes that repeat the one card:
   - DP (2, 1) and TP (1, 2) with tp_min_channels=256, float32
     "highest": one step against the unsharded step on the same batch
     (sample weights unequal across the shards, one padding row): loss
     and grad norm within rtol 1e-4, every param within atol 2e-5, rtol
     2e-4 (tests/test_train.py's bounds);
   - FSDP (2, 1) at the default fsdp_min_size: 3 steps against DP, loss
     within rtol 2e-4, params as above; the slices' shapes before and
     after (halves of the split dim, the module's leaf empty);
   - ms a step, device ms and launches a step of the bf16 remat step,
     unsharded, DP, TP and FSDP (on one card: the host work of a split,
     not a speed-up);
   - Trainer.fit over DP (2, 1): bf16, remat, one epoch of 16 images, the
     memory preflight on one shard, validation of 8 images (the counters
     zeroed around it: K1 once at B=8), save() and a resumed epoch;
   - the DP distill step (YOLO11s-seg -> YOLO11n-seg) against the
     unsharded one, float32 "highest";
   - YOLO11n-obb at 1024x1024: 2 DP steps against the unsharded ones,
     then a DP fit whose validation launches K3 once;
   - the step across processes at world size 1 over nccl, from
     shard_host_batch, within 1e-3 of the unsharded step;
   - examples.train --mesh 1 --fsdp and examples.distill --mesh 1.
   One line "mesh_train: {...}" gives the readings, the launches and the
   phase's seconds beside the card's name and power limit.
14. the .sentis route (lines starting `sentis:`), YOLO11n-seg at full
   width with detection_params weights from seed 0 written as a uint8
   .sentis template (testing.sentis_template) under build/sentis:
   - load_params_auto reads it (every leaf within half a quantization
     step of the source), the model goes to the card, and build_pipeline
     at b=1 and b=8 on the phase-3 frames, with the launch counters
     zeroed just before and read just after, launches K1 once a batch
     and nothing else; each slate equals the plain NMS's on the same
     model and the slate of the same weights read back from save_npz,
     bit for bit;
   - an Executor with the fused tick under an XRLoop on the loaded model
     locks the first box and tracks it for 10 ticks, each with a finite
     non-empty cloud and the host tracker's match, K1 once a dispatch;
   - redeploy: 3 bf16 train steps at b=8 (make_train_step, as phase 10),
     then write_yolo11_sentis into a copy of the template: the program
     region changes only inside scale/zero-point scalars (and the loaded
     weights written back change fewer than 64 of its bytes), the reload
     holds every trained float32 leaf within 0.51 * step + 1e-7, and its
     b=8 pipeline launches K1 once with the plain NMS's slate; the ONNX
     export of the trained model reloads to it bit for bit.
   One line "sentis: {...}" gives the seconds of parse, load, the steps
   and the write, the K1 launches of each part and the phase's seconds
   beside the card's name and power limit.
15. the main path's probe tools (lines starting `probes:`), each
   tool's main(argv) with --device cuda at full width (YOLO11n-seg,
   640x640, 80 classes, 8400 anchors) and its JSON row parsed; the
   launch counters are zeroed just before each tool and read just after,
   and the calls of every CompiledPipeline and XRTickPipeline (each one
   dispatch, warm-ups included) are counted beside them:
   - tools.xr_probe --frames 120 with detection_params weights from seed
     0 on 480x640 synthetic frames with depth and pose, sequential,
     --fused and --fused --pipelined 2 (depth 1 then 2): rc 0, 120 timed
     frames a window with points in every one (points_min > 0), K1 once
     a dispatch and nothing else; fps, lost frames, points and the stage
     split;
   - tools.executor_probe 60 (after 8 warm-up frames): K1 once a
     dispatch (69); p50/p95, interactive fps, the ticks spent in RUNNING
     before the CUDA event query flipped, the wait/readback split;
   - tools.loadtest in-process at micro-batch 1 and 8, 16 clients x 20
     requests of 640x640 frames (the tool caps its server's queue at one
     request a client: the default cap, 8 requests at micro-batch 1,
     sheds 16 clients' posts with 503s): 320 answered, no error; K1 once
     a batch
     the server ran plus once a pipeline warm-up, and the batch
     histogram adds up to the load and run_load's 19 warm-up posts;
   - tools.loadtest --url against `python -m
     xrseg_tpu_torch.runtime.server --port 0 --frame-hw 640 640
     --micro-batch 8 --max-pending 16`, then micro-batch 1, each started
     as a separate process (its
     `serving on` line within 120 s), stopped with terminate, wait and
     kill: 320 answered, no error, /stats counts every post (and at
     micro-batch 8 its batch_hist adds up to them);
   - tools.o2o_latency_ab --frames 150: the plain pipeline launches K1
     once a call (warm-ups included) and the o2o pipeline no NMS kernel;
     each arm's p50/p95/p99 and worst frames.
   One line "probes: {...}" gives the readings, the launches and the
   seconds beside the card's name and power limit.
16. the last tools (lines starting `tools:`), each tool's main(argv) with
   --device cuda at full width, the launch counters zeroed just before
   each tool and read just after:
   - tools.stage_profile 128 (YOLO11n-seg at 640x640, bf16, random init
     from seed 0): 8 stage rows in the JAX tool's order and a
     WHOLE_PIPELINE row, each ms finite and > 0; K1 launched at B=128 only,
     once a call of the pipeline and once a call of the postprocess stage
     (42 each); the FLOPs of stages 2-7 (FlopCounterMode) equal the b=128
     forward's and model_info's b=1 GFLOPs x 128 within its rounding to
     0.01; each stage's TF/s as a share of the 989 TF/s bf16 dense peak
     beside the card's name and power limit; then the postprocess stage
     again on detection_params outputs at b=128 (50 detections an image);
   - tools.ab_o2o, ab_letterbox (random init), ab_active and ab_distill
     (a port-written 80-class detection_params npz as the donor; YOLOv8n
     students, --pure-arm --combo-arm --label-fraction 0.5), 640x640,
     --n-train 16 --n-val 8, batch 8, 1 epoch or 2 steps: every row
     finite with the JAX tool's keys and configs, every loss finite, and
     every K1 launch inside an evaluate_dataset, rank_frames or
     generate_pseudo_samples call; ab_o2o's o2o_nms_free evaluations
     launch none and its classic_nms ones some; ab_letterbox's evals
     launch K1 under both deploy geometries; ab_active's and
     ab_distill's ranking, pseudo-labelling and every evaluation do.
   One line "tools: {...}" gives the readings, the launches and the
   seconds beside the card's name and power limit.
17. one line {"kernels": [...]} (K1-K6 and the conv epilogue; launches
   are counted on the path that runs each kernel, K1's over the segment
   path, the fused ticks,
   the serve loads, the runners, the task paths, the NMS ensemble, the
   segment and pose evals, the training validations, the transferred
   fit's validation, the pseudo-labels and both rankings, phase 12's
   parallel paths and scripts, phase 13's mesh fit validation, phase
   14's .sentis serve, tick and redeploy paths, phase 15's probe tools
   and phase 16's tools, K3's
   over the obb, obb-TTA, obb eval, obb training-validation, obb DP,
   task-report and obb mesh fit validation paths, K5's and K6's over
   phase 8's WBF paths, the epilogue's over every phase; no path runs
   K4, as in the JAX package), then the
   last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check exits non-zero before the last line. Without a CUDA
device it exits 2 and runs nothing.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import json
import re
import select
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from xrseg_tpu_torch import _build
from xrseg_tpu_torch.compile import (DEFAULT_TTA_VIEWS,
                                     ULTRALYTICS_TTA_VIEWS, CompiledPipeline,
                                     XRTickPipeline,
                                     build_ensemble_pipeline, build_pipeline,
                                     build_xr_tick_pipeline,
                                     decode_task_outputs, export_compiled,
                                     load_compiled, pack_slate,
                                     unpack_slate)
from xrseg_tpu_torch.config import (ExecutorConfig, ModelConfig,
                                    PostprocessConfig)
from xrseg_tpu_torch.eval import dataset_eval
from xrseg_tpu_torch.eval.dataset_eval import (evaluate_dataset,
                                               evaluate_task_dataset)
from xrseg_tpu_torch.eval.parity import augment_images, parity_report
from xrseg_tpu_torch.eval.task_parity import task_parity_report
from xrseg_tpu_torch.io import torch_pt
from xrseg_tpu_torch.io.onnx_exec import run_onnx
from xrseg_tpu_torch.io.onnx_export import export_onnx
from xrseg_tpu_torch.io.sentis import parse_sentis, write_yolo11_sentis
from xrseg_tpu_torch.examples import demo as ex_demo
from xrseg_tpu_torch.examples import distill as ex_distill
from xrseg_tpu_torch.examples import serve as ex_serve
from xrseg_tpu_torch.examples import train as ex_train
from xrseg_tpu_torch.examples import train_tasks as ex_train_tasks
from xrseg_tpu_torch.examples import train_toy as ex_train_toy
from xrseg_tpu_torch.io.weights import (flatten_params, load_params_auto,
                                        params_to_tree, save_npz,
                                        transfer_params)
from xrseg_tpu_torch.models import layers as L
from xrseg_tpu_torch.models import yolo11
from xrseg_tpu_torch.models.yolo11 import model_info
from xrseg_tpu_torch.nms_times import (GATE, IOU, MAX_DET, cuda_ms, nms_inputs,
                                       rotated_inputs, steps_run)
from xrseg_tpu_torch.ops import conv_epilogue as ce
from xrseg_tpu_torch.ops import depth_fusion as df
from xrseg_tpu_torch.ops import launches as launch_counts
from xrseg_tpu_torch.ops import mask_kernels as mk
from xrseg_tpu_torch.ops import masks as mask_ops
from xrseg_tpu_torch.ops import nms as nms_ops
from xrseg_tpu_torch.ops import nms_kernels as nk
from xrseg_tpu_torch.ops import preprocess as pre_ops
from xrseg_tpu_torch.ops import wbf
from xrseg_tpu_torch.ops.postprocess import (postprocess,
                                             postprocess_obb_batch,
                                             postprocess_pose_batch)
from xrseg_tpu_torch.ops.relock import relock_match
from xrseg_tpu_torch.ops.yuv import rgb_to_yuv420_numpy
from xrseg_tpu_torch.parallel import multihost as mh
from xrseg_tpu_torch.parallel.batch import (MultiStreamRunner,
                                            build_serving_pipeline,
                                            build_sharded_pipeline)
from xrseg_tpu_torch.parallel.mesh import make_mesh
from xrseg_tpu_torch.parallel.pipeline import PipelinedRunner
from xrseg_tpu_torch.parallel.spatial import build_spatial_pipeline
from xrseg_tpu_torch.perception.tracking import (TargetTracker,
                                                 box_to_model_space,
                                                 parse_boxes)
from xrseg_tpu_torch.precision import precision_scope
from xrseg_tpu_torch.profile import frame_step, profile_batch
from xrseg_tpu_torch.runtime.deploy_check import check_environment
from xrseg_tpu_torch.runtime.executor import Executor
from xrseg_tpu_torch.runtime.frame_source import FrameData
from xrseg_tpu_torch.runtime.profiling import profile_fn
from xrseg_tpu_torch.runtime.server import InferenceServer
from xrseg_tpu_torch.runtime.streaming import (PipelinedTickRunner,
                                               StreamingRunner)
from xrseg_tpu_torch.runtime.video import VideoFrameSource
from xrseg_tpu_torch.runtime.xr_loop import (ControllerState, XRLoop,
                                             aim_controller_at_frame_point)
from xrseg_tpu_torch.testing import (detection_params, epilogue_calls,
                                     sentis_template, xr_frames)
from xrseg_tpu_torch.tools import ab_active as tool_ab_active
from xrseg_tpu_torch.tools import ab_distill as tool_ab_distill
from xrseg_tpu_torch.tools import ab_letterbox as tool_ab_letterbox
from xrseg_tpu_torch.tools import ab_o2o as tool_ab_o2o
from xrseg_tpu_torch.tools import executor_probe as tool_executor_probe
from xrseg_tpu_torch.tools import loadtest as tool_loadtest
from xrseg_tpu_torch.tools import o2o_latency_ab as tool_o2o_ab
from xrseg_tpu_torch.tools import pseudo_label as tool_pseudo
from xrseg_tpu_torch.tools import select_frames as tool_select
from xrseg_tpu_torch.tools import stage_profile as tool_stage_profile
from xrseg_tpu_torch.tools import task_accuracy_report as tool_task_report
from xrseg_tpu_torch.tools import track_video as tool_track
from xrseg_tpu_torch.tools import xr_probe as tool_xr_probe
from xrseg_tpu_torch.train import active as active_lib
from xrseg_tpu_torch.train import data as data_lib
from xrseg_tpu_torch.train import pseudo as pseudo_lib
from xrseg_tpu_torch.train import train_step as train_ts
from xrseg_tpu_torch.train.active import rank_frames
from xrseg_tpu_torch.train.distill import make_distill_step
from xrseg_tpu_torch.train.pseudo import (coco_from_samples,
                                          generate_pseudo_samples)
from xrseg_tpu_torch.train.trainer import TrainConfig, Trainer

# H100 SXM data sheet: HBM rate, and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# per candidate per greedy step: the argmax compare, the IoU row (min, max,
# sub, clamp, mul for the overlap; sub, clamp, mul for the area; add, sub,
# div for the union and ratio) and the suppression test
OPS_PER_CANDIDATE_STEP = 20
# K3, per live candidate per step: the probIoU row (3 sums, 2 differences;
# the denominator 2 mul, sub, clamp, add; t1 2 squares, 2 mul, add, div,
# mul; t2 sub, 2 mul, div, mul; t3 mul, clamp, sqrt, mul, add, div, add,
# log, mul; bd 2 add, clamp; iou neg, exp, sub, add, sqrt, sub), the
# suppression test and the skip test; plus, for every candidate, the
# argmax compare
OPS_PER_LIVE_ROTATED = 43
DEVICE = "cuda"
# the segment path: YOLO11n-seg at full width on 480x640 camera frames
MODEL = ModelConfig()                 # 640x640, 80 classes, 32 protos
FRAME_HW = (480, 640)
# the obb path: YOLO11n-obb (yolo11-obb.yaml at scale n, DOTAv1's 15
# classes) at its 1024x1024 input, on 1024x1024 frames
OBB_MODEL = ModelConfig(task="obb", num_classes=15, input_size=(1024, 1024))
OBB_FRAME_HW = (1024, 1024)
# the XR tick: the segment model on the same frames, with a depth frame
DEPTH_HW = (128, 128)
N_TICKS = 30
TICK_DEADLINE_S = 60.0
K1_BATCHES = (1, 8, 32, 128)
K_ONCE = 128                          # from this B on the plain loop runs once
# (kernel, K) of the forced-cluster cases: ragged slices at every size
FORCED = (("K1", 8399), ("K1", 21503), ("K2", 8399), ("K3", 8199),
          ("K3", 21503))
K1_WIDE_BATCHES = (1, 8)
K3_BATCHES = (1, 8, 32)
K_FULL, K_COMPACT = 8400, 1024
K_OBB = OBB_MODEL.num_anchors         # 21504
K4_SHAPE = dict(B=8, D=MAX_DET, nm=MODEL.num_masks, hw=MODEL.mask_size)
# the conv epilogue at the batch cell's model and batch
EPILOGUE_MODEL = ModelConfig(scale="x")
EPILOGUE_MODEL_12 = ModelConfig(arch="yolo12", scale="x",
                                input_size=(960, 1280))
EPILOGUE_BATCH = 32
# the serve phase: 16 distinct 480x640 frames sent as npy bodies by 16
# client threads, 16 requests each, to a server at micro-batch 1 and 8
SERVE_FRAMES, SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 16, 16
SERVE_WINDOW_MS = 3.0
BACKLOG_CONNECTS = 32
SERVE_TIMEOUT_S = 60.0
# frame pixels; answers are rounded to 0.01 px, and a batch of 8 may run
# other cuDNN algorithms than a batch of 1, which can move the last bits
SERVE_BOX_TOL = 0.5
# scores of bf16 logits near 2.0 (detection_params): a few bf16 ulps of
# the logit through the sigmoid's slope there (0.1)
SERVE_SCORE_TOL = 4 * 2 ** -6 * 0.1
# the exact-parity configuration, whose answers must not depend on the
# batch: float32 compute without TF32
EXACT_MODEL = dataclasses.replace(MODEL, dtype="float32",
                                  matmul_precision="highest")
SERVE_DIR = Path(__file__).resolve().parent / "build" / "serve"
STREAM_B1_FRAMES, STREAM_B8_BATCHES = 64, 32
# the task family at full width: YOLO11n-pose (ultralytics
# yolo11n-pose.yaml: 1 class, 17 keypoints of 3 values) at 640x640,
# YOLO11n-cls (yolo11-cls.yaml, 1000 classes) at 224x224 and YOLOv8n-seg
# (yolov8-seg.yaml, 80 classes) at 640x640, all on 480x640 frames
POSE_MODEL = ModelConfig(task="pose", num_classes=1)
CLS_MODEL = ModelConfig(task="classify", num_classes=1000,
                        input_size=(224, 224))
V8_MODEL = ModelConfig(arch="yolov8")
# the COCO-17 skeleton's left/right joint permutation under a mirror
COCO17_FLIP = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)
# classify probabilities at another batch size (bf16 convs, TF32 product)
CLS_PROB_TOL = 1e-4
TASK_SERVE_PER_CLIENT = 4
PIPE_TICKS = 60                       # PipelinedTickRunner ticks per depth
# phase 8: the WBF kernels at the main paths' widths (the segment path's
# 8400 anchors at one image and eight, a 2-member ensemble's 16800; the obb
# path's 21504), the score gate of PostprocessConfig's default
WBF_CASES = (("K5", 1, 8400), ("K5", 8, 8400), ("K5", 1, 16800),
             ("K6", 1, 21504), ("K6", 8, 21504))
# the split schedule's cases: one stream each (seeded by K and B),
# relabelled by centre three ways; "skewed" gives labels 0-3 shares of
# 50/20/10/5% and spreads the rest over the other labels
WBF_MIXES = ("one", "skewed", "uniform")
WBF_MIX_CASES = (("K5", 1, 8400), ("K5", 8, 8400), ("K6", 1, 21504),
                 ("K6", 8, 21504))
WBF_SKEW = (0.5, 0.2, 0.1, 0.05)
WBF_GATE = 0.23
# operations: (per overlap of a candidate with an open cluster of its
# label, per live candidate). K5's overlap: 2 min, 2 max, 2 sub, 2 clamp
# and a mul for the intersection, add, sub, clamp, div for the ratio, the
# threshold and label tests, the argmax compare; its step: the candidate's
# corners and area (11) and a merge with the fused box's refresh (25). K6's
# overlap: K3's probIoU (43), clamp, the two tests; its step: the
# candidate's cos/sin of 2a and Gaussian terms (28) and a merge with the
# refresh (atan2, 4 div, Gaussian terms: 45)
WBF_OPS = {False: (15, 36), True: (46, 73)}
# the 2-member ensemble: YOLO11n-seg and YOLO11s-seg (yolo11-seg.yaml at
# scales n and s, 640x640, 80 classes)
S_MODEL = dataclasses.replace(MODEL, scale="s")
IO_DIR = Path(__file__).resolve().parent / "build" / "io"
# run_onnx against the float32 forward: boxes are pixels up to 640, summed
# in float32 in another order
ONNX_TOL = 2e-3
NATIVE_TICKS = 10
# phase 9: the eval datasets (the synthetic pose set draws 5 keypoints, so
# its YOLO11n-pose has a 5-keypoint head), the K1/K2/K3 __global__ name
EVAL_N = 32
POSE_EVAL_MODEL = ModelConfig(task="pose", num_classes=2, kpt_shape=(5, 3))
EVAL_DIR = Path(__file__).resolve().parent / "build" / "eval"
# phase 10: the training set (480x640 synthetic shapes), batch, validation
# images, the float32 card-against-CPU step's input, the timed steps
TRAIN_N = 32
TRAIN_BATCH = 8
TRAIN_VAL_N = 8
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train"
TRAIN_EXACT_HW = (320, 320)
TRAIN_TIMED_STEPS = 5
# phase 11: the transfer targets, the fit's training set, the distill
# step's timed and profiled steps, the pseudo/active frames
LE_SEG_MODEL = dataclasses.replace(MODEL, num_classes=3)
LE_POSE_MODEL = ModelConfig(task="pose", num_classes=1)
LE_FIT_N = 16
LE_TIMED_STEPS = 10
LE_PROFILED_STEPS = 3
LE_FRAMES = 8
LE_SEED = 11
LE_DIR = Path(__file__).resolve().parent / "build" / "label_efficiency"
# phase 12: multi-device serving over meshes of the one card
PAR_DIR = Path(__file__).resolve().parent / "build" / "parallel"
PAR_STREAM_FRAMES = 16
PAR_SCORE_TOL = 1e-4               # tests/test_parallel.py's bound
PAR_TIMED = 5
TASK_REPORT_SIZE = 640             # the report script's own default
TASK_REPORT_MIN_MAP = 0.95         # pose/obb under TF32 (see phase 12)
TASK_REPORT_PROB_TOL = 1e-6        # classify probabilities, card vs CPU
# phase 13: training over a mesh
MESH_BATCH = 8
MESH_FIT_N = 16
MESH_TIMED = 3                     # steps a turn, two turns a config
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh_train"
MESH_LOSS_RTOL = 1e-4              # tests/test_train.py's sharded bound
FSDP_LOSS_RTOL = 2e-4              # tests/test_train.py's FSDP bounds
MESH_PARAM_ATOL = 2e-5
MESH_PARAM_RTOL = 2e-4
# phase 14 (.sentis)
SENTIS_DIR = Path(__file__).resolve().parent / "build" / "sentis"
SENTIS_TICKS = 10
SENTIS_BATCH = 8                    # the redeploy's train steps
SENTIS_STEPS = 3
SENTIS_LR = 1e-4
SENTIS_PROGRAM_BYTES = 64           # tests/test_sentis_loader.py's bound
K1_GLOBAL = "greedy_nms_kernel"
SOURCE = "xrseg_tpu_torch/csrc/nms_select.cu"
K1 = dict(name="nms_select_batched_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:218")
K2 = dict(name="nms_select_cuda", route="cuda", source=SOURCE,
          replaces="xrseg_tpu/ops/pallas_kernels.py:125")
K3 = dict(name="nms_rotated_batched_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/nms_rotated.cu",
          replaces="xrseg_tpu/ops/pallas_kernels.py:420")
K4 = dict(name="mask_synth_crop_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/mask_synth_crop.cu",
          replaces="xrseg_tpu/ops/pallas_kernels.py:297",
          launches_note="no path of build_pipeline runs K4: as in the JAX "
                        "package, the pipeline keeps the unfused "
                        "synthesize_masks + crop_masks formulation")
K7 = dict(name="conv_epilogue_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/conv_epilogue.cu", replaces="none",
          replaces_note="the port's own kernel: the JAX conv_apply "
                        "(xrseg_tpu/models/layers.py) leaves bias, SiLU and "
                        "the cast to XLA's fusion")
WBF_NOTE = ("the port's own kernel: no TPU kernel computes WBF; it stands for "
            "the JAX package's lax.scan, one sequential step a candidate")
K5 = dict(name="wbf_scan_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/wbf.cu",
          replaces="xrseg_tpu/ops/wbf.py:90", replaces_note=WBF_NOTE)
K6 = dict(name="wbf_rotated_scan_cuda", route="cuda",
          source="xrseg_tpu_torch/csrc/wbf.cu",
          replaces="xrseg_tpu/ops/wbf.py:188", replaces_note=WBF_NOTE)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(n_bytes: float, n_ops: float):
    """The least time for the work: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    check(bool(smi), "nvidia-smi reported no card")
    print(smi, flush=True)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"cards {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"device: kernel build {build_s:.2f} s (nvcc, sm_90a, "
          f"{len(paths)} sources in parallel)", flush=True)
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "bytes stack" in line:
                print(f"device: ptxas {name}: {line.strip()}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def nms_bound(ok: torch.Tensor, K: int):
    """Least time for the work these inputs need: each image's data read
    once and its slate written once; the steps the loop runs (until the
    first non-ok step) over K candidates."""
    B = ok.shape[0]
    steps = sum(min(int(n) + 1, MAX_DET) for n in ok.sum(-1).tolist())
    return bound(B * K * 5 * 4 + B * MAX_DET * 5,
                 steps * K * OPS_PER_CANDIDATE_STEP)


def rotated_bound(rows: torch.Tensor, masked: torch.Tensor):
    """Least time for the work K3 does on these inputs: the rows and scores
    read once, the slate written once; per step that runs, the argmax over
    all K and the probIoU row over the candidates still live (the kernel
    skips the rest), as the plain loop replays it."""
    B, K = masked.shape
    ops = 0
    active = torch.ones(B, dtype=torch.bool, device=masked.device)
    for _, ok, m in nk.rotated_steps(rows, masked, IOU, MAX_DET):
        ok = ok[:, 0] & active                 # an image exits at its first
        live = (m > nk.NEG * 0.5).sum(-1)      # non-ok step
        ops += int(active.sum()) * K \
            + int(torch.where(ok, live, 0).sum()) * OPS_PER_LIVE_ROTATED
        active = ok
        if not bool(active.any()):
            break
    return bound(B * K * 7 * 4 + B * MAX_DET * 5, ops)


def plan_cluster(what: str, masked: torch.Tensor) -> int:
    """The cluster size launch_plan chooses for these scores on this card."""
    B, K = masked.reshape(-1, masked.shape[-1]).shape
    return nk.launch_plan(what, B, K, *nk.device_limits(what, masked.device))[0]


def event_ms(fn):
    """fn()'s result and the device time of that one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_case(kernel, plain, args, label: str, what: str, bound_fn,
             iters: int = 50, plain_once: bool = False):
    idx, ok = kernel(*args, IOU, MAX_DET)
    (ref_idx, ref_ok), plain_ms = event_ms(lambda: plain(*args, IOU, MAX_DET))
    torch.cuda.synchronize()
    check(torch.equal(idx, ref_idx) and torch.equal(ok, ref_ok),
          f"{label}: kernel idx/ok differ from the plain version")
    err = max(float((idx - ref_idx).abs().max()),
              float((ok.int() - ref_ok.int()).abs().max()))
    ms = cuda_ms(lambda: kernel(*args, IOU, MAX_DET), iters)
    if not plain_once:
        plain_ms = cuda_ms(lambda: plain(*args, IOU, MAX_DET), 3, 1)
    bound_ms, bound_by = bound_fn(ok.reshape(-1, MAX_DET))
    steps = steps_run(ok)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                cluster=plan_cluster(what, args[1]), steps=steps,
                us_per_step=1e3 * ms / steps,
                n_ok=ok.reshape(-1, MAX_DET).sum(-1).tolist())
    n_ok = case["n_ok"] if len(case["n_ok"]) <= 32 else \
        f"{min(case['n_ok'])}..{max(case['n_ok'])} over {len(case['n_ok'])}"
    print(f"kernels: {label}: equal, cluster {case['cluster']}, {ms:.4f} ms, "
          f"{case['us_per_step']:.3f} us a step over {steps} steps (plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}), "
          f"ok per image {n_ok}", flush=True)
    return case


def forced_cluster_cases(rng) -> None:
    """Every cluster size forced at ragged K: equal to the plain version
    where the size's blocks hold K, refused where they do not."""
    for name, K in FORCED:
        if name == "K3":
            args = rotated_inputs(rng, 3, K)
            kernel, plain = (nk.nms_rotated_batched_cuda,
                             nk.nms_rotated_batched_torch)
        else:
            args = nms_inputs(rng, 3, K)
            kernel, plain = (nk.nms_select_batched_cuda,
                             nk.nms_select_batched_torch)
            if name == "K2":
                args = tuple(a[0] for a in args)
                kernel, plain = nk.nms_select_cuda, nk.nms_select_torch
        ref = plain(*args, IOU, MAX_DET)
        ran, refused = [], []
        for cluster in nk.CLUSTER_SIZES:
            try:
                got = kernel(*args, IOU, MAX_DET, cluster=cluster)
            except ValueError as e:
                check("cannot hold" in str(e)
                      and cluster < nk.CLUSTER_SIZES[-1],
                      f"{name} K={K} cluster {cluster}: refused: {e}")
                refused.append(cluster)
                continue
            torch.cuda.synchronize()
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"{name} K={K} forced cluster {cluster}: idx/ok differ "
                  "from the plain version")
            ran.append(cluster)
        print(f"kernels: {name} K={K} forced clusters {ran}: equal"
              + (f"; {refused} refused (the blocks cannot hold K)"
                 if refused else ""), flush=True)


def refusal_cases() -> None:
    """A K beyond the launch plan's largest must raise, not launch."""
    for what, kernel, shape in (
            ("nms_select", nk.nms_select_batched_cuda, lambda K: (1, K, 4)),
            ("nms_rotated", nk.nms_rotated_batched_cuda, lambda K: (1, 6, K))):
        K = nk.max_candidates(what, torch.device(DEVICE)) + 1
        geo = torch.zeros(shape(K), device=DEVICE)
        masked = torch.zeros((1, K), device=DEVICE)
        before = launch_counts.read()[kernel.__name__]
        try:
            kernel(geo, masked, IOU, MAX_DET)
        except ValueError as e:
            check(f"limit of {K - 1} " in str(e),
                  f"{what}: the refusal does not name the limit: {e}")
        else:
            raise SmokeFailure(f"{what}: K={K} beyond the largest was taken")
        check(launch_counts.read()[kernel.__name__] == before,
              f"{what}: a refused call counted")
        print(f"kernels: {what} refuses K={K} (largest {K - 1})", flush=True)


def phase_nms_kernels():
    rng = np.random.default_rng(0)
    k1_cases, k2_cases, k3_cases = {}, {}, {}
    for K, batches, extent in ((K_FULL, K1_BATCHES, 640.0),
                               (K_OBB, K1_WIDE_BATCHES, 1024.0)):
        for B in batches:
            c, m = nms_inputs(rng, B, K, extent)
            k1_cases[B, K] = run_case(
                nk.nms_select_batched_cuda, nk.nms_select_batched_torch,
                (c, m), f"K1 B={B} K={K}", "nms_select",
                lambda ok, K=K: nms_bound(ok, K), plain_once=B >= K_ONCE)
    for K in (K_FULL, K_COMPACT):
        c, m = nms_inputs(rng, 1, K)
        k2_cases[K] = run_case(nk.nms_select_cuda, nk.nms_select_torch,
                               (c[0], m[0]), f"K2 K={K}", "nms_select",
                               lambda ok, K=K: nms_bound(ok, K))
    for B in K3_BATCHES:
        rows, m = rotated_inputs(rng, B, K_OBB)
        k3_cases[B] = run_case(
            nk.nms_rotated_batched_cuda, nk.nms_rotated_batched_torch,
            (rows, m), f"K3 B={B} K={K_OBB}", "nms_rotated",
            lambda ok, rows=rows, m=m: rotated_bound(rows, m), iters=20)
    forced_cluster_cases(rng)
    refusal_cases()
    # the main paths' shapes: K1 at b=8 and K2 at the full anchor count of
    # the segment path, K3 at b=8 of the obb path
    return [dict(K1, main=k1_cases[8, K_FULL], cases=list(k1_cases.values())),
            dict(K2, main=k2_cases[K_FULL], cases=list(k2_cases.values())),
            dict(K3, main=k3_cases[8], cases=list(k3_cases.values()))]


def k4_library(coefs, protos, boxes, mask_hw, input_size):
    """The library formulation: one batched matmul, sigmoid, crop."""
    B, h, w, nm = protos.shape
    logits = coefs @ protos.reshape(B, h * w, nm).transpose(1, 2)
    return mask_ops.crop_masks(torch.sigmoid(logits).reshape(B, -1, h, w),
                               boxes, input_size)


def k4_case(coefs, protos, boxes, label: str, iters: int = 50):
    """K4 against its plain version (exact crop, values within 1e-5), timed
    beside the plain version and the library formulation."""
    args = (coefs, protos, boxes, MODEL.mask_size, MODEL.input_size)
    got = mk.mask_synth_crop_cuda(*args)
    ref = mk.mask_synth_crop_torch(*args)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and torch.equal(got == 0, ref == 0),
          f"{label}: K4 zeroes other pixels than the plain version")
    err = float((got - ref).abs().max())
    check(err <= 1e-5, f"{label}: K4 differs from the plain version by "
                       f"{err:.3e} > 1e-5")
    ms = cuda_ms(lambda: mk.mask_synth_crop_cuda(*args), iters)
    plain_ms = cuda_ms(lambda: mk.mask_synth_crop_torch(*args), iters)
    library_ms = cuda_ms(lambda: k4_library(*args), iters)
    B, D, nm = coefs.shape
    hw = protos.shape[1] * protos.shape[2]
    bound_ms, bound_by = bound(
        4 * B * (D * nm + hw * nm + D * 4) + 4 * B * D * hw,
        B * D * hw * (2 * nm + 8))            # + sigmoid (3) + crop (5)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                inside_share=float((ref != 0).float().mean()))
    print(f"kernels: {label}: crop equal, max |err| {err:.2e}, {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by}); "
          f"{case['inside_share']:.1%} of the values inside their box",
          flush=True)
    return case


def phase_k4_seeded():
    rng = np.random.default_rng(1)
    B, D, nm, (h, w) = (K4_SHAPE[k] for k in ("B", "D", "nm", "hw"))
    H, W = MODEL.input_size
    coefs = rng.standard_normal((B, D, nm)).astype(np.float32)
    protos = rng.standard_normal((B, h, w, nm)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 1, (B, D, 2)) * [W, H],
                            rng.uniform(0.02, 0.6, (B, D, 2)) * [W, H]],
                           -1).astype(np.float32)
    boxes[:, 0] = [8 * W / w, 6 * H / h, 4 * W / w, 4 * H / h]  # on centres
    args = [torch.from_numpy(a).to(DEVICE) for a in (coefs, protos, boxes)]
    case = k4_case(*args, f"K4 seeded B={B} D={D} {nm}x{h}x{w}")
    return dict(K4, main=case, cases=[case])


def epilogue_case(shape, act: bool, channels_last: bool, seed: int,
                   n: int, iters: int = 20) -> dict:
    """The epilogue at one shape: bit-equal to the plain version, then
    timed beside it and its bound (2 bytes read and 2 written an
    element); `n` epilogues of the forward have this shape."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    y = (torch.randn(shape, generator=g, device=DEVICE) * 3).to(
        torch.bfloat16)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    bias = torch.randn(shape[1], generator=g, device=DEVICE)
    want = ce.conv_epilogue_torch(y, bias, act)
    got = ce.conv_epilogue_cuda(y.clone(memory_format=torch.preserve_format),
                                bias, act)
    torch.cuda.synchronize()
    label = (f"conv_epilogue {'x'.join(map(str, shape))} "
             f"{'silu' if act else 'bias'} "
             f"{'channels-last' if channels_last else 'nchw'}")
    check(got.stride() == want.stride() and torch.equal(
        got.view(torch.int16), want.view(torch.int16)),
        f"{label}: the kernel differs from the plain version")
    err = float((got.float() - want.float()).abs().max())
    ms = cuda_ms(lambda: ce.conv_epilogue_cuda(y, bias, act), iters)
    plain_ms = cuda_ms(lambda: ce.conv_epilogue_torch(y, bias, act), 5, 1)
    bound_ms, bound_by = bound(4 * y.numel(), 0)
    return dict(case=label, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def epilogue_forward(name: str, cfg: ModelConfig, seed: int) -> tuple:
    """Every epilogue a b=EPILOGUE_BATCH forward of `cfg` runs, each
    distinct shape held bit-equal to the plain version and timed: (the
    summary of the forward, its cases, the model)."""
    model = yolo11.YOLO11(cfg).to(DEVICE)
    H, W = cfg.input_size
    calls = collections.Counter(epilogue_calls(
        model, torch.zeros(EPILOGUE_BATCH, H, W, 3, device=DEVICE)))
    cases = [epilogue_case(shape, act, cl, seed + i, n)
             for i, ((shape, act, cl), n) in enumerate(sorted(calls.items()))]
    n = sum(calls.values())
    total = {k: sum(c["n"] * c[k] for c in cases)
             for k in ("ms", "plain_ms", "bound_ms")}
    main = dict(case=f"conv_epilogue {name} b={EPILOGUE_BATCH} at {H}x{W}: "
                     f"the {n} epilogues of a forward", n=n,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                bound_by="bytes", **total)
    largest = max(cases, key=lambda c: c["bound_ms"])
    print(f"kernels: {main['case']} ({len(cases)} shapes, "
          f"{sum(c['n'] for c in cases if 'channels-last' in c['case'])} "
          f"channels-last): bit-equal, {total['ms']:.4f} ms summed (plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms by "
          f"bytes, {100 * total['bound_ms'] / total['ms']:.1f}% of it); "
          f"largest {largest['case']}: {largest['ms']:.4f} ms (plain "
          f"{largest['plain_ms']:.4f} ms, bound {largest['bound_ms']:.5f} ms)",
          flush=True)
    return main, cases, model


def phase_conv_epilogue() -> dict:
    main, cases, model = epilogue_forward("YOLO11x-seg", EPILOGUE_MODEL, 0)
    main12, cases12, model12 = epilogue_forward(
        "YOLO12x-seg", EPILOGUE_MODEL_12, len(cases))
    # its launches on the batch cells' paths and on the XR model's b=1
    # path, every one on a channels-last output (the network's layout)
    by_path, channels_last = {}, {}
    for name, cfg, m, batch in (
            ("batch yolo11x b=32", EPILOGUE_MODEL, model, EPILOGUE_BATCH),
            ("batch yolo12x b=32", EPILOGUE_MODEL_12, model12,
             EPILOGUE_BATCH),
            ("segment n b=1", MODEL, yolo11.YOLO11(MODEL), 1)):
        pipe = build_pipeline(ExecutorConfig(model=cfg), m,
                              frame_hw=FRAME_HW, batch=batch,
                              device=DEVICE).warmup()
        launch_counts.reset()
        pipe(pipe.dummy_input())["slate"].cpu()
        counts = launch_counts.read()
        by_path[name] = counts[K7["name"]]
        channels_last[name] = counts[K7["name"], "channels_last"]
        n_modules = sum(isinstance(mod, (L.Conv, L.Proto))
                        for mod in pipe.params.modules())
        check(by_path[name] == channels_last[name] == n_modules,
              f"{name}: {by_path[name]} epilogue launches a call, "
              f"{channels_last[name]} of them channels-last, "
              f"{n_modules} conv epilogues in the model")
        del pipe
    print(f"kernels: conv_epilogue launches a call {by_path}, channels-last "
          f"{channels_last}", flush=True)
    return dict(K7, main=main, cases=[main, main12] + cases + cases12,
                launches_by_path=by_path,
                launches_channels_last_by_path=channels_last)


# ---------------------------------------------------------------------------
# 3. the segment path
# ---------------------------------------------------------------------------

def check_det(det, B: int, masks: bool, what: str) -> None:
    mh, mw = MODEL.mask_size
    check(det["count"].shape == (B,) and bool((det["count"] == MAX_DET).all()),
          f"{what}: count {det['count'].tolist()} != {MAX_DET}")
    check(det["slate"].shape == (B, MAX_DET * 7 + 1)
          and bool(det["slate"].isfinite().all()), f"{what}: bad slate")
    if masks:
        check(tuple(det["masks"].shape) == (B, MAX_DET, mh, mw)
              and bool(det["masks"].isfinite().all()), f"{what}: bad masks")
    else:
        check(tuple(det["protos"].shape) == (B, mh, mw, MODEL.num_masks)
              and tuple(det["coefs"].shape) == (B, MAX_DET, MODEL.num_masks)
              and "masks" not in det, f"{what}: bad coefs-only outputs")


def host_ms(pipe, x, iters):
    """Per-call host times: host frames in, host copy of the slate out."""
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pipe(x)["slate"].cpu()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_segment():
    cfg = ExecutorConfig(model=MODEL)
    scan = dataclasses.replace(
        cfg, post=dataclasses.replace(cfg.post, nms_backend="scan"))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    frames = np.random.default_rng(1).integers(
        0, 256, (8,) + FRAME_HW + (3,), np.uint8)
    specs = {"b1": (1, "all"), "b8": (8, "all"), "b1_none": (1, "none")}

    def pipes(c):
        return {n: build_pipeline(c, model, frame_hw=FRAME_HW, batch=b,
                                  emit_masks=e, device=DEVICE).warmup()
                for n, (b, e) in specs.items()}

    kern, plain = pipes(cfg), pipes(scan)

    def b1_postprocess(post):
        x = pre_ops.preprocess(torch.from_numpy(frames[:1]).to(DEVICE),
                               MODEL.input_size, dtype=model.dtype)
        with torch.inference_mode():
            out = model(x)
            return postprocess(out["preds"], out["protos"], post,
                               device=DEVICE)

    # --- the main path, with the launch counters zeroed around it
    launch_counts.reset()
    runs = {}
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        for f in range(3):
            runs[name] = pipe(frames[f:f + B] if B == 1 else frames)
    runs["postprocess_b1"] = b1_postprocess(cfg.post)
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"pipeline: segment: launches on the path {launches}", flush=True)
    for k in (K1, K2):
        check(launches[k["name"]] > 0, f"{k['name']} never launched on the "
                                       "segment path")

    # --- every run against the same pipeline with the plain NMS
    for name, (B, emit) in specs.items():
        ref = plain[name](frames[2:3] if B == 1 else frames)
        check_det(runs[name], B, emit == "all", name)
        check(torch.equal(runs[name]["slate"], ref["slate"])
              and torch.equal(runs[name]["indices"], ref["indices"]),
              f"{name}: slate differs from nms_backend='scan'")
        print(f"pipeline: {name}: 50/50 detections per image, slate equal "
              "to nms_backend='scan'", flush=True)
    ref = b1_postprocess(scan.post)
    det = runs["postprocess_b1"]
    check(bool((det["count"] == MAX_DET).all())
          and tuple(det["masks"].shape) == (1, MAX_DET) + MODEL.mask_size
          and bool(det["masks"].isfinite().all()),
          "postprocess_b1: bad outputs")
    for key in ("indices", "boxes_xywh", "scores", "labels", "valid"):
        check(torch.equal(det[key], ref[key]),
              f"postprocess_b1: {key} differs from nms_backend='scan'")
    print("pipeline: postprocess_b1: 50/50 detections, equal to "
          "nms_backend='scan'", flush=True)

    # --- end-to-end timing, host frames in, host slate out
    name = torch.cuda.get_device_name(0)
    b1 = host_ms(kern["b1"], frames[:1], 30)
    b1_scan = host_ms(plain["b1"], frames[:1], 20)
    b8 = host_ms(kern["b8"], frames, 15)
    print(f"pipeline: segment b=1 p50 {statistics.median(b1):.3f} ms "
          f"(p95 {np.percentile(b1, 95):.3f} ms; with nms_backend='scan' "
          f"p50 {statistics.median(b1_scan):.3f} ms) on {name}", flush=True)
    print(f"pipeline: segment b=8 {8 * 1e3 / statistics.mean(b8):.1f} "
          f"frames/s (mean {statistics.mean(b8):.3f} ms per batch) on {name}",
          flush=True)

    # --- a coefs-only b=8 run: K4's inputs as the segment path makes them
    det = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=8,
                         emit_masks="none", device=DEVICE)(frames)
    check_det(det, 8, False, "b8_none")
    return det, launches


# ---------------------------------------------------------------------------
# 4. the obb path
# ---------------------------------------------------------------------------

def check_obb_det(det, B: int, what: str) -> None:
    check(det["count"].shape == (B,) and bool((det["count"] == MAX_DET).all()),
          f"{what}: count {det['count'].tolist()} != {MAX_DET}")
    check(tuple(det["boxes_xywhr"].shape) == (B, MAX_DET, 5)
          and bool(det["boxes_xywhr"].isfinite().all()),
          f"{what}: bad boxes_xywhr")
    check(det["slate"].shape == (B, MAX_DET * 8 + 1)
          and bool(det["slate"].isfinite().all()), f"{what}: bad slate")


def phase_obb() -> dict:
    cfg = ExecutorConfig(model=OBB_MODEL)
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    frames = np.random.default_rng(2).integers(
        0, 256, (8,) + OBB_FRAME_HW + (3,), np.uint8)
    kern = {n: build_pipeline(cfg, model, frame_hw=OBB_FRAME_HW, batch=b,
                              device=DEVICE).warmup()
            for n, b in (("b1", 1), ("b8", 8))}

    # --- the main path, with the launch counters zeroed around it
    launch_counts.reset()
    runs, last = {}, {}
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        for f in range(3):
            last[name] = frames[f:f + B] if B == 1 else frames
            runs[name] = pipe(last[name])
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"pipeline: obb: launches on the path {launches}", flush=True)
    check(launches[K3["name"]] > 0, f"{K3['name']} never launched on the "
                                    "obb path")

    # --- the scan comparison on the same raw outputs
    for name, pipe in kern.items():
        B = pipe.input_shape[0]
        check_obb_det(runs[name], B, f"obb {name}")
        x = pre_ops.preprocess(torch.from_numpy(last[name]).to(DEVICE),
                               OBB_MODEL.input_size, dtype=model.dtype)
        with torch.inference_mode():
            out = model(x, concat_preds=False)
            det = decode_task_outputs(out, cfg.model, cfg.post)
            ref = postprocess_obb_batch(out["boxes_xywhr"], out["cls_logits"],
                                        cfg.post, scores_are_logits=True,
                                        backend="scan")
        check(torch.equal(det["slate"], pack_slate(ref, MAX_DET)),
              f"obb {name}: slate differs from postprocess_obb_batch("
              "backend='scan') on the same raw outputs")
        check(torch.equal(runs[name]["slate"], det["slate"]),
              f"obb {name}: the pipeline's slate differs from its parts' run")
        print(f"pipeline: obb {name}: 50/50 detections per image, slate "
              "equal to postprocess_obb_batch(backend='scan')", flush=True)

    name = torch.cuda.get_device_name(0)
    b1 = host_ms(kern["b1"], frames[:1], 30)
    b8 = host_ms(kern["b8"], frames, 15)
    print(f"pipeline: obb b=1 p50 {statistics.median(b1):.3f} ms "
          f"(p95 {np.percentile(b1, 95):.3f} ms) on {name}", flush=True)
    print(f"pipeline: obb b=8 {8 * 1e3 / statistics.mean(b8):.1f} frames/s "
          f"(mean {statistics.mean(b8):.3f} ms per batch) on {name}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# 5. the XR tick
# ---------------------------------------------------------------------------

def tick_until_result(loop: XRLoop, frame, controller=None):
    """Feed `frame` and poll the loop until its result: (result, ms). The
    controller snapshot is handled once, on the first call."""
    t0 = time.perf_counter()
    result = loop.tick(frame, controller)
    while result is None:
        check(time.perf_counter() - t0 < TICK_DEADLINE_S,
              f"no result within {TICK_DEADLINE_S:.0f} s "
              f"(state {loop.executor.state})")
        result = loop.tick(frame)
    return result, (time.perf_counter() - t0) * 1e3


def start_tracking(loop: XRLoop, frames) -> None:
    """First result, then aim at its first box and pull the trigger."""
    ex = loop.executor
    first, _ = tick_until_result(loop, frames[0])
    check(first.count == MAX_DET, f"first tick: {first.count} detections")
    b = first.boxes[0]
    w, h = ex.screen_wh
    ctl = aim_controller_at_frame_point(
        frames[1].intrinsics, frames[1].pose,
        (b.center_x + w / 2, b.center_y + h / 2), (w, h))
    ctl.trigger = True
    tick_until_result(loop, frames[1], ctl)
    check(loop.selected and ex.is_tracking and loop.laser_visible,
          "the trigger did not lock a target")


def release_and_reset(loop: XRLoop) -> None:
    """Trigger released and B pressed, on a tick without a camera image."""
    loop.tick(FrameData(rgb=None), ControllerState(button_b=True))
    check(not loop.executor.is_tracking and not loop.laser_visible,
          "the B button did not reset tracking")


def check_tracked(ex: Executor, prev_locked, r, what: str) -> None:
    """A tracked tick: target set, cloud finite and non-empty, and the
    match equal to the host tracker's on the same slate."""
    check(r.tracked is not None, f"{what}: target lost")
    pc = r.point_cloud
    check(pc is not None and len(pc.positions) > 0
          and bool(np.isfinite(pc.positions).all())
          and bool(np.isfinite(pc.depths).all()),
          f"{what}: empty or non-finite point cloud")
    oracle = TargetTracker(ex.cfg.tracking_gate_px, ex.cfg.select_margin_px)
    oracle.locked_box, oracle.is_tracking = prev_locked, True
    want = oracle.update(r.boxes)
    check(want is not None and want.index == r.tracked.index,
          f"{what}: tracked index {r.tracked.index}, the host tracker says "
          f"{None if want is None else want.index}")


def stage_means(ex: Executor) -> str:
    s = ex.tracer.summary()
    return ", ".join(f"{k} {s[k]['mean_ms']:.3f} (x{s[k]['count']})"
                     for k in ("dispatch", "device_wait", "readback",
                               "process", "mask_fetch", "depth_fusion")
                     if k in s)


def check_packed_parts(cfg, model, frame, locked) -> None:
    """One tick's packed output against its parts, each run apart on the
    card and read back on its own: equal bit for bit. Then the fusion
    against the numpy oracle."""
    tick = build_xr_tick_pipeline(cfg, model, frame_hw=FRAME_HW,
                                  depth_hw=DEPTH_HW, device=DEVICE)
    plain = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=1,
                           emit_masks="none", device=DEVICE)
    size = tuple(map(float, MODEL.input_size))
    w, h = float(FRAME_HW[1]), float(FRAME_HW[0])
    cx, cy, _, _ = box_to_model_space(locked, (w, h), size)
    intr, pose = frame.intrinsics, frame.pose
    aux = tick.pack_aux(intr.focal_length, intr.principal_point,
                        intr.resolution, pose.position, pose.rotation,
                        (cx, cy, float(locked.label), 1.0),
                        (w / size[1], h / size[0]))
    x = torch.from_numpy(frame.rgb[None]).to(DEVICE)
    a = torch.from_numpy(aux).to(DEVICE)
    depth = df.depth_bits(frame.depth_fp16, DEVICE)
    # from the uploads to the queued copy the host only queues work: any
    # operation that waits for the card raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tick.enqueue((x, depth, a))
        tick.readback.start(out["packed"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tick.readback.wait()
    packed = torch.from_numpy(tick.readback.host().copy())
    check(torch.equal(packed, out["packed"].cpu()),
          "the pinned readback differs from packed.cpu()")
    got = tick.unpack(packed)
    print("tick: no operation between the uploads and the queued readback "
          "waits for the card (sync debug mode 'error'); the pinned buffer "
          "equals packed.cpu()", flush=True)

    det = plain(frame.rgb[None])
    dcfg = cfg.depth
    with torch.inference_mode(), precision_scope(MODEL.matmul_precision):
        boxes = det["boxes_xywh"][0]
        matched, idx = relock_match(boxes, det["labels"][0], det["valid"][0],
                                    a[13:17], a[17:19],
                                    gate_px=cfg.tracking_gate_px)
        mask = mask_ops.synthesize_one_mask(det["coefs"][0], det["protos"][0],
                                            idx)
        box = mask_ops.select_row(boxes, idx)
        pts = df.extract_points(
            depth, mask, box, a[0:2], a[2:4], a[4:6], a[6:9], a[9:13],
            confidence_threshold=dcfg.confidence_threshold,
            min_depth=dcfg.min_depth_m, max_depth=dcfg.max_depth_m,
            sampling_step=dcfg.sampling_step, mask_hw=MODEL.mask_size)
    check(bool(matched.cpu()) and bool(got["matched"]),
          "packed vs parts: the tick did not match its target")
    parts = torch.cat([det["slate"][0].cpu(),
                       torch.stack([matched.float(), idx.float()]).cpu(),
                       mask.reshape(-1).cpu(),
                       pts["packed"].reshape(-1).cpu()])
    check(packed.shape == parts.shape and torch.equal(packed, parts),
          "packed differs from its parts run apart on the card")
    print(f"tick: packed [{packed.numel()}] equals slate | relock_match | "
          "synthesize_one_mask | extract_points run apart, bit for bit",
          flush=True)

    ref = df.extract_points_numpy(
        frame.depth_fp16, mask.cpu().numpy(), box.cpu().numpy(),
        intr.focal_length, intr.principal_point, intr.resolution,
        pose.position, pose.rotation,
        confidence_threshold=dcfg.confidence_threshold,
        min_depth=dcfg.min_depth_m, max_depth=dcfg.max_depth_m,
        sampling_step=dcfg.sampling_step)
    valid = pts["valid"].cpu().numpy()
    err = float(np.abs(pts["positions"].cpu().numpy()
                       - ref["positions"]).max())
    check(np.array_equal(valid, ref["valid"]) and valid.any(),
          "extract_points: valid differs from extract_points_numpy")
    check(err <= 1e-5, f"extract_points differs from extract_points_numpy "
                       f"by {err:.3e} m > 1e-5")
    print(f"tick: extract_points on the card equals extract_points_numpy "
          f"({int(valid.sum())} of {valid.size} points valid, max |err| "
          f"{err:.2e} m)", flush=True)


def phase_tick() -> dict:
    model = detection_params(torch.Generator().manual_seed(0), MODEL,
                             device=DEVICE)
    frames = xr_frames(N_TICKS + 2, FRAME_HW, DEPTH_HW, seed=3)
    loops = {}
    for name, fused in (("fused", True), ("classic", False)):
        cfg = ExecutorConfig(model=MODEL, fused_tick=fused, emit_masks="none")
        ex = Executor(cfg, params=model, frame_hw=FRAME_HW, device=DEVICE)
        loops[name] = XRLoop(ex)
    fused, classic = loops["fused"].executor, loops["classic"].executor

    # --- one tick each, not counted: the first fused dispatch binds and
    # warms the tick pipeline of this geometry
    for loop in loops.values():
        tick_until_result(loop, frames[0])

    # --- the main path (fused ticks only), with the launch counters zeroed
    # around it
    launch_counts.reset()
    before = fused.tracer.counters["frames_dispatched"]
    start_tracking(loops["fused"], frames)
    first_locked = fused.tracker.locked_box
    for i, frame in enumerate(frames[2:]):
        prev = fused.tracker.locked_box
        rf, _ = tick_until_result(loops["fused"], frame)
        check_tracked(fused, prev, rf, f"fused tick {i}")
    torch.cuda.synchronize()
    launches = read_counters()
    dispatched = fused.tracer.counters["frames_dispatched"] - before
    check(launches[K1["name"]] == dispatched == N_TICKS + 2,
          f"fused ticks: K1 launched {launches[K1['name']]} times over "
          f"{dispatched} dispatches")
    st = fused.tracer.summary()
    check("mask_fetch" not in st or st["mask_fetch"]["count"] == 0,
          "a fused tracked tick fetched a mask on its own")
    print(f"tick: fused: target locked over {N_TICKS} ticks at full width, "
          f"device relock equals the host tracker on every tick, K1 "
          f"launched {launches[K1['name']]} times over {dispatched} "
          "dispatches", flush=True)

    # --- fused and classic in turns on the same frames
    release_and_reset(loops["fused"])
    for loop in loops.values():
        loop.executor.tracer.reset()
        start_tracking(loop, frames)
    ms = {"fused": [], "classic": []}
    worst, far, total = 0.0, 0, 0
    for i, frame in enumerate(frames[2:]):
        rf, t = tick_until_result(loops["fused"], frame)
        ms["fused"].append(t)
        rc, t = tick_until_result(loops["classic"], frame)
        ms["classic"].append(t)
        check(rc.tracked is not None and rf.tracked is not None
              and rc.tracked.index == rf.tracked.index,
              f"tick {i}: classic and fused track different boxes")
        pf, pc = rf.point_cloud.positions, rc.point_cloud.positions
        check(pf.shape == pc.shape and len(pf) > 0,
              f"tick {i}: {len(pf)} fused points, {len(pc)} classic")
        d = np.abs(pf - pc).max(-1)
        worst, far, total = max(worst, float(d.max())), \
            far + int((d > 1e-4).sum()), total + len(d)
    check(worst <= 2e-2 and far <= 0.01 * total,
          f"classic points differ from fused: max {worst:.3e} m, {far} of "
          f"{total} beyond 1e-4 m")
    print(f"tick: classic tracks the same box with the same points over "
          f"{N_TICKS} ticks (max |diff| {worst:.2e} m, {far} of {total} "
          "points beyond 1e-4 m)", flush=True)
    name = torch.cuda.get_device_name(0)
    for k in ("fused", "classic"):
        print(f"tick: {k} p50 {statistics.median(ms[k]):.3f} ms, p95 "
              f"{np.percentile(ms[k], 95):.3f} ms over {N_TICKS} ticks on "
              f"{name}; stage means (ms): "
              f"{stage_means(loops[k].executor)}", flush=True)

    check_packed_parts(fused.cfg, model, frames[2], first_locked)
    return launches


# ---------------------------------------------------------------------------
# 6. serving: the HTTP server, the streaming runners, the pipeline options
# ---------------------------------------------------------------------------

def http(port: int, body: bytes, path: str = "/infer"):
    """POST to the local server: (status, json body)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def connects_before_accept(listener) -> int:
    """How many of BACKLOG_CONNECTS connects to a fresh `listener` (an
    HTTP server class) complete within 2 s while no accept loop runs:
    those past its listen backlog have their SYNs dropped and retry
    seconds later."""
    srv = listener(("127.0.0.1", 0), BaseHTTPRequestHandler)
    socks = []
    try:
        for _ in range(BACKLOG_CONNECTS):
            s = socket.socket()
            socks.append(s)
            s.setblocking(False)
            s.connect_ex(srv.server_address)
        pending, deadline = set(socks), time.monotonic() + 2.0
        while pending and time.monotonic() < deadline:
            _, done, _ = select.select([], list(pending), [], 0.1)
            pending -= set(done)
        return sum(s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0
                   for s in socks if s not in pending)
    finally:
        for s in socks:
            s.close()
        srv.server_close()


def npy_bytes(frame: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, frame)
    return buf.getvalue()


def flood(port: int, bodies, clients: int, per_client: int):
    """`clients` threads, each posting `per_client` requests in turn:
    [(frame index, status, json, ms)] and the wall seconds of the whole."""
    out = [None] * (clients * per_client)

    def client(c):
        for k in range(per_client):
            i = c * per_client + k
            t0 = time.perf_counter()
            status, body = http(port, bodies[i % len(bodies)])
            out[i] = (i % len(bodies), status, body,
                      (time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), "a client did not finish")
    return out, time.perf_counter() - t0


def answers_match(results, ref, what: str, exact: bool = True) -> str:
    """Every response against the direct b=1 pipeline's answer on its
    frame: status 200, count and labels equal. exact: every box within
    SERVE_BOX_TOL px, row by row. Otherwise (bf16 compute at another
    batch size) the descending scores within SERVE_SCORE_TOL, and the rows
    whose box moved are counted: bf16 logits tie by the hundred over 8400
    anchors, ties go to the lower anchor, and one ulp of difference moves
    an anchor within its tie. Returns what was found, for the log."""
    worst, moved, rows = 0.0, 0, 0
    for i, status, body, _ in results:
        check(status == 200, f"{what}: status {status}: {body}")
        want = ref[i]
        check(body["count"] == want["count"] == MAX_DET,
              f"{what}: frame {i}: count {body['count']} != {want['count']}")
        got_l = [d["label"] for d in body["detections"]]
        check(got_l == [d["label"] for d in want["detections"]],
              f"{what}: frame {i}: labels differ from the b=1 pipeline")
        diff = np.abs(np.array([d["box_xywh"] for d in body["detections"]])
                      - [d["box_xywh"] for d in want["detections"]]).max(-1)
        if exact:
            worst = max(worst, float(diff.max()))
            continue
        scores = [d["score"] for d in body["detections"]]
        err = np.abs(np.array(scores)
                     - [d["score"] for d in want["detections"]]).max()
        check(err <= SERVE_SCORE_TOL, f"{what}: frame {i}: scores differ "
                                      f"from the b=1 pipeline by {err:.4f}")
        worst = max(worst, float(err))
        moved += int((diff > SERVE_BOX_TOL).sum())
        rows += len(diff)
    if exact:
        check(worst <= SERVE_BOX_TOL, f"{what}: boxes differ from the b=1 "
                                      f"pipeline by {worst:.3f} px")
        return f"worst box difference {worst:.3f} px"
    return (f"worst score difference {worst:.4f}; {moved} of {rows} rows "
            "hold another anchor of the same score tie")


def serve_numbers(results, wall_s: float) -> dict:
    ms = [r[3] for r in results]
    return {"requests_per_s": len(results) / wall_s,
            "p50_ms": statistics.median(ms),
            "p95_ms": float(np.percentile(ms, 95))}


def direct_answers(srv: InferenceServer, pipe, frames) -> list:
    """The server's JSON for each frame, computed by a direct b=1 pipeline
    call and the server's own host-side formatting."""
    out = []
    for f in frames:
        slate = pipe(f[None])["slate"][0].cpu()
        out.append(srv._format(unpack_slate(slate, MAX_DET), 0.0))
    return out


def warm_buckets(srv: InferenceServer, bodies) -> None:
    """Run every bucket once before timing: b requests at once, with the
    server's cap set to b so that the batch goes as soon as it is full.
    The dispatch thread builds bucket b and warms the CUDA state PyTorch
    keeps per thread for its shapes. Then the server's counters start
    from zero."""
    cap, window = srv.micro_batch, srv.batch_window_ms
    srv.batch_window_ms = 1000.0
    try:
        b = 1
        while b <= cap:
            srv.micro_batch = b
            results, _ = flood(srv.port, bodies, b, 1)
            check(all(r[1] == 200 for r in results), "warm-up request")
            b *= 2
    finally:
        srv.micro_batch, srv.batch_window_ms = cap, window
    srv._batch_hist.clear()
    srv.tracer.reset()


SPENT: dict = {}


@contextlib.contextmanager
def spent(what: str):
    """Add the wall seconds of the block to SPENT[what]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPENT[what] = SPENT.get(what, 0.0) + time.perf_counter() - t0


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_server(cfg, model, frames, b1) -> tuple:
    """The server at micro-batch 1 and 8 under 16 clients, /reload, and
    503 shedding. Returns the K1 launches of the two timed loads and
    their numbers."""
    name = torch.cuda.get_device_name(0)
    bodies = [npy_bytes(f) for f in frames]
    # room for every client, so the timed loads shed nothing
    srv = InferenceServer(cfg, params=model, frame_hw=FRAME_HW, port=0,
                          micro_batch=8, batch_window_ms=SERVE_WINDOW_MS,
                          max_pending=2 * SERVE_CLIENTS,
                          device=DEVICE).start()
    try:
        with spent("server set-up"):
            ref = direct_answers(srv, b1, frames)
            # why the server runs every request on its one dispatch
            # thread: a thread's first frame rebuilds CUDA state PyTorch
            # keeps per thread
            fresh = []
            th = threading.Thread(
                target=lambda: fresh.extend(host_ms(b1, frames[:1], 2)))
            th.start()
            th.join()
            print(f"serve: a b=1 frame on a fresh thread: {fresh[0]:.3f} "
                  f"ms, then {fresh[1]:.3f} ms; on the main thread p50 "
                  f"{statistics.median(host_ms(b1, frames[:1], 5)):.3f} ms"
                  f" on {name}", flush=True)
            warm_buckets(srv, bodies)
            # why the server listens with a backlog of its own: 16
            # clients connect at once, and a SYN dropped past the
            # backlog retries 1, 2, 4 ... s later, past a client timeout
            ours = connects_before_accept(type(srv.httpd))
            default = connects_before_accept(ThreadingHTTPServer)
            check(ours == BACKLOG_CONNECTS,
                  f"{ours} of {BACKLOG_CONNECTS} connects reached the "
                  "server's listen backlog")
            print(f"serve: {ours} of {BACKLOG_CONNECTS} connects completed "
                  "before the accept loop ran at the server's backlog of "
                  f"{srv.httpd.request_queue_size}; {default} at "
                  f"socketserver's default of "
                  f"{ThreadingHTTPServer.request_queue_size}", flush=True)

        # one server takes both loads: its dispatch thread reads the cap
        # for every batch, so micro-batch 1 is the same server capped at 1
        numbers, hist = {}, {}
        launch_counts.reset()
        for mb in (1, 8):
            srv.micro_batch = mb
            srv._batch_hist.clear()
            srv.tracer.reset()
            with spent("server timed"):
                results, wall = flood(srv.port, bodies, SERVE_CLIENTS,
                                      SERVE_PER_CLIENT)
            found = answers_match(results, ref, f"server mb={mb}",
                                  exact=(mb == 1))
            numbers[mb] = serve_numbers(results, wall)
            hist[mb] = {str(k): v for k, v in sorted(srv._batch_hist.items())}
            stages = {k: round(srv.stats()["stages"][k]["p50_ms"], 3)
                      for k in ("decode", "infer")}
            print(f"serve: micro_batch {mb}: {len(results)} requests from "
                  f"{SERVE_CLIENTS} clients, "
                  f"{numbers[mb]['requests_per_s']:.1f} requests/s, p50 "
                  f"{numbers[mb]['p50_ms']:.3f} ms, p95 "
                  f"{numbers[mb]['p95_ms']:.3f} ms on {name}; server stage "
                  f"p50 ms {stages}; batches {hist[mb]}; answers against the"
                  f" b=1 pipeline: {found}", flush=True)
        launches = read_counters()
        by_batch = k1_by_batch()
        check(hist[1] == {"1": SERVE_CLIENTS * SERVE_PER_CLIENT},
              f"micro-batch 1 ran other batches: {hist[1]}")
        check(any(int(n) > 4 for n in hist[8]),
              "the micro-batch server never ran its bucket of 8")
        check(by_batch.get(8, 0) > 0, f"K1 never launched with B=8 on the "
                                      f"serve path: {by_batch}")
        check(launches[K1["name"]] == sum(hist[1].values())
              + sum(hist[8].values()),
              f"K1 launched {launches[K1['name']]} times over the batches "
              f"{hist}")
        print(f"serve: K1 launches by batch size {by_batch}", flush=True)

        # /reload: seed-1 weights change the answers, which then equal a
        # fresh pipeline on those weights
        with spent("reload"):
            new = detection_params(torch.Generator().manual_seed(1),
                                   cfg.model, device=DEVICE)
            path = SERVE_DIR / "seed1.npz"
            save_npz(str(path), new)
            status, body = http(srv.port,
                                json.dumps({"path": str(path)}).encode(),
                                "/reload")
            check(status == 200 and body["ok"], f"/reload: {status} {body}")
            fresh = direct_answers(srv, build_pipeline(
                cfg, new, frame_hw=FRAME_HW, batch=1, device=DEVICE),
                frames[:4])
            after = [(i, *http(srv.port, bodies[i]), 0.0) for i in range(4)]
            check(any(a[2]["detections"] != ref[a[0]]["detections"]
                      for a in after), "/reload did not change the answers")
            answers_match(after, fresh, "after /reload")
        print("serve: /reload of a seed-1 npz changed the answers; they "
              "equal a fresh b=1 pipeline on those weights", flush=True)
    finally:
        srv.close()

    # the exact-parity configuration: every micro-batched answer equals
    # the b=1 pipeline box for box
    exact_cfg = ExecutorConfig(model=EXACT_MODEL)
    exact = detection_params(torch.Generator().manual_seed(0), EXACT_MODEL,
                             device=DEVICE)
    with spent("exact server"):
        srv = InferenceServer(exact_cfg, params=exact, frame_hw=FRAME_HW,
                              port=0, micro_batch=8,
                              batch_window_ms=SERVE_WINDOW_MS,
                              max_pending=2 * SERVE_CLIENTS,
                              device=DEVICE).start()
        try:
            ref = direct_answers(srv, build_pipeline(
                exact_cfg, exact, frame_hw=FRAME_HW, batch=1,
                device=DEVICE), frames)
            warm_buckets(srv, bodies)
            results, _ = flood(srv.port, bodies, SERVE_CLIENTS, 2)
            found = answers_match(results, ref, "exact server mb=8")
            print(f"serve: float32 without TF32, micro_batch 8: every "
                  f"answer equals the b=1 pipeline ({found}); batches "
                  f"{srv.stats()['batch_hist']}", flush=True)
        finally:
            srv.close()

    # shedding: with the device held, a flood against max_pending=1 gets
    # 503s at once (the dispatch thread holds one request and the queue
    # one more); then the server answers again
    with spent("shedding"):
        srv = InferenceServer(cfg, params=model, frame_hw=FRAME_HW, port=0,
                              max_pending=1, device=DEVICE).start()
        try:
            results = [None] * SERVE_CLIENTS

            def one(i):
                results[i] = http(srv.port, bodies[i % len(bodies)])

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            with srv._lock:
                for t in threads:
                    t.start()
                deadline = time.monotonic() + SERVE_TIMEOUT_S
                while sum(r is not None and r[0] == 503 for r in results) \
                        < SERVE_CLIENTS - 2:
                    check(time.monotonic() < deadline,
                          "no 503 under the flood")
                    time.sleep(0.01)
            for t in threads:
                t.join(timeout=SERVE_TIMEOUT_S)
            codes = sorted(r[0] for r in results)
            check(codes == [200] * 2 + [503] * (SERVE_CLIENTS - 2),
                  f"flood codes {codes}")
            check(http(srv.port, bodies[0])[0] == 200,
                  "no recovery after 503s")
            print(f"serve: max_pending=1 shed {SERVE_CLIENTS - 2} of "
                  f"{SERVE_CLIENTS} flooding requests with 503, then "
                  "answered again", flush=True)
        finally:
            srv.close()
    return launches, numbers


def slate_rows(slate) -> list:
    """Host copies of a [B, L] slate's unpacked rows."""
    return [unpack_slate(row, MAX_DET) for row in slate.cpu()]


def same_rows(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in b)


def phase_streaming(pipes, frames) -> tuple:
    """StreamingRunner at depth 1, 2, 3 against direct calls, frame for
    frame in FIFO order; frames/s per depth. The references are computed
    first; the counters are zeroed and read around each runner's run
    alone, which must launch K1 once a batch."""
    name = torch.cuda.get_device_name(0)
    out, launches = {}, {}
    for B, n in ((1, STREAM_B1_FRAMES), (8, STREAM_B8_BATCHES)):
        pipe = pipes[B]
        # batch i starts at frame i, so it repeats every len(frames)
        batches = [np.roll(frames, -i, 0)[:B] for i in range(n)]
        with spent("stream references"):
            want = [slate_rows(pipe(x)["slate"])
                    for x in batches[:len(frames)]]
        for depth in (1, 2, 3):
            runner = StreamingRunner(pipe, depth=depth)
            torch.cuda.synchronize()
            launch_counts.reset()
            with spent("stream timed"):
                t0 = time.perf_counter()
                results = list(runner.run(iter(batches)))
                fps = n * B / (time.perf_counter() - t0)
            counts = read_counters()
            add_counts(launches, counts)
            staged = launch_counts.read()
            check(counts[K1["name"]] == n, f"stream b={B} depth {depth}: "
                  f"K1 launched {counts[K1['name']]} times over {n} batches")
            check(staged["upload_staged"] == n, f"stream b={B} depth "
                  f"{depth}: {staged['upload_staged']} staged uploads over "
                  f"{n} batches")
            check([r.frame_id for r in results] == list(range(n)),
                  f"stream b={B} depth {depth}: results out of order")
            for r in results:
                rows = [r.slate] if B == 1 else [
                    {k: r.slate[k][j] for k in r.slate} for j in range(B)]
                ref = want[r.frame_id % len(frames)]
                check(all(same_rows(g, w) for g, w in zip(rows, ref)),
                      f"stream b={B} depth {depth}: frame {r.frame_id} "
                      "differs from the direct call")
            out[B, depth] = fps
            print(f"stream: StreamingRunner b={B} depth {depth}: {n} "
                  f"batches equal to direct calls in FIFO order, {fps:.1f} "
                  f"frames/s on {name}; upload_staged "
                  f"{staged['upload_staged']}, slot_wait "
                  f"{staged['upload_staged', 'slot_wait']}", flush=True)
    return out, launches


def locked_executor(model, frames):
    cfg = ExecutorConfig(model=MODEL, fused_tick=True, emit_masks="none")
    ex = Executor(cfg, params=model, frame_hw=FRAME_HW, device=DEVICE)
    first = ex.run_sync(frames[0])
    b = first.boxes[0]
    check(ex.select_target_from_screen_pos(
        (b.center_x + ex.screen_wh[0] / 2, b.center_y + ex.screen_wh[1] / 2)),
        "the executor did not lock its first box")
    return ex


def phase_pipelined_ticks(model) -> tuple:
    """PipelinedTickRunner at depth 1, 2, 3 over PIPE_TICKS tracked ticks:
    depth 1 equals the sequential fused executor; deeper stays locked.
    The sequential reference and every executor's lock come first; the
    counters are zeroed and read around each runner's ticks alone, which
    must launch K1 once a tick."""
    name = torch.cuda.get_device_name(0)
    frames = xr_frames(PIPE_TICKS + 1, FRAME_HW, DEPTH_HW, seed=5)
    with spent("tick set-up"):
        seq = locked_executor(model, frames)
        want = [seq.run_sync(f) for f in frames[1:]]
        executors = {d: locked_executor(model, frames) for d in (1, 2, 3)}
    out, launches = {}, {}
    for depth, ex in executors.items():
        runner = PipelinedTickRunner(ex, depth=depth)
        got, ms = [], []
        torch.cuda.synchronize()
        launch_counts.reset()
        with spent("tick timed"):
            for f in frames[1:]:
                t0 = time.perf_counter()
                r = runner.submit(f)
                ms.append((time.perf_counter() - t0) * 1e3)
                if r is not None:
                    got.append(r)
            got.extend(runner.drain())
        counts = read_counters()
        add_counts(launches, counts)
        check(counts[K1["name"]] == PIPE_TICKS, f"tick runner depth {depth}:"
              f" K1 launched {counts[K1['name']]} times over {PIPE_TICKS} "
              "ticks")
        check(len(got) == PIPE_TICKS and all(
            r.tracked is not None and r.point_cloud is not None
            and len(r.point_cloud.positions) > 0 for r in got),
            f"tick runner depth {depth}: the target was lost")
        same = sum(g.tracked.index == w.tracked.index
                   and np.array_equal(g.point_cloud.positions,
                                      w.point_cloud.positions)
                   for g, w in zip(got, want))
        if depth == 1:
            check(same == PIPE_TICKS, f"tick runner depth 1: {same} of "
                                      f"{PIPE_TICKS} ticks equal the "
                                      "sequential executor")
        steady = ms[depth - 1:]
        out[depth] = {"p50_ms": statistics.median(steady),
                      "p95_ms": float(np.percentile(steady, 95))}
        print(f"stream: PipelinedTickRunner depth {depth}: locked over "
              f"{PIPE_TICKS} ticks, {same} of them equal to the sequential "
              f"executor (box and points); tick p50 "
              f"{out[depth]['p50_ms']:.3f} ms, p95 "
              f"{out[depth]['p95_ms']:.3f} ms over {len(steady)} submits on "
              f"{name}", flush=True)
    return out, launches


def phase_options(cfg, model, frames, b1) -> dict:
    """yuv420 input, bf16 weight storage, display-resolution masks and the
    NMS-free o2o head on the card. b1 is the float32-stored b=1
    pipeline."""
    name = torch.cuda.get_device_name(0)
    pipe = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=1,
                          input_format="yuv420", device=DEVICE).warmup()
    det = pipe(rgb_to_yuv420_numpy(frames[:1]))
    check_det(det, 1, True, "yuv420")
    print("options: yuv420 planes give 50/50 finite detections", flush=True)

    pipes = {"float32": b1,
             "bfloat16": build_pipeline(cfg, model, frame_hw=FRAME_HW,
                                        batch=1, params_dtype="bfloat16",
                                        device=DEVICE).warmup()}
    x = frames[:1]
    # launches and device time repeat frame for frame: a short trace will
    # do, and the profiler's cost grows with it
    with spent("options profile"):
        rows = {dt: profile_batch(frame_step(p, x), 1, 3)
                for dt, p in pipes.items()}
    ms = {dt: [] for dt in pipes}
    for _ in range(2):                       # in turns
        for dt, p in pipes.items():
            ms[dt] += host_ms(p, x, 15)
    out = {dt: {"launches": rows[dt]["launches"],
                "device_ms": rows[dt]["device_ms"],
                "p50_ms": statistics.median(ms[dt])} for dt in pipes}
    n_convs = sum(isinstance(m, (L.Conv, L.Proto)) for m in model.modules())
    check(out["float32"]["launches"] - out["bfloat16"]["launches"]
          >= n_convs, f"bf16 storage saved fewer launches than its "
                      f"{n_convs} weight casts: {out}")
    print(f"options: weight storage float32 / bfloat16: "
          f"{out['float32']['launches']:.0f} / "
          f"{out['bfloat16']['launches']:.0f} launches per frame ({n_convs} "
          f"weight casts), device {out['float32']['device_ms']:.3f} / "
          f"{out['bfloat16']['device_ms']:.3f} ms, b=1 p50 "
          f"{out['float32']['p50_ms']:.3f} / {out['bfloat16']['p50_ms']:.3f}"
          f" ms on {name}", flush=True)

    det = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=2,
                         mask_display_hw=FRAME_HW, device=DEVICE)(frames[:2])
    check(tuple(det["masks"].shape) == (2, MAX_DET) + FRAME_HW
          and bool(det["masks"].isfinite().all()),
          "mask_display_hw: bad masks")
    print(f"options: mask_display_hw {FRAME_HW} gives finite masks "
          f"{tuple(det['masks'].shape)}", flush=True)

    o2o_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        MODEL, o2o=True))
    o2o = detection_params(torch.Generator().manual_seed(0), o2o_cfg.model,
                           device=DEVICE)
    o2o.det_o2o.load_state_dict(o2o.det.state_dict())    # seeded from det
    pipe = build_pipeline(o2o_cfg, o2o, frame_hw=FRAME_HW, batch=1,
                          device=DEVICE).warmup()
    launch_counts.reset()
    det = pipe(frames[:1])
    torch.cuda.synchronize()
    check(sum(post_counts(read_counters()).values()) == 0,
          "the o2o path launched NMS")
    check_det(det, 1, True, "o2o")
    print("options: the o2o head gives 50/50 detections with no NMS launch",
          flush=True)
    return out


def phase_serve() -> dict:
    cfg = ExecutorConfig(model=MODEL)
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    frames = np.random.default_rng(4).integers(
        0, 256, (SERVE_FRAMES,) + FRAME_HW + (3,), np.uint8)
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    SPENT.clear()
    t0 = time.perf_counter()
    # the direct pipelines: the b=1 one is the server's reference, and
    # both carry the StreamingRunners
    with spent("pipelines"):
        pipes = {B: build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=B,
                                   device=DEVICE).warmup() for B in (1, 8)}
    serve_launches, servers = phase_server(cfg, model, frames, pipes[1])
    streams, stream_launches = phase_streaming(pipes, frames)
    ticks, tick_launches = phase_pipelined_ticks(model)
    add_counts(stream_launches, tick_launches)
    check(stream_launches[K1["name"]] > 0, "K1 never launched on the "
                                           "stream path")
    with spent("options"):
        options = phase_options(cfg, model, frames, pipes[1])
    SPENT["whole phase"] = time.perf_counter() - t0
    print("serve: seconds spent " + json.dumps(
        {k: round(v, 3) for k, v in SPENT.items()}), flush=True)
    return {"serve": serve_launches, "stream": stream_launches,
            "numbers": {"server": servers, "streaming": {
                f"b{b}_depth{d}": v for (b, d), v in streams.items()},
                "ticks": ticks, "weight_storage": options,
                "seconds": dict(SPENT)}}


# ---------------------------------------------------------------------------
# 7. the rest of the task family and test-time augmentation
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper in ops/nms.py's namespace during a
    path's run and keeps each launch's inputs and outputs under the name
    of the pipeline that made it. It calls the real wrapper, whose
    counter alone counts the launch."""

    def __init__(self, name: str):
        self.name, self.real = name, getattr(nms_ops, name)
        self.tag, self.calls = None, {}

    def __call__(self, geo, masked, iou, max_det, **kw):
        idx, ok = self.real(geo, masked, iou, max_det, **kw)
        self.calls.setdefault(self.tag, []).append(
            (geo, masked, iou, max_det, idx, ok))
        return idx, ok

    def __enter__(self) -> "Recorder":
        setattr(nms_ops, self.name, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(nms_ops, self.name, self.real)


def hold_launch(kernel, plain, call, label: str, what: str, bound_fn):
    """A launch recorded on a path, held bit for bit against the plain
    version on its own inputs, then run again and timed (run_case)."""
    geo, masked, iou, max_det, idx, ok = call
    check(iou == IOU and max_det == MAX_DET,
          f"{label}: thresholds {iou}, {max_det} differ from run_case's")
    ref_idx, ref_ok = plain(geo, masked, iou, max_det)
    check(torch.equal(idx, ref_idx) and torch.equal(ok, ref_ok),
          f"{label}: the path's launch differs from the plain version")
    return run_case(kernel, plain, (geo, masked), label, what, bound_fn,
                    iters=20, plain_once=masked.shape[-1] > K_OBB)


def check_task_det(det, B: int, task: str, what: str) -> None:
    """Pose: a full slate and finite keypoints; classify: finite [B, nc]
    probability rows that sum to one; segment and obb: check_det and
    check_obb_det."""
    if task == "classify":
        nc = CLS_MODEL.num_classes
        check(tuple(det["slate"].shape) == (B, nc)
              and bool(det["slate"].isfinite().all())
              and bool(((det["probs"].sum(-1) - 1).abs() < 1e-3).all()),
              f"{what}: bad probability rows")
        return
    if task == "segment":
        check_det(det, B, True, what)
        return
    if task == "obb":
        check_obb_det(det, B, what)
        return
    check(bool((det["count"] == MAX_DET).all())
          and det["slate"].shape == (B, MAX_DET * 7 + 1)
          and bool(det["slate"].isfinite().all()), f"{what}: bad slate")
    check(tuple(det["kpts"].shape) == (B, MAX_DET) + POSE_MODEL.kpt_shape
          and bool(det["kpts"].isfinite().all()), f"{what}: bad keypoints")


def task_reference(cfg, model, frames):
    """The pipeline's decode on the same raw outputs with the plain NMS
    (pose's postprocess takes its own backend argument; segment honours
    the config's)."""
    mcfg = cfg.model
    x = pre_ops.preprocess(torch.from_numpy(frames).to(DEVICE),
                           mcfg.input_size, dtype=model.dtype)
    with torch.inference_mode():
        out = model(x, concat_preds=False)
        if mcfg.task == "pose":
            ref = postprocess_pose_batch(out["boxes_xywh"], out["cls_logits"],
                                         out["kpts"], cfg.post,
                                         scores_are_logits=True,
                                         backend="scan")
            ref["slate"] = pack_slate(ref, MAX_DET)
            return ref
        scan = dataclasses.replace(cfg.post, nms_backend="scan")
        return decode_task_outputs(out, mcfg, scan)


def probs_match(results, ref, what: str, exact: bool) -> str:
    """Classify answers against the direct b=1 pipeline's: exact (the same
    batch size) within the 5-decimal rounding; otherwise (bf16 compute and
    TF32 products at another batch size) within CLS_PROB_TOL, and a label
    may differ only where the reference's top two lie within it."""
    worst, flips = 0.0, 0
    for i, status, body, _ in results:
        check(status == 200, f"{what}: status {status}: {body}")
        got, want = np.array(body["probs"]), np.array(ref[i]["probs"])
        err = float(np.abs(got - want).max())
        check(err <= (2e-5 if exact else CLS_PROB_TOL),
              f"{what}: frame {i}: probs differ by {err:.2e}")
        if body["label"] != ref[i]["label"]:
            check(not exact and want[body["label"]] >= want.max()
                  - CLS_PROB_TOL, f"{what}: frame {i}: label differs")
            flips += 1
        worst = max(worst, err)
    return f"worst prob difference {worst:.2e}; {flips} labels of a tie"


def serve_task(task: str, cfg, model, pipe, frames) -> tuple:
    """The server at micro-batch 1 and 8 for pose or classify under 16
    clients; answers against the direct b=1 pipeline's with the server's
    own formatting. Returns its K1 launches and numbers."""
    name = torch.cuda.get_device_name(0)
    bodies = [npy_bytes(f) for f in frames]
    srv = InferenceServer(cfg, params=model, frame_hw=FRAME_HW, port=0,
                          micro_batch=8, batch_window_ms=SERVE_WINDOW_MS,
                          max_pending=2 * SERVE_CLIENTS,
                          device=DEVICE).start()
    try:
        ref = []
        for f in frames:
            det = pipe(f[None])
            if task == "classify":
                host = {"probs": det["slate"][0].cpu().numpy()}
            else:
                host = unpack_slate(det["slate"][0].cpu(), MAX_DET)
                host["kpts"] = det["kpts"][0, :host["count"]].cpu().numpy()
            ref.append(srv._format(host, 0.0))
        warm_buckets(srv, bodies)
        numbers, hist = {}, {}
        launch_counts.reset()
        for mb in (1, 8):
            srv.micro_batch = mb
            srv._batch_hist.clear()
            results, wall = flood(srv.port, bodies, SERVE_CLIENTS,
                                  TASK_SERVE_PER_CLIENT)
            if task == "classify":
                found = probs_match(results, ref, f"{task} server mb={mb}",
                                    exact=(mb == 1))
            else:
                found = answers_match(results, ref, f"{task} server mb={mb}",
                                      exact=(mb == 1))
                if mb == 1:
                    kd = max(float(np.abs(np.array(
                        [d["kpts"] for d in body["detections"]])
                        - [d["kpts"] for d in ref[i]["detections"]]).max())
                        for i, _, body, _ in results)
                    check(kd <= SERVE_BOX_TOL, f"{task} server mb=1: "
                          f"keypoints differ by {kd:.3f}")
                    found += f"; worst keypoint difference {kd:.3f}"
            numbers[mb] = serve_numbers(results, wall)
            hist[mb] = {str(k): v for k, v in sorted(srv._batch_hist.items())}
            print(f"tasks: {task} server micro_batch {mb}: {len(results)} "
                  f"requests, {numbers[mb]['requests_per_s']:.1f} "
                  f"requests/s, p50 {numbers[mb]['p50_ms']:.3f} ms, p95 "
                  f"{numbers[mb]['p95_ms']:.3f} ms on {name}; batches "
                  f"{hist[mb]}; answers against the b=1 pipeline: {found}",
                  flush=True)
        launches = read_counters()
        check(any(int(n) > 1 for n in hist[8]),
              f"the {task} micro-batch server never batched: {hist[8]}")
        n_batches = sum(hist[1].values()) + sum(hist[8].values())
        want = n_batches if task == "pose" else 0
        check(launches[K1["name"]] == want, f"{task} server: K1 launched "
              f"{launches[K1['name']]} times over {n_batches} batches")
    finally:
        srv.close()
    return launches, numbers


def phase_tasks(smi: str) -> dict:
    """YOLO11n-pose, YOLO11n-cls and YOLOv8n-seg at full width, b=1 and
    b=8, and test-time augmentation on the segment, obb and pose models;
    then the server for pose and classify."""
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    frames = np.random.default_rng(5).integers(
        0, 256, (8,) + FRAME_HW + (3,), np.uint8)
    obb_frames = np.random.default_rng(6).integers(
        0, 256, (8,) + OBB_FRAME_HW + (3,), np.uint8)
    gen = torch.Generator
    models = {
        "pose": detection_params(gen().manual_seed(0), POSE_MODEL,
                                 device=DEVICE),
        "classify": yolo11.init_params(gen().manual_seed(0),
                                       CLS_MODEL).to(DEVICE),
        "v8seg": detection_params(gen().manual_seed(0), V8_MODEL,
                                  device=DEVICE),
        "seg": detection_params(gen().manual_seed(0), MODEL, device=DEVICE),
        "obb": detection_params(gen().manual_seed(0), OBB_MODEL,
                                device=DEVICE),
    }
    cfgs = {"pose": POSE_MODEL, "classify": CLS_MODEL, "v8seg": V8_MODEL,
            "seg": MODEL, "obb": OBB_MODEL}
    cfgs = {k: ExecutorConfig(model=m) for k, m in cfgs.items()}
    # (name, model, batch, build_pipeline's TTA arguments)
    specs = [(f"{m}_b{b}", m, b, {}) for m in ("pose", "classify", "v8seg")
             for b in (1, 8)] + [
        ("tta_seg_b1", "seg", 1, dict(tta=True)),
        ("tta_obb_b1", "obb", 1, dict(tta=True)),
        ("tta_obb_ultralytics_b1", "obb", 1,
         dict(tta=True, tta_views=ULTRALYTICS_TTA_VIEWS)),
        ("tta_obb_ultralytics_b8", "obb", 8,
         dict(tta=True, tta_views=ULTRALYTICS_TTA_VIEWS)),
        ("tta_pose_b1", "pose", 1,
         dict(tta=True, tta_kpt_flip_idx=COCO17_FLIP))]
    pipes = {n: build_pipeline(cfgs[m], models[m], batch=b, device=DEVICE,
                               frame_hw=OBB_FRAME_HW if m == "obb"
                               else FRAME_HW, **kw).warmup()
             for n, m, b, kw in specs}
    built_s = time.perf_counter() - t0

    def inputs(n, b, f=0):
        src = obb_frames if n.startswith("tta_obb") else frames
        return src[f:f + b] if b == 1 else src

    # --- the main path, with the launch counters zeroed around it; the
    # NMS launches' inputs are recorded to be held against the plain
    # versions afterwards
    launch_counts.reset()
    runs = {}
    with Recorder("nms_select_batched_cuda") as k1, \
            Recorder("nms_rotated_batched_cuda") as k3:
        for n, m, b, _ in specs:
            k1.tag = k3.tag = n
            for f in range(2):
                runs[n] = pipes[n](inputs(n, b, f))
        torch.cuda.synchronize()
    launches = read_counters()
    print(f"tasks: launches on the path {launches}", flush=True)
    k1_batches = sum(2 for n, m, _, _ in specs
                     if m in ("pose", "v8seg", "seg"))
    k3_batches = sum(2 for n, m, _, _ in specs if m == "obb")
    check(launches[K1["name"]] == k1_batches,
          f"K1 launched {launches[K1['name']]} times over {k1_batches} "
          "batches of the pose, YOLOv8 and TTA pipelines")
    check(launches[K3["name"]] == k3_batches,
          f"K3 launched {launches[K3['name']]} times over {k3_batches} "
          "obb TTA batches")
    check(launches[K2["name"]] == launches[K4["name"]] == 0,
          "K2 or K4 launched on the task paths")

    # --- every output checked: full slates, each pipeline's second run
    # equal to its decode with the plain NMS on the same raw outputs
    views = {}
    for n, m, b, kw in specs:
        task = cfgs[m].model.task
        check_task_det(runs[n], b, task, n)
        if kw:
            # the views' candidates meet in one NMS launch of width V*A
            A = cfgs[m].model.num_anchors
            V = len(kw.get("tta_views", DEFAULT_TTA_VIEWS))
            rec = (k3 if m == "obb" else k1).calls[n][-1]
            check(rec[1].shape[-1] == V * A,
                  f"{n}: NMS ran over {rec[1].shape[-1]} candidates, not "
                  f"{V} views x {A}")
            views[n] = torch.bincount(
                (runs[n]["indices"] // A).flatten().long(),
                minlength=V).tolist()
            continue                 # held launch by launch below
        if task == "classify":
            continue
        ref = task_reference(cfgs[m], models[m], inputs(n, b, 1))
        check(torch.equal(runs[n]["slate"], ref["slate"])
              and torch.equal(runs[n]["indices"], ref["indices"]),
              f"{n}: slate differs from the plain NMS on the same outputs")
        if task == "pose":
            check(torch.equal(runs[n]["kpts"], ref["kpts"]),
                  f"{n}: keypoints differ from the plain NMS's")
    p1 = runs["classify_b1"]["probs"][0]
    p8 = runs["classify_b8"]["probs"][1]      # frame 1 in both runs
    err = float((p1 - p8).abs().max())
    check(err <= CLS_PROB_TOL, f"classify: b=8 row differs from b=1 by {err}")
    print(f"tasks: every slate full and finite; pose and YOLOv8n-seg equal "
          f"to the plain NMS on the same raw outputs; classify b=8 against "
          f"b=1 within {err:.2e}; TTA survivors by view {views}", flush=True)

    # --- the NMS launches of the paths, each held bit for bit
    k1_cases, k3_cases = [], []
    for n in ("pose_b8", "tta_seg_b1", "tta_pose_b1"):
        call = k1.calls[n][-1]
        K = call[1].shape[-1]
        k1_cases.append(hold_launch(
            nk.nms_select_batched_cuda, nk.nms_select_batched_torch, call,
            f"K1 {n} B={call[1].shape[0]} K={K}", "nms_select",
            lambda ok, K=K: nms_bound(ok, K)))
    for n in ("tta_obb_b1", "tta_obb_ultralytics_b1",
              "tta_obb_ultralytics_b8"):
        call = k3.calls[n][-1]
        k3_cases.append(hold_launch(
            nk.nms_rotated_batched_cuda, nk.nms_rotated_batched_torch, call,
            f"K3 {n} B={call[1].shape[0]} K={call[1].shape[-1]}",
            "nms_rotated",
            lambda ok, rows=call[0], m=call[1]: rotated_bound(rows, m)))
    check(k3.calls["tta_obb_ultralytics_b1"][-1][1].shape[-1] == 3 * K_OBB,
          "ULTRALYTICS_TTA_VIEWS did not reach K3 at 3 x 21504")
    checked_s = time.perf_counter() - t0 - built_s

    # --- timing, host frames in, host slate out
    numbers = {}
    for n, m, b, kw in specs:
        ms = host_ms(pipes[n], inputs(n, b), 20 if b == 1 else 8)
        row = numbers.setdefault(n.rsplit("_b", 1)[0], {})
        if b == 1:
            row["b1_p50_ms"] = statistics.median(ms)
            row["b1_p95_ms"] = float(np.percentile(ms, 95))
        else:
            row["b8_frames_per_s"] = 8 * 1e3 / statistics.mean(ms)
    timed_s = time.perf_counter() - t0 - built_s - checked_s

    # --- the server: pose and classify at micro-batch 1 and 8
    serve_launches, serve = {}, {}
    for task in ("pose", "classify"):
        counts, serve[task] = serve_task(
            task, cfgs[task], models[task], pipes[f"{task}_b1"],
            frames[:SERVE_FRAMES // 2])
        add_counts(serve_launches, counts)
    seconds = {"build": built_s, "path and checks": checked_s,
               "timing": timed_s,
               "server": time.perf_counter() - t0 - built_s - checked_s
               - timed_s}
    seconds["whole phase"] = time.perf_counter() - t0
    print("tasks: " + json.dumps({
        "card": smi, "models": {k: {q: round(v, 3) for q, v in d.items()}
                                for k, d in numbers.items()},
        "server": {t: {str(mb): {q: round(v, 3) for q, v in d.items()}
                       for mb, d in v.items()} for t, v in serve.items()},
        "seconds": {k: round(v, 2) for k, v in seconds.items()}}),
        flush=True)
    return {"launches": launches, "serve": serve_launches,
            "k1_cases": k1_cases, "k3_cases": k3_cases}


# ---------------------------------------------------------------------------
# 8. accuracy modes and model I/O
# ---------------------------------------------------------------------------

class StreamRecorder:
    """Stands in for ops/wbf._topk_candidates during a path's run and keeps
    the shape of each candidate stream it hands a WBF scan (the kernel's
    chain is the stream's live prefix)."""

    def __init__(self):
        self.real, self.widths, self.streams = wbf._topk_candidates, [], []

    def __call__(self, *args):
        stream = self.real(*args)
        self.widths.append(("K6" if stream[0].shape[-1] == 5 else "K5",
                            tuple(stream[1].shape)))
        self.streams.append(stream)
        return stream

    def __enter__(self) -> "StreamRecorder":
        wbf._topk_candidates = self
        return self

    def __exit__(self, *exc) -> None:
        wbf._topk_candidates = self.real


def wbf_stream(rng, B: int, K: int, rotated: bool, mix: str = ""):
    """A score-sorted candidate stream on the card, as
    wbf._topk_candidates hands it to the scan: jittered clusters (K // 8
    centres, each with a label, one candidate in ten relabelled),
    bf16-quantised (tied) scores drawn from Beta(0.5, 4) (about one in
    six above the gate), and, for B > 1, a last image with nothing above
    the gate. `mix` relabels the stream by centre, with no relabelled
    candidates: "one" label, "skewed" (WBF_SKEW) or "uniform"; the boxes,
    scores and order stay those of the unrelabelled stream."""
    extent, n_labels = (1024.0, 15) if rotated else (640.0, 80)
    nc = K // 8
    pick = rng.integers(0, nc, (B, K))
    take = pick[..., None].repeat(2, -1)
    xy = np.take_along_axis(rng.uniform(0, extent, (B, nc, 2)), take, 1) \
        + rng.normal(0, 2, (B, K, 2))
    wh = np.take_along_axis(rng.uniform(8, 96, (B, nc, 2)), take, 1) \
        * rng.uniform(0.9, 1.1, (B, K, 2))
    boxes = np.concatenate([xy, wh], -1)
    if rotated:
        ang = np.take_along_axis(rng.uniform(-np.pi / 2, np.pi / 2, (B, nc)),
                                 pick, 1) + rng.normal(0, 0.05, (B, K))
        boxes = np.concatenate([boxes, ang[..., None]], -1)
    labels = np.take_along_axis(rng.integers(0, n_labels, (B, nc)), pick, 1)
    relabel = rng.random((B, K)) < 0.1
    labels[relabel] = rng.integers(0, n_labels, int(relabel.sum()))
    if mix:
        shares = {"one": [1.0], "uniform": [1.0 / n_labels] * n_labels,
                  "skewed": list(WBF_SKEW) + [(1 - sum(WBF_SKEW)) / (
                      n_labels - len(WBF_SKEW))] * (n_labels - len(WBF_SKEW))
                  }[mix]
        by_centre = np.random.default_rng(len(mix)).choice(
            len(shares), (B, nc), p=shares)
        labels = np.take_along_axis(by_centre, pick, 1)
    scores = torch.from_numpy(rng.beta(0.5, 4.0, (B, K)).astype(
        np.float32)).bfloat16().float()
    if B > 1:
        scores[-1] = scores[-1].clamp_max(WBF_GATE * 0.9)
    stream = wbf._topk_candidates(
        torch.from_numpy(boxes.astype(np.float32)), scores,
        torch.from_numpy(labels.astype(np.int32)), 0)
    return tuple(t.to(DEVICE) for t in stream)


def wbf_bound(stream, out, rotated: bool):
    """Least time for the work a scan does on these inputs: the live
    candidates' rows read once and the clusters written once; per live
    candidate the step's fixed work, and one overlap for every open cluster
    of its label (a cluster opens at its top member's place in the
    stream)."""
    boxes, scores, labels, order = (t.cpu().numpy() for t in stream)
    top_i, lab, active = (t.cpu().numpy() for t in out[-4:-1])
    B, K = scores.shape
    live = (scores > np.float32(WBF_GATE)).sum(-1)
    overlaps = 0
    for b in range(B):
        pos = np.empty(K, np.int64)
        pos[order[b]] = np.arange(K)
        L = labels[b, :live[b]]
        for d in np.nonzero(active[b])[0]:
            overlaps += int(np.count_nonzero(L[pos[top_i[b, d]] + 1:]
                                             == lab[b, d]))
    per_overlap, per_step = WBF_OPS[rotated]
    n_bytes = int(live.sum()) * (boxes.shape[-1] + 3) * 4 + sum(
        t.numel() * t.element_size() for t in out)
    return bound(n_bytes, overlaps * per_overlap + int(live.sum()) * per_step)


def wbf_case(rng, name: str, B: int, K: int, mix: str = "") -> dict:
    """K5 or K6 against its plain version on a seeded stream: every output
    EQUAL; timed beside the plain version (run once) and its bound."""
    rotated = name == "K6"
    kernel = wbf.wbf_rotated_scan_cuda if rotated else wbf.wbf_scan_cuda
    plain = wbf.wbf_rotated_scan_plain if rotated else wbf.wbf_scan_plain
    stream = wbf_stream(rng, B, K, rotated, mix)
    args = (*stream, IOU, WBF_GATE, MAX_DET)
    return hold_wbf(kernel, plain, args,
                    f"{name} B={B} K={K}" + (f" {mix}" if mix else ""),
                    rotated)


def wbf_chains(args, rotated: bool) -> dict:
    """The split schedule of one K5/K6 call on these inputs (a call outside
    the wrapper, not counted): the live steps and the longest chain (label
    mod G over the live prefix) of the worst image, and per image the chains
    pass B reran (a chain that opened after T_cap in pass A) and T_cap
    (None: the cap was not hit), read from the call's scratch."""
    boxes, scores, labels, order, thr, gate, D = args
    fn = "xrseg_wbf_rotated" if rotated else "xrseg_wbf"
    rep = {}
    wbf._launch(fn, boxes, scores, labels, order, thr, gate, D, True,
                report=rep)
    G, sc = rep["plan"].chains, rep["scratch"]
    B = scores.shape[0]

    def i32(off, n):
        return sc[off:off + 4 * n].view(torch.int32).cpu()

    tcap = i32(rep["offsets"][0], B)
    count = i32(rep["offsets"][1], B * G).view(B, G)
    pos = i32(rep["offsets"][2], B * G * D).view(B, G, D)
    last = pos.gather(2, (count - 1).clamp_min(0).long()[..., None])[..., 0]
    rerun = ((count > 0) & (last > tcap[:, None])).sum(1)
    s, lab = scores.cpu().numpy(), labels.cpu().numpy()
    live = [int(np.argmin(np.append(row > np.float32(gate), False)))
            for row in s]
    longest = max(int(np.bincount(np.mod(row[:n], G)).max()) if n else 0
                  for row, n in zip(lab, live))
    return dict(steps=max(live), longest_chain=longest,
                pass_b_chains=rerun.tolist(),
                t_cap=[None if int(t) == 2 ** 31 - 1 else int(t)
                       for t in tcap])


def hold_wbf(kernel, plain, args, label: str, rotated: bool,
             iters: int = 10) -> dict:
    got = kernel(*args)
    ref, plain_ms = event_ms(lambda: plain(*args))
    torch.cuda.synchronize()
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          f"{label}: kernel outputs differ from the plain version")
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    ms = cuda_ms(lambda: kernel(*args), iters)
    bound_ms, bound_by = wbf_bound(args[:4], got, rotated)
    ch = wbf_chains(args, rotated)
    case = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, **ch,
                us_per_step=1e3 * ms / max(ch["steps"], 1),
                us_per_chain_step=1e3 * ms / max(ch["longest_chain"], 1),
                n_open=got[-1].tolist())
    print(f"accuracy: {label}: equal, {ms:.4f} ms, {ch['steps']} live "
          f"steps, longest chain {ch['longest_chain']} "
          f"({case['us_per_chain_step']:.3f} us a step of it), pass B reran "
          f"{ch['pass_b_chains']} chains (T_cap {ch['t_cap']}); plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
          f"clusters per image {case['n_open']}", flush=True)
    return case


def pt_state_dict(model: yolo11.YOLO11, cfg: ModelConfig) -> dict:
    """The ultralytics fused-form state dict of `model` (conv.weight and
    conv.bias per Conv, as after ultralytics' model.fuse()): the inverse of
    io/torch_pt's name map."""
    sd, own = {}, model.state_dict()
    for path, ul, kind in torch_pt.ultralytics_slots(cfg):
        pre = ".".join(map(str, path))
        if kind == "conv":
            sd[f"{ul}.conv.weight"] = own[f"{pre}.weight"].cpu()
            sd[f"{ul}.conv.bias"] = own[f"{pre}.bias"].cpu()
        elif kind == "plain":
            sd[f"{ul}.weight"] = own[f"{pre}.weight"].cpu()
            sd[f"{ul}.bias"] = own[f"{pre}.bias"].cpu()
        elif kind == "convt":
            sd[f"{ul}.weight"] = own[f"{pre}.up_w"].cpu()
            sd[f"{ul}.bias"] = own[f"{pre}.up_b"].cpu()
        elif kind == "dfl":
            sd[f"{ul}.weight"] = torch.arange(
                cfg.reg_max, dtype=torch.float32).reshape(1, -1, 1, 1)
    return sd


def model_io(model, frames) -> dict:
    """A .pt (the script's own inversion) and an .onnx (export_onnx) of
    YOLO11n-seg each load back into a pipeline with the source slate;
    run_onnx on the card against the forward; export_compiled and
    load_compiled on the card. Returns the seconds each step took."""
    IO_DIR.mkdir(parents=True, exist_ok=True)
    cfg = ExecutorConfig(model=MODEL)
    src = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=1,
                         device=DEVICE).warmup()
    want = src(frames[:1])
    seconds = {}

    def same_slate(pipe_params, what):
        got = build_pipeline(cfg, pipe_params, frame_hw=FRAME_HW, batch=1,
                             device=DEVICE)(frames[:1])
        check(torch.equal(got["slate"], want["slate"])
              and torch.equal(got["masks"], want["masks"]),
              f"{what}: the slate differs from the source pipeline's")

    t = time.perf_counter()
    pt = IO_DIR / "yolo11n-seg.pt"
    torch.save(pt_state_dict(model, MODEL), pt)
    inferred = torch_pt.infer_pt_config(torch_pt.normalize_state_dict(
        torch.load(pt, weights_only=True)), MODEL)
    check(inferred == MODEL, f".pt: inferred {inferred}, not {MODEL}")
    loaded, _ = load_params_auto(str(pt), MODEL)
    same_slate(loaded, ".pt")
    seconds[".pt write and load"] = time.perf_counter() - t

    t = time.perf_counter()
    onnx = IO_DIR / "yolo11n-seg.onnx"
    export_onnx(model, MODEL, str(onnx))
    loaded, _ = load_params_auto(str(onnx), MODEL)
    same_slate(loaded, ".onnx")
    seconds[".onnx export and load"] = time.perf_counter() - t

    t = time.perf_counter()
    exact = yolo11.YOLO11(EXACT_MODEL)
    exact.load_state_dict(model.state_dict())
    exact = exact.to(DEVICE).eval()
    x = pre_ops.preprocess(torch.from_numpy(frames[:1]).to(DEVICE),
                           MODEL.input_size, dtype=torch.float32)
    with torch.inference_mode(), precision_scope("highest"):
        out = exact(x)
        ran = run_onnx(str(onnx), {"images": x.permute(0, 3, 1, 2)},
                       device=DEVICE)
    err = {k: float((a - b).abs().max()) for k, a, b in (
        ("output0", ran["output0"].permute(0, 2, 1), out["preds"]),
        ("output1", ran["output1"].permute(0, 2, 3, 1), out["protos"]))}
    check(max(err.values()) <= ONNX_TOL,
          f"run_onnx differs from the forward by {err} > {ONNX_TOL}")
    seconds["run_onnx"] = time.perf_counter() - t
    print(f"accuracy: run_onnx on the card against the float32 forward: max "
          f"|err| {err} (tolerance {ONNX_TOL}: boxes in pixels, float32 "
          "sums in another order)", flush=True)

    t = time.perf_counter()
    art = IO_DIR / "yolo11n-seg.xrseg"
    export_compiled(src, str(art))
    seconds["export_compiled"] = time.perf_counter() - t
    t = time.perf_counter()
    run = load_compiled(str(art))
    seconds["load_compiled"] = time.perf_counter() - t
    before = launch_counts.read()[K1["name"]]
    got = run(frames[:1])
    torch.cuda.synchronize()
    check(launch_counts.read()[K1["name"]] == before + 1,
          "the compiled artifact did not launch K1")
    check(torch.equal(got["slate"], want["slate"]),
          "load_compiled: the slate differs from the source pipeline's")
    print("accuracy: .pt, .onnx and the compiled artifact each give the "
          "source slate (the artifact through K1); seconds "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }", flush=True)
    return seconds


def native_depth(model) -> dict:
    """Classic executors with the torch and the native depth backend on
    the phase-5 scene: the same target on every tick, points as phase 5's
    classic check holds them."""
    frames = xr_frames(NATIVE_TICKS + 2, FRAME_HW, DEPTH_HW, seed=3)
    loops = {}
    for backend in ("torch", "native"):
        cfg = ExecutorConfig(model=MODEL, emit_masks="none")
        loops[backend] = XRLoop(Executor(cfg, params=model,
                                         frame_hw=FRAME_HW,
                                         depth_backend=backend,
                                         device=DEVICE))
        start_tracking(loops[backend], frames)
    worst, far, total = 0.0, 0, 0
    for i, frame in enumerate(frames[2:]):
        rt, _ = tick_until_result(loops["torch"], frame)
        rn, _ = tick_until_result(loops["native"], frame)
        check(rt.tracked is not None and rn.tracked is not None
              and rt.tracked.index == rn.tracked.index,
              f"native tick {i}: the backends track different boxes")
        pt, pn = rt.point_cloud.positions, rn.point_cloud.positions
        check(pt.shape == pn.shape and len(pt) > 0,
              f"native tick {i}: {len(pn)} native points, {len(pt)} torch")
        d = np.abs(pt - pn).max(-1)
        worst, far, total = max(worst, float(d.max())), \
            far + int((d > 1e-4).sum()), total + len(d)
    check(worst <= 2e-2 and far <= 0.01 * total,
          f"native points differ from torch: max {worst:.3e} m, {far} of "
          f"{total} beyond 1e-4 m")
    print(f"accuracy: depth_backend='native' tracks the torch backend's box "
          f"with its points over {NATIVE_TICKS} ticks (max |diff| "
          f"{worst:.2e} m, {far} of {total} points beyond 1e-4 m)",
          flush=True)
    return {"worst_m": worst, "beyond_1e-4": far, "points": total}


def phase_accuracy(smi: str) -> dict:
    """WBF (K5, K6) against the plain scan, merge="wbf" and the ensemble
    on the main paths at full width, model I/O and the native depth
    backend."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    cases = {"K5": [], "K6": []}
    for name, B, K in WBF_CASES:
        cases[name].append(wbf_case(rng, name, B, K))
    for name, B, K in WBF_MIX_CASES:
        for mix in WBF_MIXES:
            cases[name].append(wbf_case(np.random.default_rng(K + B), name,
                                        B, K, mix))
    seconds = {"kernels": time.perf_counter() - t0}

    gen = torch.Generator
    seg = detection_params(gen().manual_seed(0), MODEL, device=DEVICE)
    seg_s = detection_params(gen().manual_seed(1), S_MODEL, device=DEVICE)
    obb = detection_params(gen().manual_seed(0), OBB_MODEL, device=DEVICE)
    frames = np.random.default_rng(9).integers(
        0, 256, (8,) + FRAME_HW + (3,), np.uint8)
    obb_frames = np.random.default_rng(10).integers(
        0, 256, (1,) + OBB_FRAME_HW + (3,), np.uint8)

    def post(merge, backend="auto"):
        return PostprocessConfig(merge=merge, nms_backend=backend)

    def pipes(backend):
        wbf_cfg = ExecutorConfig(model=MODEL, post=post("wbf", backend))
        members = dict(params_list=[seg, seg_s], model_cfgs=[MODEL, S_MODEL],
                       frame_hw=FRAME_HW, batch=1, device=DEVICE)
        return {
            "seg_wbf_b1": build_pipeline(wbf_cfg, seg, frame_hw=FRAME_HW,
                                         batch=1, device=DEVICE),
            "seg_wbf_b8": build_pipeline(wbf_cfg, seg, frame_hw=FRAME_HW,
                                         batch=8, device=DEVICE),
            "obb_wbf_b1": build_pipeline(
                ExecutorConfig(model=OBB_MODEL, post=post("wbf", backend)),
                obb, frame_hw=OBB_FRAME_HW, batch=1, device=DEVICE),
            "ensemble_wbf_b1": build_ensemble_pipeline(wbf_cfg, **members),
            "ensemble_nms_b1": build_ensemble_pipeline(
                ExecutorConfig(model=MODEL, post=post("nms", backend)),
                **members)}

    kern = {n: p.warmup() for n, p in pipes("auto").items()}

    def inputs(n):
        if n.startswith("obb"):
            return obb_frames
        return frames if n.endswith("b8") else frames[:1]

    # --- the paths, with the launch counters zeroed around them
    launch_counts.reset()
    with StreamRecorder() as streams:
        runs = {n: p(inputs(n)) for n, p in kern.items()}
        torch.cuda.synchronize()
    launches = read_counters()
    print(f"accuracy: launches on the path {launches}; WBF streams "
          f"{streams.widths}", flush=True)
    check(launches[K5["name"]] == 3 and launches[K6["name"]] == 1
          and launches[K1["name"]] == 1 and launches[K2["name"]] == 0
          and launches[K3["name"]] == 0,
          "the WBF and ensemble paths: expected K5 x3 (segment b=1, b=8, "
          "the WBF ensemble), K6 x1 (obb), K1 x1 (the NMS ensemble)")
    A = MODEL.num_anchors
    check(streams.widths == [("K5", (1, A)), ("K5", (8, A)), ("K6", (1, K_OBB)),
                             ("K5", (1, 2 * A))],
          "the WBF scans did not run at the anchors of their paths")

    # --- every path's slate full, finite and equal to the plain merge on
    # the same frames (the same raw outputs: the forward is deterministic)
    for n, plain in pipes("scan").items():
        det = runs[n]
        B = det["count"].shape[0]
        if n.startswith("obb"):
            check_obb_det(det, B, n)
            # the obb decode leaves the merge to postprocess_obb_batch's own
            # "auto", as in JAX: the plain scan is asked for there
            x = pre_ops.preprocess(torch.from_numpy(inputs(n)).to(DEVICE),
                                   OBB_MODEL.input_size, dtype=obb.dtype)
            with torch.inference_mode():
                out = obb(x, concat_preds=False)
                ref = postprocess_obb_batch(
                    out["boxes_xywhr"], out["cls_logits"], post("wbf"),
                    scores_are_logits=True, backend="scan")
            ref["slate"] = pack_slate(ref, MAX_DET)
        else:
            check_det(det, B, True, n)
            ref = plain(inputs(n))
        for k in ("slate", "indices"):
            check(torch.equal(det[k], ref[k]),
                  f"{n}: {k} differs from the plain merge's")
        if "masks" in det:
            check(torch.equal(det["masks"], ref["masks"]),
                  f"{n}: masks differ from the plain merge's")
    members = torch.bincount((runs["ensemble_nms_b1"]["indices"][0]
                              // MODEL.num_anchors).long(), minlength=2)
    print(f"accuracy: every WBF and ensemble slate 50/50 and finite, equal "
          f"to the plain merge on the same frames; NMS ensemble survivors "
          f"by member {members.tolist()}", flush=True)
    # --- the kernels on the paths' own streams (every anchor live), timed
    on_paths = {"K5": [], "K6": []}
    for (name, shape), stream, n in zip(
            streams.widths, streams.streams,
            ("seg_wbf_b1", "seg_wbf_b8", "obb_wbf_b1", "ensemble_wbf_b1")):
        rotated = name == "K6"
        kernel = wbf.wbf_rotated_scan_cuda if rotated else wbf.wbf_scan_cuda
        args = (*stream, IOU, WBF_GATE, MAX_DET)
        ms = cuda_ms(lambda: kernel(*args), 5)
        bound_ms, bound_by = wbf_bound(stream, kernel(*args), rotated)
        ch = wbf_chains(args, rotated)
        on_paths[name].append(dict(
            case=f"{name} {n} B={shape[0]} K={shape[1]}", ms=ms,
            bound_ms=bound_ms, bound_by=bound_by, **ch,
            us_per_step=1e3 * ms / ch["steps"],
            us_per_chain_step=1e3 * ms / ch["longest_chain"]))
        print(f"accuracy: {name} on the {n} path's stream: {ms:.4f} ms, "
              f"{1e3 * ms / ch['steps']:.3f} us a step over {ch['steps']} "
              f"live candidates, longest chain {ch['longest_chain']}, pass B "
              f"reran {ch['pass_b_chains']} chains (equal to the plain scan "
              "through the slate check)", flush=True)
    seconds["paths and checks"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # --- timing, host frames in, host slate out
    numbers = {}
    for n, pipe in kern.items():
        if n.endswith("b8"):
            ms = host_ms(pipe, inputs(n), 8)
            numbers[n] = {"frames_per_s": 8e3 / statistics.mean(ms)}
        else:
            ms = host_ms(pipe, inputs(n), 20)
            numbers[n] = {"p50_ms": statistics.median(ms),
                          "p95_ms": float(np.percentile(ms, 95))}
    seconds["timing"] = time.perf_counter() - t0 - sum(seconds.values())

    io_s = model_io(seg, frames)
    seconds["model I/O"] = time.perf_counter() - t0 - sum(seconds.values())
    native = native_depth(seg)
    seconds["native depth"] = time.perf_counter() - t0 - sum(seconds.values())
    seconds["whole phase"] = time.perf_counter() - t0
    print("accuracy: " + json.dumps({
        "card": smi,
        "pipelines": {n: {k: round(v, 3) for k, v in d.items()}
                      for n, d in numbers.items()},
        "model_io_seconds": {k: round(v, 2) for k, v in io_s.items()},
        "native_depth": native,
        "seconds": {k: round(v, 2) for k, v in seconds.items()}}),
        flush=True)
    return {"launches": launches, "cases": cases, "on_paths": on_paths}


# ---------------------------------------------------------------------------
# 9. dataset evaluation and the host runtime surface
# ---------------------------------------------------------------------------

class CapturedPerImage:
    """Stands in for eval/dataset_eval.evaluate during a run and keeps the
    per-image (detections, ground truths) lists it is handed."""

    def __init__(self):
        self.real, self.calls = dataset_eval.evaluate, []

    def __call__(self, per_image, *args, **kwargs):
        self.calls.append(per_image)
        return self.real(per_image, *args, **kwargs)

    def __enter__(self) -> "CapturedPerImage":
        dataset_eval.evaluate = self
        return self

    def __exit__(self, *exc) -> None:
        dataset_eval.evaluate = self.real


class PlainTaskPipe:
    """The deployed pipeline's decode on the same raw outputs with the plain
    NMS loop (pose's and obb's postprocess take their own backend argument,
    as in the JAX package, so nms_backend="scan" does not reach them)."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __call__(self, frames):
        mcfg, post = self.pipe.cfg.model, self.pipe.cfg.post
        model = self.pipe.params
        x = pre_ops.preprocess(torch.from_numpy(frames).to(DEVICE),
                               mcfg.input_size, dtype=model.dtype)
        with torch.inference_mode():
            out = model(x, concat_preds=False)
            if mcfg.task == "pose":
                return postprocess_pose_batch(
                    out["boxes_xywh"], out["cls_logits"], out["kpts"], post,
                    scores_are_logits=True, backend="scan")
            return postprocess_obb_batch(out["boxes_xywhr"],
                                         out["cls_logits"], post,
                                         scores_are_logits=True,
                                         backend="scan")


def same_result(a: dict, b: dict) -> bool:
    """Result dicts equal (NaN where both are NaN)."""
    return set(a) == set(b) and all(
        a[k] == b[k] or (isinstance(a[k], float) and np.isnan(a[k])
                         and np.isnan(b[k])) for k in a)


def same_per_image(got, want, what: str) -> int:
    """Every image's detections and ground truths equal; each image has at
    least one detection. Returns the number of detections."""
    check(len(got) == len(want), f"{what}: {len(got)} images, {len(want)}")
    n = 0
    fields = ("box_xywh", "mask", "kpts", "box_xywhr")
    for i, ((dg, gg), (dw, gw)) in enumerate(zip(got, want)):
        check(len(dg) == len(dw) and len(dg) > 0,
              f"{what}: image {i}: {len(dg)} detections, {len(dw)} plain")
        n += len(dg)
        for a, b in zip(dg, dw):
            check(a.label == b.label and a.score == b.score and all(
                (getattr(a, f) is None) == (getattr(b, f) is None)
                and (getattr(a, f) is None
                     or np.array_equal(getattr(a, f), getattr(b, f)))
                for f in fields), f"{what}: image {i}: a detection differs "
                                  "from the plain NMS's")
        check(len(gg) == len(gw), f"{what}: image {i}: ground truths differ")
    return n


def eval_run(fn, what: str) -> tuple:
    """fn() with the launch counters zeroed around it and the per-image
    lists captured: (result, per_image, launches, K1 launches by batch)."""
    launch_counts.reset()
    with CapturedPerImage() as cap:
        out = fn()
    torch.cuda.synchronize()
    launches = read_counters()
    by_batch = k1_by_batch()
    check(len(cap.calls) >= 1, f"{what}: no per-image lists were scored")
    return out, cap.calls[0], launches, by_batch


def write_y4m(path: Path, frames) -> None:
    """uint8 RGB frames -> a 4:2:0 Y4M clip (the planes of
    ops/yuv.rgb_to_yuv420_numpy)."""
    h, w = frames[0].shape[:2]
    y, u, v = rgb_to_yuv420_numpy(np.stack(frames))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for i in range(len(frames)):
            f.write(b"FRAME\n" + y[i].tobytes() + u[i].tobytes()
                    + v[i].tobytes())


def video_to_tracker(model, frames) -> dict:
    """A Y4M clip of the phase-5 frames through VideoFrameSource into an
    Executor(multi_tracking=True) on the card: each frame's boxes equal the
    direct b=1 pipeline's on the decoded frame; track ids persist."""
    clip = EVAL_DIR / "phase5.y4m"
    write_y4m(clip, frames)
    cfg = ExecutorConfig(model=MODEL, multi_tracking=True)
    src = VideoFrameSource(str(clip))
    check(src.open(), "VideoFrameSource did not open the clip")
    ex = Executor(cfg, params=model, frame_hw=FRAME_HW, device=DEVICE)
    ids, n = [], 0
    for fd in src.frames():
        r = ex.run_sync(fd)
        direct = unpack_slate(ex.pipeline(fd.rgb[None])["slate"][0], MAX_DET)
        want = parse_boxes(direct["boxes_xywh"], direct["labels"],
                           direct["scores"], direct["count"], ex.screen_wh,
                           ex.labels, max_boxes=MAX_DET,
                           model_size=tuple(map(float, MODEL.input_size)))
        check(r.count == MAX_DET and r.boxes == want,
              f"video frame {n}: the executor's boxes differ from the "
              "direct b=1 pipeline's on the decoded frame")
        ids.append({t.track_id for t in (r.tracks or [])})
        n += 1
    src.close()
    confirmed = [s for s in ids if s]
    check(n == len(frames) and bool(confirmed)
          and bool(confirmed[0] & confirmed[-1]),
          f"video: {n} frames, track ids {ids} did not persist")
    return {"frames": n, "tracks_confirmed_from_frame": ids.index(
        confirmed[0]), "persisting_ids": len(confirmed[0] & confirmed[-1])}


def trace_kernels(logdir: Path) -> list:
    """Kernel names in the Chrome traces under logdir."""
    names = set()
    for path in logdir.glob("*.json"):
        for e in json.loads(path.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                names.add(e.get("name", ""))
    return sorted(names)


def phase_eval(smi: str) -> dict:
    """Dataset evaluation through the card's pipeline (segment, pose, obb),
    the parity report, video into the Executor, the deploy check, the
    profiler and the eval CLI."""
    t0 = time.perf_counter()
    EVAL_DIR.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator
    seg = detection_params(gen().manual_seed(0), MODEL, device=DEVICE)
    pose = detection_params(gen().manual_seed(0), POSE_EVAL_MODEL,
                            device=DEVICE)
    obb = detection_params(gen().manual_seed(0), OBB_MODEL, device=DEVICE)
    seconds = {"weights": time.perf_counter() - t0}

    def post(backend="auto"):
        return PostprocessConfig(score_threshold=0.05, iou_threshold=0.6,
                                 max_detections=MAX_DET, nms_backend=backend)

    numbers, launches = {}, {}
    # --- segment: K1 once per batch of 8, equal to nms_backend="scan"
    ds = data_lib.SyntheticShapesDataset(n=EVAL_N, hw=FRAME_HW, n_classes=3)
    dump = EVAL_DIR / "coco_results.json"
    seg_out, seg_pi, seg_l, seg_b = eval_run(lambda: evaluate_dataset(
        MODEL, seg, ds, batch=8, coco_dump=str(dump), device=DEVICE),
        "segment eval")
    batches = -(-EVAL_N // 8)
    check(seg_l[K1["name"]] == batches and seg_b == {8: batches}
          and sum(post_counts(seg_l).values()) == batches,
          f"segment eval: launches {seg_l}, K1 by batch {seg_b}; expected "
          f"K1 x{batches} at B=8 and nothing else")
    scan_pipe = build_pipeline(ExecutorConfig(model=MODEL, post=post("scan")),
                               seg, crop_masks=True,
                               frame_hw=MODEL.input_size, batch=8,
                               device=DEVICE)
    scan_out, scan_pi, _, _ = eval_run(lambda: evaluate_dataset(
        MODEL, seg, ds, batch=8, pipe=scan_pipe, device=DEVICE),
        "segment eval (scan)")
    n_det = same_per_image(seg_pi, scan_pi, "segment eval")
    check(same_result({k: v for k, v in seg_out.items() if k != "dumped"},
                      scan_out), f"segment eval: {seg_out} != {scan_out}")
    rows = json.loads(dump.read_text())
    check(len(rows) == n_det == seg_out["dumped"]
          and all(len(r["bbox"]) == 4 and "segmentation" in r for r in rows),
          f"COCO dump: {len(rows)} rows for {n_det} detections")
    numbers["segment"] = seg_out
    launches["segment"] = seg_l
    seconds["segment eval x2"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # --- pose (K1) and obb (K3): once per batch of 4, equal to the plain
    for name, model, data in (
            ("pose", pose, data_lib.SyntheticPoseDataset(n=8, hw=FRAME_HW)),
            ("obb", obb, data_lib.SyntheticOBBDataset(n=8,
                                                      hw=OBB_FRAME_HW))):
        out, pi, lc, by_b = eval_run(lambda: evaluate_task_dataset(
            model.cfg, model, data, batch=4, device=DEVICE), f"{name} eval")
        kern = K3 if name == "obb" else K1
        check(lc[kern["name"]] == 2 and sum(post_counts(lc).values()) == 2
              and (name == "obb" or by_b == {4: 2}),
              f"{name} eval: launches {lc}, K1 by batch {by_b}; expected "
              f"{kern['name']} x2 at B=4 and nothing else")
        plain = PlainTaskPipe(build_pipeline(
            ExecutorConfig(model=model.cfg, post=post()), model,
            frame_hw=model.cfg.input_size, batch=4, device=DEVICE))
        ref, ref_pi, _, _ = eval_run(lambda: evaluate_task_dataset(
            model.cfg, model, data, batch=4, pipe=plain, device=DEVICE),
            f"{name} eval (scan)")
        same_per_image(pi, ref_pi, f"{name} eval")
        check(same_result(out, ref), f"{name} eval: {out} != {ref}")
        numbers[name] = out
        launches[name] = lc
    seconds["pose, obb eval x2"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # --- parity report: the card pipeline (bf16, and float32 without
    # TF32) against the CPU oracle, a reading
    base = xr_frames(1, FRAME_HW, DEPTH_HW, seed=5)[0].rgb
    images = augment_images([base], n_variants=3)
    exact = yolo11.YOLO11(EXACT_MODEL)
    exact.load_state_dict(seg.state_dict())
    pcfg = PostprocessConfig()
    numbers["parity"] = {
        "bf16": parity_report(images, seg, MODEL, pcfg, device=DEVICE),
        "float32_highest": parity_report(images, exact.to(DEVICE).eval(),
                                         EXACT_MODEL, pcfg, device=DEVICE)}
    for v in numbers["parity"].values():
        check(v["n_detections_ours"] > 0 and v["n_images"] == len(images),
              f"parity report: {v}")
    seconds["parity"] = time.perf_counter() - t0 - sum(seconds.values())

    # --- video into the Executor
    numbers["video"] = video_to_tracker(
        seg, [f.rgb for f in xr_frames(8, FRAME_HW, DEPTH_HW)])
    seconds["video"] = time.perf_counter() - t0 - sum(seconds.values())

    # --- deploy check and profiler
    env = check_environment(ExecutorConfig(model=MODEL), require_cuda=True,
                            device=DEVICE)
    for name, ok, detail in env.checks:
        print(f"eval: deploy check {name}: {'ok' if ok else 'FAILED'} "
              f"({detail})", flush=True)
    check(env.ok, "check_environment(require_cuda=True) failed")
    b1 = build_pipeline(ExecutorConfig(model=MODEL), seg, frame_hw=FRAME_HW,
                        batch=1, device=DEVICE)
    trace_dir = EVAL_DIR / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    profile_fn(lambda: b1(base[None]), str(trace_dir), steps=3)
    names = trace_kernels(trace_dir)
    k1_names = [n for n in names if K1_GLOBAL in n]
    check(bool(k1_names), f"profiler trace names no {K1_GLOBAL} kernel "
                          f"({len(names)} kernel names)")
    numbers["deploy_checks"] = len(env.checks)
    numbers["trace"] = {"kernel_names": len(names), "k1": k1_names}
    seconds["deploy check, profiler"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # --- the CLI, as a user runs it
    cli = subprocess.run(
        [sys.executable, "-m", "xrseg_tpu_torch.eval", "--data", "synthetic",
         "--max-images", "16"], capture_output=True, text=True,
        timeout=600, cwd=Path(__file__).resolve().parent)
    check(cli.returncode == 0, f"eval CLI exit {cli.returncode}: "
                               f"{cli.stderr[-2000:]}")
    cli_out = json.loads(cli.stdout.strip().splitlines()[-1])
    check(cli_out.get("n_images") == 16, f"eval CLI printed {cli_out}")
    numbers["cli"] = cli_out
    seconds["cli"] = time.perf_counter() - t0 - sum(seconds.values())
    seconds["whole phase"] = time.perf_counter() - t0
    print("eval: " + json.dumps({"card": smi, **numbers,
                                 "launches": launches,
                                 "seconds": {k: round(v, 2)
                                             for k, v in seconds.items()}}),
          flush=True)
    return {"launches": launches}


def wbf_kernels(acc: dict) -> list:
    """K5's and K6's entries of the kernel line from phase 8's result: the
    seeded cases held against the plain scan, their launches on phase 8's
    paths, and their times on those paths' own streams."""
    return [dict(k, main=acc["cases"][name][0], cases=acc["cases"][name],
                 on_paths=acc["on_paths"][name],
                 launches=acc["launches"][k["name"]],
                 launches_by_path={"accuracy": acc["launches"][k["name"]]})
            for k, name in ((K5, "K5"), (K6, "K6"))]


# ---------------------------------------------------------------------------
# 10. training
# ---------------------------------------------------------------------------

class StepRecorder:
    """Stands in for train_step.make_train_step during a run and keeps each
    step's metrics as host floats."""

    def __init__(self):
        self.real, self.rows = train_ts.make_train_step, []

    def __call__(self, *args, **kwargs):
        step, rows = self.real(*args, **kwargs), self.rows

        def recorded(state, batch):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
            return state, m

        recorded.compute_grads = step.compute_grads
        recorded.shard_step = getattr(step, "shard_step", step)
        return recorded

    def __enter__(self) -> "StepRecorder":
        train_ts.make_train_step = self
        return self

    def __exit__(self, *exc) -> None:
        train_ts.make_train_step = self.real


def counted_evaluate(trainer: Trainer) -> list:
    """Wrap trainer.evaluate so each call runs with the launch counters
    zeroed just before it and read just after; returns the list of
    (counts, K1 launches by batch) it fills."""
    real, counts = trainer.evaluate, []

    def evaluate(*args, **kwargs):
        launch_counts.reset()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        counts.append((read_counters(),
                       k1_by_batch()))
        return out

    trainer.evaluate = evaluate
    return counts


def finite_steps(rows, n: int, what: str) -> None:
    check(len(rows) == n and all(np.isfinite(r["loss"])
                                 and np.isfinite(r["grad_norm"])
                                 for r in rows),
          f"{what}: {len(rows)} steps (expected {n}), loss/grad_norm "
          f"{[(r['loss'], r['grad_norm']) for r in rows]}")


def exact_step_card_vs_cpu(ds) -> dict:
    """One float32 "highest" train step at b=2 (YOLO11n-seg at full width,
    TRAIN_EXACT_HW input) on the card and on the CPU from the same weights
    and batch: metrics within rtol 1e-4, the clipped gradient (the first
    moment / 0.1) within 1e-3 of each leaf's max abs, params and moments
    within rtol 1e-4, atol 1e-5: the CPU tests' tolerances x10 (cuDNN sums
    in another order)."""
    cfg = dataclasses.replace(MODEL, dtype="float32",
                              matmul_precision="highest",
                              input_size=TRAIN_EXACT_HW)
    host = yolo11.init_params(torch.Generator().manual_seed(3), cfg)
    batch = next(data_lib.Loader(ds, cfg, 2, max_gt=16, device="cpu")
                 ._host_batches(0))
    opt = train_ts.make_optimizer(lr=1e-6, warmup_steps=0, total_steps=10)
    runs = []
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(host).to(dev)
        state = train_ts.TrainState(model, opt.init(model), 0)
        step = train_ts.make_train_step(cfg, opt, use_remat=False, device=dev)
        state, m = step(state, batch)
        runs.append(({k: float(v) for k, v in m.items()}, state))
    (mc, sc), (mh, sh) = runs
    for k in mh:
        check(abs(mc[k] - mh[k]) <= 1e-4 * abs(mh[k]) + 1e-7,
              f"exact step: {k} {mc[k]} on the card, {mh[k]} on the CPU")
    worst_g = 0.0
    for name, mu in sh.opt_state["mu"].items():
        g_h, g_c = mu.numpy() / 0.1, sc.opt_state["mu"][name].cpu().numpy() / 0.1
        err = float(np.abs(g_c - g_h).max()) / max(float(np.abs(g_h).max()),
                                                    1e-30)
        worst_g = max(worst_g, err)
        check(err <= 1e-3, f"exact step: gradient of {name} off by {err:.2e}"
                           " of its max")
    pairs = [(n, p.detach(), dict(sh.params.named_parameters())[n].detach())
             for n, p in sc.params.named_parameters()]
    pairs += [(f"{k} {n}", t, sh.opt_state[k][n]) for k in ("mu", "nu")
              for n, t in sc.opt_state[k].items()]
    for name, c, h in pairs:
        check(torch.allclose(c.cpu(), h, rtol=1e-4, atol=1e-5),
              f"exact step: {name} differs from the CPU's beyond rtol 1e-4,"
              " atol 1e-5")
    return {"input": list(TRAIN_EXACT_HW), "loss": mc["loss"],
            "loss_cpu": mh["loss"], "grad_norm": mc["grad_norm"],
            "grad_norm_cpu": mh["grad_norm"],
            "worst_grad_err_of_leaf_max": worst_g}


def timed_steps(state, optimizer, batch) -> dict:
    """ms per bf16 remat step at the trainer's batch, images/s, the peak
    memory of those steps, and a profile of them (device ms, idle share,
    launches). Each step ends in the one host copy of its metrics the
    trainer makes."""
    step = train_ts.make_train_step(MODEL, optimizer, device=DEVICE)

    def one():
        _, m = step(state, batch)
        torch.stack(list(m.values())).tolist()

    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_batch(one, TRAIN_BATCH, TRAIN_TIMED_STEPS, top=6)
    peak = torch.cuda.max_memory_allocated()
    return {"ms": prof["wall_ms"],
            "images_per_s": TRAIN_BATCH * 1e3 / prof["wall_ms"],
            "device_ms": prof["device_ms"],
            "device_idle_share": prof["device_idle_share"],
            "launches": prof["launches"], "top": prof["top"],
            "peak_bytes": peak}


def phase_train(smi: str) -> dict:
    """Trainer.fit on YOLO11n-seg at full width (bf16, remat, EMA, mosaic)
    with validation through K1, resume, timed steps, the float32 step
    against the CPU, and two steps of each other task (obb validation
    through K3)."""
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    seconds, numbers = {}, {}
    seg = detection_params(torch.Generator().manual_seed(0), MODEL,
                           device=DEVICE)
    ds = data_lib.SyntheticShapesDataset(n=TRAIN_N, hw=FRAME_HW, n_classes=3)
    val_ds = data_lib.SyntheticShapesDataset(n=TRAIN_VAL_N, hw=FRAME_HW,
                                             n_classes=3, seed=1)
    per_epoch = TRAIN_N // TRAIN_BATCH
    tcfg = TrainConfig(epochs=2, batch=TRAIN_BATCH, max_gt=16, lr=1e-3,
                       warmup_steps=2, log_every=per_epoch,
                       ckpt_dir=str(TRAIN_DIR), val_max_images=TRAIN_VAL_N)
    tr = Trainer(MODEL, tcfg, params=seg, device=DEVICE)
    val_counts = counted_evaluate(tr)
    torch.cuda.reset_peak_memory_stats()
    with StepRecorder() as rec:
        hist = tr.fit(ds, val_dataset=val_ds)
    torch.cuda.synchronize()
    fit_peak = torch.cuda.max_memory_allocated()
    finite_steps(rec.rows, 2 * per_epoch, "fit")
    check(tr.preflight_bytes is not None, "the memory preflight did not run")
    check(len(val_counts) == 2 and all(
        c[K1["name"]] == 1 and sum(post_counts(c).values()) == 1
        and by_b == {TRAIN_BATCH: 1} for c, by_b in val_counts),
        f"fit validation launches {val_counts}; expected K1 once a "
        f"validation at B={TRAIN_BATCH} and nothing else")
    numbers["fit"] = {"history": hist, "steps": rec.rows}
    seconds["fit 2 epochs + validation"] = time.perf_counter() - t0

    # the validation equals the same eval through the plain NMS
    del tr.evaluate                     # the instance's wrapper
    post = PostprocessConfig(score_threshold=tcfg.val_score_threshold,
                             max_detections=tcfg.val_max_detections,
                             nms_backend="scan")
    scan_pipe = build_pipeline(ExecutorConfig(model=MODEL, post=post),
                               tr._val_model, crop_masks=True,
                               frame_hw=MODEL.input_size, batch=TRAIN_BATCH,
                               device=DEVICE)
    got, got_pi, _, _ = eval_run(lambda: tr.evaluate(
        val_ds, max_images=TRAIN_VAL_N), "train validation")
    want, want_pi, _, _ = eval_run(lambda: evaluate_dataset(
        MODEL, tr._val_model, val_ds,
        score_threshold=tcfg.val_score_threshold,
        max_detections=tcfg.val_max_detections, max_images=TRAIN_VAL_N,
        batch=TRAIN_BATCH, pipe=scan_pipe, device=DEVICE),
        "train validation (scan)")
    n_det = same_per_image(got_pi, want_pi, "train validation")
    check(got == {"val_box_mAP": want["box_mAP"],
                  "val_box_AP50": want["box_AP50"],
                  "val_mask_mAP": want["mask_mAP"]},
          f"train validation {got} != scan {want}")
    numbers["validation"] = {"result": got, "detections": n_det}
    seconds["validation against scan"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # resume from state.pt: the step count and the LR horizon continue
    tr2 = Trainer(MODEL, tcfg, device=DEVICE)
    with StepRecorder() as rec2:
        tr2.fit(ds, resume=True, epochs=1)
    finite_steps(rec2.rows, per_epoch, "resumed fit")
    done = 3 * per_epoch
    check(tr2.state.step == done and tr2.state.opt_state["count"] == done
          and tr2.optimizer.total_steps == done and len(tr2.history) == 3,
          f"resume: step {tr2.state.step}, count "
          f"{tr2.state.opt_state['count']}, horizon "
          f"{tr2.optimizer.total_steps}, {len(tr2.history)} epochs; "
          f"expected {done}, {done}, {done}, 3")
    numbers["resume"] = {"step": tr2.state.step,
                         "lr_at_resume": tr2.optimizer.schedule(
                             2 * per_epoch),
                         "lr_fresh_horizon": train_ts.make_optimizer(
                             tcfg.lr, tcfg.weight_decay, tcfg.warmup_steps,
                             2 * per_epoch).schedule(2 * per_epoch)}
    seconds["resume 1 epoch"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # the Loader's host work alone (fit's augmentation: mosaic, affine,
    # HSV, collate), step time, images/s, the preflight against the peak
    loader = data_lib.Loader(ds, MODEL, TRAIN_BATCH, max_gt=16,
                             device=DEVICE)
    t_host = time.perf_counter()
    host_batches = list(loader._host_batches(0))
    host_ms = (time.perf_counter() - t_host) * 1e3 / len(host_batches)
    batch = next(iter(loader.epoch(0)))
    step = timed_steps(tr2.state, tr2.optimizer, batch)
    numbers["step"] = {k: v for k, v in step.items() if k != "peak_bytes"}
    numbers["loader_host_ms_per_batch"] = host_ms
    numbers["fit_s_per_step"] = [h["sec"] / per_epoch for h in hist]
    numbers["memory"] = {"preflight_estimate_gb": tr.preflight_bytes / 1e9,
                         "timed_steps_peak_gb": step["peak_bytes"] / 1e9,
                         "fit_peak_gb": fit_peak / 1e9}
    seconds["timed steps"] = time.perf_counter() - t0 - sum(seconds.values())

    numbers["exact_step"] = exact_step_card_vs_cpu(ds)
    seconds["float32 step, card and CPU"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # the other tasks at full width: two steps each; obb validates (K3)
    launches = {"train validation": sum(c[K1["name"]] for c, _ in
                                        val_counts)}
    numbers["tasks"] = {}
    for name, cfg, data, val in (
            ("obb", OBB_MODEL,
             data_lib.SyntheticOBBDataset(n=8, hw=OBB_FRAME_HW),
             data_lib.SyntheticOBBDataset(n=4, hw=OBB_FRAME_HW, seed=1)),
            ("pose", POSE_EVAL_MODEL,
             data_lib.SyntheticPoseDataset(n=8, hw=FRAME_HW), None),
            ("classify", CLS_MODEL,
             data_lib.SyntheticClassifyDataset(n=8, hw=FRAME_HW), None)):
        weights = (detection_params(torch.Generator().manual_seed(0), cfg,
                                    device=DEVICE) if val is not None
                   else None)
        tt = Trainer(cfg, TrainConfig(epochs=1, batch=4, max_gt=8,
                                      warmup_steps=1, log_every=0,
                                      val_max_images=4),
                     params=weights, device=DEVICE)
        counts = counted_evaluate(tt)
        with StepRecorder() as r:
            h = tt.fit(data, val_dataset=val, verbose=False)
        finite_steps(r.rows, 2, f"{name} fit")
        if val is not None:
            check(len(counts) == 1 and counts[0][0][K3["name"]] == 1
                  and sum(post_counts(counts[0][0]).values()) == 1,
                  f"obb validation launches {counts}; expected K3 once")
            launches["train obb validation"] = counts[0][0][K3["name"]]
        numbers["tasks"][name] = {"losses": [x["loss"] for x in r.rows],
                                  **{k: v for k, v in h[-1].items()
                                     if k.startswith("val_")}}
    seconds["obb, pose, classify"] = time.perf_counter() - t0 - sum(
        seconds.values())
    seconds["whole phase"] = time.perf_counter() - t0
    step_line = numbers["step"]
    print(f"train: card {smi}: bf16 remat step at b={TRAIN_BATCH}, "
          f"{MODEL.input_size[0]}x{MODEL.input_size[1]}: "
          f"{step_line['ms']:.2f} ms ({step_line['images_per_s']:.1f} "
          f"images/s), device {step_line['device_ms']:.2f} ms, idle "
          f"{step_line['device_idle_share']:.1%}, "
          f"{step_line['launches']:.0f} launches; the Loader's host work "
          f"{host_ms:.1f} ms a batch, fit {numbers['fit_s_per_step']} s a "
          "step", flush=True)
    mem = numbers["memory"]
    print(f"train: preflight estimate {mem['preflight_estimate_gb']:.3f} GB "
          f"against a measured peak of {mem['timed_steps_peak_gb']:.3f} GB "
          f"over the timed steps ({mem['fit_peak_gb']:.3f} GB over the fit)",
          flush=True)
    print("train: " + json.dumps({"card": smi, **numbers,
                                  "launches": launches,
                                  "seconds": {k: round(v, 2) for k, v in
                                              seconds.items()}}),
          flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 11. fine-tuning and label efficiency
# ---------------------------------------------------------------------------

def same_leaves_as_donor(model, donor_flat: dict, report: dict,
                         what: str) -> int:
    """Every leaf the transfer reports copied equals the donor's bit for
    bit; returns how many were compared."""
    flat = flatten_params(params_to_tree(model))
    reinit = set(report["reinit"])
    copied = [k for k in flat if k not in reinit]
    check(len(copied) == report["copied"],
          f"{what}: {len(copied)} leaves not reinitialised, report says "
          f"{report['copied']} copied")
    for k in copied:
        check(k in donor_flat and np.array_equal(flat[k], donor_flat[k]),
              f"{what}: copied leaf {k} differs from the donor's")
    return len(copied)


def transfer_phase(donor, ds, val_ds) -> dict:
    """transfer_params of the card donor to a 3-class segmenter and to a
    1-class pose model, each report equal to a CPU run's, every copied
    leaf bit-equal to the donor's, the class convs at the prior bias; then
    one epoch of Trainer.fit from the 3-class model (K1 once in its
    validation)."""
    donor_cpu = copy.deepcopy(donor).cpu()
    donor_flat = flatten_params(params_to_tree(donor_cpu))
    out = {}
    models = {}
    for name, cfg in (("segment", LE_SEG_MODEL), ("pose", LE_POSE_MODEL)):
        model, rep = transfer_params(donor, cfg,
                                     torch.Generator().manual_seed(1))
        _, rep_cpu = transfer_params(donor_cpu, cfg,
                                     torch.Generator().manual_seed(1))
        check(rep == rep_cpu, f"transfer {name}: the card donor's report "
                              f"{rep} != the CPU donor's {rep_cpu}")
        n = same_leaves_as_donor(model, donor_flat, rep, f"transfer {name}")
        out[name] = {"copied": rep["copied"], "compared": n,
                     "reinit": len(rep["reinit"]),
                     "dropped": len(rep["dropped"])}
        models[name] = model
    seg = models["segment"]
    nc = LE_SEG_MODEL.num_classes
    for i, stride in enumerate((8, 16, 32)):
        prior = np.float32(np.log(5 / nc / (640 / stride) ** 2))
        b = seg.det.cv3[i].out.bias.detach().numpy()
        check(bool((b == prior).all()), f"transfer: class conv {i} bias "
                                        f"{b} is not the prior {prior}")
    check(out["segment"]["reinit"] == 6 and out["pose"]["dropped"] > 0,
          f"transfer reports {out}")

    tcfg = TrainConfig(epochs=1, batch=TRAIN_BATCH, max_gt=16, lr=1e-3,
                       warmup_steps=2, log_every=0,
                       val_max_images=TRAIN_VAL_N)
    tr = Trainer(LE_SEG_MODEL, tcfg, params=seg, device=DEVICE)
    counts = counted_evaluate(tr)
    with StepRecorder() as rec:
        hist = tr.fit(ds, val_dataset=val_ds, verbose=False)
    finite_steps(rec.rows, len(ds) // TRAIN_BATCH, "fit from the transfer")
    check(len(counts) == 1 and counts[0][0][K1["name"]] == 1
          and sum(post_counts(counts[0][0]).values()) == 1
          and counts[0][1] == {TRAIN_BATCH: 1},
          f"fit from the transfer: validation launches {counts}; expected "
          f"K1 once at B={TRAIN_BATCH}")
    out["fit"] = {"losses": [r["loss"] for r in rec.rows],
                  **{k: v for k, v in hist[-1].items()
                     if k.startswith("val_") or k == "sec"}}
    return {"numbers": out, "launches": counts[0][0][K1["name"]]}


def exact_distill_card_vs_cpu() -> dict:
    """One float32 "highest" distill step at b=2 (TRAIN_EXACT_HW input,
    remat on) of YOLO11n-seg under YOLO11s-seg on the card and on the CPU:
    metrics within rtol 1e-4, the clipped gradient within 1e-3 of each
    leaf's max abs (phase 10's bound for the train step)."""
    exact = dict(dtype="float32", matmul_precision="highest",
                 input_size=TRAIN_EXACT_HW)
    scfg = dataclasses.replace(MODEL, **exact)
    tcfg = dataclasses.replace(S_MODEL, **exact)
    student = yolo11.init_params(torch.Generator().manual_seed(3), scfg)
    teacher = detection_params(torch.Generator().manual_seed(4), tcfg,
                               device="cpu")
    batch = {"images": np.random.default_rng(5).uniform(
        0, 1, (2,) + TRAIN_EXACT_HW + (3,)).astype(np.float32)}
    opt = train_ts.make_optimizer(lr=1e-6, warmup_steps=0, total_steps=10)
    runs = []
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(student).to(dev)
        state = train_ts.TrainState(model, opt.init(model), 0)
        step = make_distill_step(scfg, tcfg, opt, device=dev)
        state, m = step(state, copy.deepcopy(teacher).to(dev), batch)
        runs.append(({k: float(v) for k, v in m.items()}, state))
    (mc, sc), (mh, sh) = runs
    for k in mh:
        check(abs(mc[k] - mh[k]) <= 1e-4 * abs(mh[k]) + 1e-7,
              f"exact distill step: {k} {mc[k]} on the card, {mh[k]} on "
              "the CPU")
    worst = 0.0
    for name, mu in sh.opt_state["mu"].items():
        g_h = mu.numpy() / 0.1
        g_c = sc.opt_state["mu"][name].cpu().numpy() / 0.1
        err = float(np.abs(g_c - g_h).max()) / max(float(np.abs(g_h).max()),
                                                    1e-30)
        worst = max(worst, err)
        check(err <= 1e-3, f"exact distill step: gradient of {name} off by "
                           f"{err:.2e} of its max")
    return {"input": list(TRAIN_EXACT_HW), "loss": mc["loss"],
            "loss_cpu": mh["loss"], "worst_grad_err_of_leaf_max": worst}


def distill_phase(donor) -> dict:
    """YOLO11n-seg distilled from YOLO11s-seg at full width (bf16, remat,
    b=8): timed steps with a profile, the float32 step against the CPU,
    and two steps of a YOLOv8n-seg student under the YOLO11n-seg donor
    (no warmup, so the first step updates it and the second's loss and
    grad_norm differ from the first's)."""
    teacher = detection_params(torch.Generator().manual_seed(1), S_MODEL,
                               device=DEVICE).requires_grad_(False)
    opt = train_ts.make_optimizer(lr=1e-4, warmup_steps=2, total_steps=100)
    state = train_ts.init_train_state(torch.Generator().manual_seed(2),
                                      MODEL, opt, device=DEVICE)
    step = make_distill_step(MODEL, S_MODEL, opt, device=DEVICE)
    gen = torch.Generator().manual_seed(6)
    batch = {"images": torch.rand((TRAIN_BATCH,) + MODEL.input_size + (3,),
                                  generator=gen).to(DEVICE)}
    rows = []

    def one():
        _, m = step(state, teacher, batch)
        rows.append(dict(zip(m, torch.stack(list(m.values())).tolist())))

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LE_TIMED_STEPS):
        one()
    wall_ms = (time.perf_counter() - t0) * 1e3 / LE_TIMED_STEPS
    prof = profile_batch(one, TRAIN_BATCH, LE_PROFILED_STEPS, top=6)
    finite_steps(rows, len(rows), "distill")
    check(rows[-1]["teacher_agreement"] > 0.0,
          f"distill: agreement {rows[-1]['teacher_agreement']}")
    numbers = {"ms": wall_ms, "images_per_s": TRAIN_BATCH * 1e3 / wall_ms,
               "device_ms": prof["device_ms"],
               "device_idle_share": 1.0 - prof["device_ms"] / wall_ms,
               "launches": prof["launches"], "top": prof["top"],
               "profiled_wall_ms": prof["wall_ms"],
               "first": rows[0], "last": rows[-1]}
    numbers["exact"] = exact_distill_card_vs_cpu()

    v8 = dataclasses.replace(MODEL, arch="yolov8")
    v8_opt = train_ts.make_optimizer(lr=1e-3, warmup_steps=0,
                                     total_steps=100)
    v8_state = train_ts.init_train_state(torch.Generator().manual_seed(3),
                                         v8, v8_opt, device=DEVICE)
    v8_step = make_distill_step(v8, MODEL, v8_opt, device=DEVICE)
    v8_rows = []
    for _ in range(2):
        _, m = v8_step(v8_state, donor, batch)
        v8_rows.append({k: float(v) for k, v in m.items()})
    finite_steps(v8_rows, 2, "YOLOv8n-seg student")
    check(all(v8_rows[1][k] != v8_rows[0][k] for k in ("loss", "grad_norm"))
          and v8_rows[1]["teacher_agreement"] > 0.0,
          f"YOLOv8n-seg student: the second step {v8_rows[1]} shows no "
          f"update from the first {v8_rows[0]}")
    numbers["v8_student"] = v8_rows
    return numbers


def label_phase(donor, frames) -> dict:
    """generate_pseudo_samples and rank_frames ("margin", "flip") through
    the 80-class segmenter on the frames, each with the launch counters
    zeroed around it (K1 once per pipeline call at B=1), each equal to the
    same call through the plain NMS; the COCO JSON read back through
    CocoDataset."""
    ex = ExecutorConfig(model=MODEL)
    scan = ExecutorConfig(model=MODEL,
                          post=PostprocessConfig(nms_backend="scan"))
    n = len(frames)
    out, launches = {}, {}

    def counted(what, fn, expect):
        launch_counts.reset()
        t = time.perf_counter()
        got = fn(ex)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        c, by_b = read_counters(), k1_by_batch()
        check(c[K1["name"]] == expect
              and sum(post_counts(c).values()) == expect
              and by_b == {1: expect},
              f"{what}: launches {c} by batch {by_b}; expected K1 {expect} "
              "times at B=1 and nothing else")
        launches[what] = c[K1["name"]]
        return got, fn(scan), sec

    got, want, sec = counted("pseudo", lambda c: generate_pseudo_samples(
        c, donor, frames, score_gate=0.5, poly_step=2, device=DEVICE), n)
    n_poly = 0
    for g, w in zip(got, want, strict=True):
        check(len(g["labels"]) > 0 and np.array_equal(g["labels"],
                                                      w["labels"])
              and np.array_equal(g["boxes"], w["boxes"])
              and len(g["polys"]) == len(w["polys"]),
              "pseudo: the samples differ from the plain NMS's")
        for a, b in zip(g["polys"], w["polys"]):
            check((a is None) == (b is None)
                  and (a is None or np.array_equal(a, b)),
                  "pseudo: a polygon differs from the plain NMS's")
            n_poly += a is not None
    check(n_poly > 0, "pseudo: no polygon")
    files = []
    LE_DIR.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        files.append(f"f{i}.png")
        Image.fromarray(f).save(LE_DIR / files[-1])
    (LE_DIR / "pseudo.json").write_text(json.dumps(coco_from_samples(
        got, files, [str(c) for c in range(MODEL.num_classes)])))
    ds = data_lib.CocoDataset(str(LE_DIR / "pseudo.json"), str(LE_DIR))
    check(len(ds) == n and all(np.array_equal(ds[i]["labels"],
                                              got[i]["labels"])
                               for i in range(n)),
          "pseudo: the COCO JSON does not read back with the same labels")
    out["pseudo"] = {"s_per_frame": sec / n,
                     "labels": sum(len(s["labels"]) for s in got),
                     "polygons": n_poly}
    for strategy, per in (("margin", 1), ("flip", 2)):
        got, want, sec = counted(
            f"active {strategy}", lambda c, s=strategy: rank_frames(
                c, donor, frames, strategy=s, device=DEVICE), per * n)
        check(got == want, f"active {strategy}: {got} != the plain NMS's "
                           f"{want}")
        out[f"active_{strategy}"] = {"s_per_frame": sec / n,
                                     "order": [i for i, _ in got],
                                     "top": got[0][1]}
    return {"numbers": out, "launches": launches}


def run_script(main_fn, argv, what: str) -> str:
    """A script's main(argv) in this process; its stdout, which must show
    it returned 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    check(rc == 0, f"{what} returned {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue()


def scripts_phase(donor) -> dict:
    """Each training script's main(argv) at a small size on the card, on
    npz and PNG files written to build/label_efficiency/scripts."""
    root = LE_DIR / "scripts"
    shutil.rmtree(root, ignore_errors=True)
    (root / "data" / "images").mkdir(parents=True)
    (root / "data" / "labels").mkdir(parents=True)
    rng = np.random.default_rng(9)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), np.uint8)).save(
            root / "data" / "images" / f"f{i}.png")
        (root / "data" / "labels" / f"f{i}.txt").write_text(
            f"{i % 3} 0.5 0.5 0.3 0.4\n1 0.3 0.6 0.2 0.2\n")
    save_npz(str(root / "seg80.npz"), donor)
    det3 = detection_params(torch.Generator().manual_seed(2), dataclasses.
                            replace(MODEL, task="detect", num_classes=3),
                            label=1, device=DEVICE)
    save_npz(str(root / "det3.npz"), det3)
    dev = ["--device", DEVICE]
    done = {}
    t = time.perf_counter()
    text = run_script(ex_train.main, [
        "--data", str(root / "data"), "--weights", str(root / "seg80.npz"),
        "--classes", "3", "--epochs", "1", "--batch", "2", "--size", "128",
        "--out", str(root / "train"), *dev], "examples.train")
    check("transfer: 194 leaves" in text and (root / "train" /
                                              "ema.npz").exists(),
          f"examples.train: no transfer or no checkpoint: {text[-800:]}")
    done["train"] = time.perf_counter() - t
    t = time.perf_counter()
    run_script(ex_train_tasks.main, [
        "--task", "pose", "--steps", "2", "--size", "64",
        "--out", str(root / "pose.npz"), *dev], "examples.train_tasks")
    check((root / "pose.npz").exists(), "examples.train_tasks: no npz")
    done["train_tasks"] = time.perf_counter() - t
    t = time.perf_counter()
    run_script(ex_train_toy.main, [
        "--steps", "2", "--batch", "2", "--size", "64",
        "--out", str(root / "toy"), *dev], "examples.train_toy")
    check((root / "toy" / "toy_ckpt.npz").exists(),
          "examples.train_toy: no npz")
    done["train_toy"] = time.perf_counter() - t
    t = time.perf_counter()
    text = run_script(ex_distill.main, [
        "--teacher", str(root / "det3.npz"), "--teacher-task", "detect",
        "--images", str(root / "data" / "images"), "--size", "64",
        "--steps", "2", "--batch", "2", "--out", str(root / "distill"),
        *dev], "examples.distill")
    summary = json.loads(text.strip().splitlines()[-1])
    load_params_auto(summary["out"], dataclasses.replace(
        MODEL, task="detect", num_classes=3, input_size=(64, 64)))
    check(np.isfinite(summary["final_loss"]), f"distill: {summary}")
    done["distill"] = time.perf_counter() - t
    t = time.perf_counter()
    run_script(tool_pseudo.main, [
        "--images", str(root / "data" / "images"), "--weights",
        str(root / "seg80.npz"), "--size", "128", "--out",
        str(root / "pseudo.json"), *dev], "tools.pseudo_label")
    check(len(data_lib.CocoDataset(str(root / "pseudo.json"),
                                   str(root / "data" / "images"))) == 4,
          "tools.pseudo_label: the JSON does not read back")
    done["pseudo_label"] = time.perf_counter() - t
    t = time.perf_counter()
    text = run_script(tool_select.main, [
        "--images", str(root / "data" / "images"), "--weights",
        str(root / "seg80.npz"), "--size", "128", "--k", "2",
        "--strategy", "flip", "--out", str(root / "sel.json"), *dev],
        "tools.select_frames")
    check(json.loads(text.strip().splitlines()[-1])["selected"] == 2
          and (root / "sel.json").exists(), "tools.select_frames")
    done["select_frames"] = time.perf_counter() - t
    return done


def phase_label_efficiency(smi: str) -> dict:
    """Phase 11: transfer + fit, model_info, distillation, pseudo-labels
    and active selection through K1, and the training scripts."""
    t0 = time.perf_counter()
    shutil.rmtree(LE_DIR, ignore_errors=True)
    seconds, numbers = {}, {}
    donor = detection_params(torch.Generator().manual_seed(0), MODEL,
                             device=DEVICE)
    ds = data_lib.SyntheticShapesDataset(n=LE_FIT_N, hw=FRAME_HW,
                                         n_classes=3)
    val_ds = data_lib.SyntheticShapesDataset(n=TRAIN_VAL_N, hw=FRAME_HW,
                                             n_classes=3, seed=1)
    tr = transfer_phase(donor, ds, val_ds)
    numbers["transfer"] = tr["numbers"]
    launches = {"transfer fit validation": tr["launches"]}
    seconds["transfer + fit"] = time.perf_counter() - t0

    info = model_info(MODEL, donor, device=DEVICE)
    check(info["params"] == 2_868_648, f"model_info params {info}")
    check(8.0 < info["gflops"] < 13.0, f"model_info gflops {info['gflops']}"
                                       " outside the loose 8-13 bound")
    numbers["model_info"] = {**info, "published_gflops": 10.4}
    print(f"label_efficiency: model_info YOLO11n-seg 640x640: "
          f"{info['params']} params, {info['gflops']} GFLOPs counted by "
          "torch's FlopCounterMode (a reading; ultralytics publishes 10.4)",
          flush=True)
    seconds["model_info"] = time.perf_counter() - t0 - sum(seconds.values())

    numbers["distill"] = distill_phase(donor)
    d = numbers["distill"]
    print(f"label_efficiency: card {smi}: distill YOLO11s-seg -> "
          f"YOLO11n-seg, bf16 remat, b={TRAIN_BATCH}, 640x640: "
          f"{d['ms']:.2f} ms a step ({d['images_per_s']:.1f} images/s), "
          f"device {d['device_ms']:.2f} ms, idle "
          f"{d['device_idle_share']:.1%}, {d['launches']:.0f} launches; "
          f"float32 step worst gradient error "
          f"{d['exact']['worst_grad_err_of_leaf_max']:.2e} of a leaf's max",
          flush=True)
    seconds["distill"] = time.perf_counter() - t0 - sum(seconds.values())

    rng = np.random.default_rng(LE_SEED)
    frames = [rng.integers(0, 256, FRAME_HW + (3,), np.uint8)
              for _ in range(LE_FRAMES)]
    lab = label_phase(donor, frames)
    numbers.update(lab["numbers"])
    launches.update(lab["launches"])
    seconds["pseudo + active"] = time.perf_counter() - t0 - sum(
        seconds.values())

    numbers["scripts_s"] = scripts_phase(donor)
    seconds["scripts"] = time.perf_counter() - t0 - sum(seconds.values())
    seconds["whole phase"] = time.perf_counter() - t0
    print("label_efficiency: " + json.dumps({
        "card": smi, **numbers, "launches": launches,
        "seconds": {k: round(v, 2) for k, v in seconds.items()}}),
        flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 12. multi-device serving
# ---------------------------------------------------------------------------

def counted(launches: dict, path: str, fn):
    """fn() with the launch counters zeroed just before and read just
    after (the card synchronised), under launches[path]."""
    launch_counts.reset()
    out = fn()
    torch.cuda.synchronize()
    launches[path] = read_counters()
    return out


def only(counts: dict, want: dict, what: str) -> None:
    """The path launched exactly `want` ({wrapper name: n}) and nothing
    else."""
    got = {k: v for k, v in post_counts(counts).items() if v}
    check(got == want, f"{what}: launches {got}, expected {want}")


def rows_equal(det, refs, rows: int, what: str) -> None:
    """Shard i's rows of the gathered dict bit-equal refs[i]."""
    for i, ref in enumerate(refs):
        for k in ref:
            check(torch.equal(det[k][i * rows:(i + 1) * rows], ref[k]),
                  f"{what}: shard {i}'s {k} differs from build_pipeline "
                  f"(batch={rows}) on its rows")


def scores_close(det, ref, what: str) -> float:
    check(torch.equal(det["count"], ref["count"]),
          f"{what}: counts {det['count'].tolist()} != "
          f"{ref['count'].tolist()}")
    err = float((det["scores"] - ref["scores"]).abs().max())
    check(err <= PAR_SCORE_TOL and bool(det["slate"].isfinite().all()),
          f"{what}: scores differ from the unsharded pipeline by {err:.2e}")
    return err


def median_ms(fn, iters: int = PAR_TIMED) -> float:
    """Median host ms of fn(), each call ended by a host copy."""
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_scripts(model, launches: dict) -> dict:
    """Each inference script's main(argv) with --device cuda on files
    under build/parallel/scripts; K1 (and K3) counted per script."""
    root = PAR_DIR / "scripts"
    shutil.rmtree(root, ignore_errors=True)
    (root / "imgs").mkdir(parents=True)
    rng = np.random.default_rng(13)
    paths = []
    for i in range(3):
        paths.append(root / "imgs" / f"f{i}.png")
        Image.fromarray(rng.integers(0, 256, FRAME_HW + (3,),
                                     np.uint8)).save(paths[-1])
    write_y4m(root / "clip.y4m", [rng.integers(0, 256, FRAME_HW + (3,),
                                               np.uint8) for _ in range(4)])
    save_npz(str(root / "w.npz"), model)
    (root / "list.txt").write_text("\n".join(map(str, paths)))
    dev = ["--device", DEVICE]
    k1, k3 = K1["name"], K3["name"]
    seconds = {}
    for name, fn, argv, want in (
            ("demo", ex_demo.main, ["--images", str(root / "imgs"), "--out",
                                    str(root / "demo"), "--ckpt",
                                    str(root / "w.npz")], {k1: 3}),
            ("serve", ex_serve.main, ["--list", str(root / "list.txt"),
                                      "--ckpt", str(root / "w.npz")],
             {k1: 3}),
            ("track_video", tool_track.main, [
                "--video", str(root / "clip.y4m"), "--out",
                str(root / "track.txt"), "--ckpt", str(root / "w.npz")],
             {k1: 4}),
            ("task_accuracy_report", tool_task_report.main, [
                "--size", str(TASK_REPORT_SIZE), "--out",
                str(root / "tasks.json")], {k1: 25, k3: 25})):
        t = time.perf_counter()
        text = counted(launches, f"script {name}",
                       lambda: run_script(fn, [*argv, *dev], name))
        seconds[name] = time.perf_counter() - t
        got = launches[f"script {name}"]
        # each also warms its pipeline up once: one launch more
        check(all(got[k] >= n for k, n in want.items()),
              f"{name}: launches {got}, expected at least {want}")
        if name == "serve":
            check(len(text.strip().splitlines()) == 3, "serve: 3 lines")
        if name == "track_video":
            check("4 frames ->" in text, f"track_video: {text[-300:]}")
    rep = json.loads((root / "tasks.json").read_text())
    check(set(rep) == {"pose", "obb", "classify"}
          and all(r["n_images"] == 25 for r in rep.values()),
          f"task report: {rep}")
    for task, key in (("pose", "oks_mAP"), ("pose", "box_mAP"),
                      ("obb", "rbox_mAP")):
        r = rep[task]
        check(r["n_detections_ours"] == r["n_detections_oracle"] > 0
              and r[key] >= TASK_REPORT_MIN_MAP, f"task report {task}: {r}")
    r = rep["classify"]
    check(r["top1_agreement"] == 1.0
          and r["prob_max_abs_diff"] <= TASK_REPORT_PROB_TOL,
          f"task report classify: {r}")
    t = time.perf_counter()
    exact = task_report_highest()
    seconds["task report, TF32 off"] = time.perf_counter() - t
    return {"seconds": seconds, "task_report": rep,
            "task_report_highest": exact}


def task_report_highest() -> dict:
    """The task report's pose and obb tables (its 25 frames, weights and
    XR preset) with TF32 off on the card: every detection must match the
    CPU oracle's (mAP 1)."""
    images = tool_task_report.load_images(TASK_REPORT_SIZE)
    pcfg = PostprocessConfig(iou_threshold=0.43, score_threshold=0.301,
                             max_detections=50)
    out = {}
    for task, kw, keys in (("pose", dict(kpt_shape=(17, 3)),
                            ("oks_mAP", "box_mAP")),
                           ("obb", {}, ("rbox_mAP",))):
        mcfg = ModelConfig(scale="n", input_size=(TASK_REPORT_SIZE,) * 2,
                           dtype="float32", task=task,
                           matmul_precision="highest", **kw)
        params = detection_params(torch.Generator().manual_seed(0), mcfg,
                                  device="cpu")
        r = task_parity_report(task, images, params, mcfg, pcfg,
                               device=DEVICE)
        check(r["n_detections_ours"] == r["n_detections_oracle"] > 0
              and all(abs(r[k] - 1.0) < 1e-9 for k in keys),
              f"task report {task}, TF32 off: {r}")
        out[task] = r
    return out


def phase_parallel(smi: str) -> dict:
    """Phase 12: DP, DP+TP, SP, PP, the multi-stream runner, obb over DP,
    the server's mesh, multihost at world size 1 and the inference
    scripts, over meshes of the one card."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    k1, k3 = K1["name"], K3["name"]
    launches, numbers = {}, {}
    cfg = ExecutorConfig(model=MODEL)
    model = detection_params(torch.Generator().manual_seed(0), MODEL,
                             device=DEVICE)
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (8,) + FRAME_HW + (3,), np.uint8)
    mesh2 = make_mesh((2, 1), devices=[dev] * 2)

    # DP b=8 over (2, 1): each shard against build_pipeline(batch=4)
    dp = build_serving_pipeline(cfg, model, mesh2, batch=8,
                                frame_hw=FRAME_HW).warmup()
    shard = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=4,
                           device=DEVICE).warmup()
    b8 = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=8,
                        device=DEVICE).warmup()
    refs = [shard(frames[4 * i:4 * i + 4]) for i in range(2)]
    det = counted(launches, "parallel dp", lambda: dp(frames))
    only(launches["parallel dp"], {k1: 2}, "DP b=8")
    check_det(det, 8, True, "DP b=8")
    rows_equal(det, refs, 4, "DP b=8")
    numbers["dp_b8_ms"] = median_ms(lambda: dp(frames)["slate"].cpu())
    numbers["unsharded_b8_ms"] = median_ms(lambda: b8(frames)["slate"].cpu())

    # DP+TP (1, 2), DP b=8 and SP over 2 bands, float32 without TF32,
    # against the unsharded pipeline
    ecfg = ExecutorConfig(model=EXACT_MODEL)
    emodel = detection_params(torch.Generator().manual_seed(0), EXACT_MODEL,
                              device=DEVICE)
    tp = build_serving_pipeline(ecfg, emodel,
                                make_mesh((1, 2), devices=[dev] * 2),
                                batch=4, frame_hw=FRAME_HW,
                                tp_min_channels=256).warmup()
    sliced = sum(type(m).__name__ == "_SlicedConv"
                 for m in tp.params[0].modules())
    check(sliced > 0, "TP: no conv reaches 256 output channels")
    ref4 = build_pipeline(ecfg, emodel, frame_hw=FRAME_HW,
                          batch=4, device=DEVICE).warmup()(frames[:4])
    det = counted(launches, "parallel tp", lambda: tp(frames[:4]))
    only(launches["parallel tp"], {k1: 1}, "DP+TP")
    numbers["tp_sliced_convs"] = sliced
    numbers["tp_scores_max_err"] = scores_close(det, ref4, "DP+TP")
    edp = build_serving_pipeline(ecfg, emodel, mesh2, batch=8,
                                 frame_hw=FRAME_HW).warmup()
    e8 = build_pipeline(ecfg, emodel, frame_hw=FRAME_HW, batch=8,
                        device=DEVICE).warmup()
    det = counted(launches, "parallel dp highest", lambda: edp(frames))
    only(launches["parallel dp highest"], {k1: 2}, "DP b=8 highest")
    numbers["dp_scores_max_err"] = scores_close(det, e8(frames),
                                                "DP b=8 highest")
    sp_fn, sp_reps = build_spatial_pipeline(ecfg, emodel, mesh2, batch=1,
                                            frame_hw=FRAME_HW)
    e1 = build_pipeline(ecfg, emodel, frame_hw=FRAME_HW, batch=1,
                        device=DEVICE).warmup()
    ref1 = e1(frames[:1])
    sp_fn(sp_reps, frames[:1])
    det = counted(launches, "parallel sp",
                  lambda: sp_fn(sp_reps, frames[:1]))
    only(launches["parallel sp"], {k1: 1}, "SP")
    numbers["sp_scores_max_err"] = scores_close(det, ref1, "SP")
    numbers["sp_b1_ms"] = median_ms(
        lambda: sp_fn(sp_reps, frames[:1])["slate"].cpu())
    numbers["unsharded_f32_b1_ms"] = median_ms(
        lambda: e1(frames[:1])["slate"].cpu())

    # PP over [cuda:0, cuda:0]: run_stream against the direct pipeline
    pp = PipelinedRunner(cfg, model, devices=[dev, dev],
                         frame_hw=FRAME_HW).warmup()
    b1 = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=1,
                        device=DEVICE).warmup()
    stream = [rng.integers(0, 256, (1,) + FRAME_HW + (3,), np.uint8)
              for _ in range(PAR_STREAM_FRAMES)]
    want = [b1(f)["slate"] for f in stream]
    t = time.perf_counter()
    outs = counted(launches, "parallel pp",
                   lambda: pp.run_stream(iter(stream), max_inflight=2))
    numbers["pp_stream_frames_per_s"] = len(stream) / (
        time.perf_counter() - t)
    only(launches["parallel pp"], {k1: PAR_STREAM_FRAMES}, "PP")
    check(len(outs) == len(stream) and all(
        torch.equal(o["slate"], w) for o, w in zip(outs, want)),
        "PP: a run_stream slate differs from the direct pipeline's")
    t = time.perf_counter()
    for f in stream:
        b1(f)
    torch.cuda.synchronize()
    numbers["direct_b1_frames_per_s"] = len(stream) / (
        time.perf_counter() - t)

    # MultiStreamRunner: 2 streams on (2, 1)
    ms = MultiStreamRunner(cfg, model, mesh2, n_streams=2, frame_hw=FRAME_HW)
    ms(frames[:2])
    det = counted(launches, "parallel multistream", lambda: ms(frames[:2]))
    only(launches["parallel multistream"], {k1: 2}, "MultiStreamRunner")
    rows_equal(det, [b1(frames[i:i + 1]) for i in range(2)], 1,
               "MultiStreamRunner")

    # obb over DP (2, 1): K3 once a shard
    ocfg = ExecutorConfig(model=OBB_MODEL)
    omodel = detection_params(torch.Generator().manual_seed(0), OBB_MODEL,
                              device=DEVICE)
    oframes = rng.integers(0, 256, (4,) + OBB_FRAME_HW + (3,), np.uint8)
    odp = build_serving_pipeline(ocfg, omodel, mesh2, batch=4,
                                 frame_hw=OBB_FRAME_HW).warmup()
    oshard = build_pipeline(ocfg, omodel, frame_hw=OBB_FRAME_HW,
                            batch=2, device=DEVICE).warmup()
    orefs = [oshard(oframes[2 * i:2 * i + 2]) for i in range(2)]
    det = counted(launches, "parallel obb dp", lambda: odp(oframes))
    only(launches["parallel obb dp"], {k3: 2}, "obb DP")
    check_obb_det(det, 4, "obb DP")
    rows_equal(det, orefs, 2, "obb DP")

    # the server over mesh {"data": 1}
    srv = InferenceServer(cfg, params=model, frame_hw=FRAME_HW, port=0,
                          mesh_shape={"data": 1}, device=DEVICE).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz",
                timeout=SERVE_TIMEOUT_S) as r:
            health = json.loads(r.read())
        check(health.get("mesh") == {"data": 1, "model": 1},
              f"/healthz: {health}")
        ref = direct_answers(srv, b1, frames[:4])
        http(srv.port, npy_bytes(frames[0]))        # warm the thread
        results = counted(launches, "parallel serve", lambda: [
            (i, *http(srv.port, npy_bytes(frames[i])), 0.0)
            for i in range(4)])
        only(launches["parallel serve"], {k1: 4}, "mesh server")
        numbers["serve"] = answers_match(results, ref, "mesh server")
    finally:
        srv.close()

    # multihost at world size 1 over nccl
    mh.initialize(f"localhost:{free_port()}", num_processes=1, process_id=0,
                  device=DEVICE)
    try:
        gmesh = mh.global_mesh()
        fn, params = build_sharded_pipeline(
            cfg, mh.replicate_params(model, gmesh), gmesh, batch=2,
            frame_hw=FRAME_HW)
        local = mh.shard_host_batch(frames[:2], gmesh, global_batch=2)
        fn(params, local)
        slate = counted(launches, "parallel multihost",
                        lambda: mh.gather_to_hosts(fn(params, local)
                                                   ["slate"]))
        only(launches["parallel multihost"], {k1: 1}, "multihost")
        b2 = build_pipeline(cfg, model, frame_hw=FRAME_HW, batch=2,
                            device=DEVICE)
        check(np.array_equal(slate, b2(frames[:2])["slate"].cpu().numpy()),
              "multihost: the gathered slate differs from the b=2 "
              "pipeline's")
        numbers["multihost_world"] = torch.distributed.get_world_size()
        numbers["multihost_backend"] = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()

    scripts = parallel_scripts(model, launches)
    numbers["scripts_s"] = scripts["seconds"]
    numbers["task_report"] = scripts["task_report"]
    numbers["task_report_highest"] = scripts["task_report_highest"]
    seconds = time.perf_counter() - t0
    print("parallel: " + json.dumps({
        "card": smi, "note": "one card: DP, PP and SP times are the host "
        "cost of sharding, not a speed-up", **numbers,
        "launches": {p: {k: v for k, v in c.items() if v}
                     for p, c in launches.items()},
        "seconds": round(seconds, 2)}), flush=True)
    print(f"parallel: card {smi}: phase 12 took {seconds:.1f} s", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 13. training over a mesh
# ---------------------------------------------------------------------------

def mesh_of(data: int, model: int = 1):
    """A (data, model) mesh that repeats the one card."""
    return make_mesh((data, model), devices=[torch.device(DEVICE)]
                     * (data * model))


def run_steps(cfg, opt, host, batches, mesh=None, **kw):
    """Steps of the train step (no remat) from a copy of `host` on the card:
    the state and each step's metrics as floats."""
    model = copy.deepcopy(host).to(DEVICE)
    state = train_ts.TrainState(model, opt.init(model), 0)
    step = train_ts.make_train_step(cfg, opt, mesh=mesh, use_remat=False,
                                    device=DEVICE, **kw)
    rows = []
    for b in batches:
        state, m = step(state, b)
        rows.append({k: float(v) for k, v in m.items()})
    return state, rows


def same_steps(got, want, rtol: float, what: str) -> float:
    """Each step's loss and grad norm within rtol of the reference's;
    returns the worst relative gap."""
    check(len(got) == len(want), f"{what}: {len(got)} steps, {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            err = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            worst = max(worst, err)
            check(np.isfinite(g[k]) and err <= rtol,
                  f"{what}: step {i} {k} {g[k]} against {w[k]} (rtol "
                  f"{rtol})")
    return worst


def same_params(got, want, what: str) -> float:
    """Every full parameter within MESH_PARAM_ATOL and MESH_PARAM_RTOL of
    the reference's; returns the worst absolute gap."""
    names = [n for n, _ in want.params.named_parameters()]
    worst = 0.0
    for n, a, b in zip(names, train_ts.full_parameters(got),
                       train_ts.full_parameters(want)):
        a, b = a.detach(), b.detach()
        worst = max(worst, float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=MESH_PARAM_ATOL,
                             rtol=MESH_PARAM_RTOL),
              f"{what}: {n} differs beyond atol {MESH_PARAM_ATOL}, rtol "
              f"{MESH_PARAM_RTOL}")
    return worst


def fsdp_slices(state, rules, what: str) -> int:
    """The FSDP placement by shapes (one card holds every slice): each
    leaf the rule splits lives as halves of its split dim, with an empty
    tensor in the module; every other leaf whole. Returns the split
    leaves' count."""
    split = state.placement.split
    want = {n for n, r in rules.params.items() if r.axis is not None}
    check(split and set(split) == want,
          f"{what}: split {sorted(split)[:4]}..., the rule splits "
          f"{sorted(want)[:4]}...")
    for n, t in state.params.named_parameters():
        if n in split:
            sh, d = split[n], rules.params[n].dim
            check(sh.dim == d and t.numel() == 0 and all(
                p.shape[d] * len(sh.parts) == sh.shape[d]
                and isinstance(state.opt_state["mu"][n], train_ts.Shards)
                for p in sh.parts),
                f"{what}: {n} is not held as {len(sh.parts)} slices of dim "
                f"{d}")
        else:
            check(t.numel() > 0, f"{what}: {n} was freed but not split")
    return len(split)


def timed_mesh_steps(opt, host, batch, configs: dict) -> dict:
    """The bf16 remat step at MESH_BATCH for each config (name -> (mesh,
    make_train_step's keywords)), timed in turns (the configs in order,
    then in reverse, MESH_TIMED steps each time, each step ended by the
    trainer's one host copy of its metrics): the median, least and most
    ms a step; then device ms and launches from a one-step profile."""
    runs = {}
    for name, (mesh, kw) in configs.items():
        model = copy.deepcopy(host).to(DEVICE)
        box = [train_ts.TrainState(model, opt.init(model), 0)]
        step = train_ts.make_train_step(MODEL, opt, mesh=mesh,
                                        device=DEVICE, **kw)

        def one(step=step, box=box):
            box[0], m = step(box[0], batch)
            torch.stack(list(m.values())).tolist()

        one()                           # places the state; warms up
        runs[name] = one
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            for _ in range(MESH_TIMED):
                t0 = time.perf_counter()
                runs[name]()
                times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, one in runs.items():
        prof = profile_batch(one, MESH_BATCH, 1, top=3)
        out[name] = {"ms": statistics.median(times[name]),
                     "ms_least": min(times[name]),
                     "ms_most": max(times[name]),
                     "device_ms": prof["device_ms"],
                     "launches": prof["launches"]}
    return out


def mesh_scripts(donor) -> dict:
    """examples.train --mesh 1 --fsdp and examples.distill --mesh 1 with
    --device cuda for 2 steps each: the scripts' mesh path over a (1, 1)
    mesh (one card; a mesh of 2 would rightly raise)."""
    root = MESH_DIR / "scripts"
    (root / "data" / "images").mkdir(parents=True)
    (root / "data" / "labels").mkdir(parents=True)
    rng = np.random.default_rng(13)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), np.uint8)).save(
            root / "data" / "images" / f"f{i}.png")
        (root / "data" / "labels" / f"f{i}.txt").write_text(
            f"{i % 3} 0.5 0.5 0.3 0.4\n1 0.3 0.6 0.2 0.2\n")
    det3 = detection_params(torch.Generator().manual_seed(2), dataclasses.
                            replace(MODEL, task="detect", num_classes=3),
                            label=1, device=DEVICE)
    save_npz(str(root / "det3.npz"), det3)
    done = {}
    t = time.perf_counter()
    text = run_script(ex_train.main, [
        "--data", str(root / "data"), "--classes", "3", "--epochs", "1",
        "--batch", "2", "--size", "128", "--no-mosaic", "--mesh", "1",
        "--fsdp", "--out", str(root / "train"), "--device", DEVICE],
        "examples.train --mesh 1 --fsdp")
    check("done: 1 epochs" in text and (root / "train" / "state.pt").exists(),
          f"examples.train --mesh 1 --fsdp: {text[-800:]}")
    done["train --mesh 1 --fsdp"] = time.perf_counter() - t
    t = time.perf_counter()
    text = run_script(ex_distill.main, [
        "--teacher", str(root / "det3.npz"), "--teacher-task", "detect",
        "--images", str(root / "data" / "images"), "--size", "64",
        "--steps", "2", "--batch", "2", "--mesh", "1",
        "--out", str(root / "distill"), "--device", DEVICE],
        "examples.distill --mesh 1")
    summary = json.loads(text.strip().splitlines()[-1])
    check(summary["steps"] == 2 and np.isfinite(summary["final_loss"]),
          f"examples.distill --mesh 1: {summary}")
    done["distill --mesh 1"] = time.perf_counter() - t
    return done


def phase_mesh_train(smi: str) -> dict:
    """Phase 13: the train step over DP, TP and FSDP meshes of the one card
    against the unsharded step, Trainer.fit over DP with validation
    through K1, save and resume, the DP distill step, obb over DP with
    validation through K3, the step across processes at world size 1 over
    nccl, and the scripts' --mesh."""
    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    seconds, numbers, launches = {}, {}, {}
    exact = dataclasses.replace(MODEL, dtype="float32",
                                matmul_precision="highest")
    host = yolo11.init_params(torch.Generator().manual_seed(13), exact)
    ds = data_lib.SyntheticShapesDataset(n=MESH_FIT_N, hw=FRAME_HW,
                                         n_classes=3)
    hb = next(data_lib.Loader(ds, exact, MESH_BATCH, max_gt=16,
                              device="cpu")._host_batches(0))
    # unequal weights across the shards, one row of padding
    hb["sample_weight"] = np.asarray([1.0, 0.5, 2.0, 1.0, 0.25, 1.5, 1.0,
                                      0.0], np.float32)
    opt = train_ts.make_optimizer(lr=1e-5, warmup_steps=0, total_steps=10)
    ref_state, ref = run_steps(exact, opt, host, [hb])
    for name, mesh, kw in (("DP (2,1)", mesh_of(2), {}),
                           ("TP (1,2)", mesh_of(1, 2),
                            {"tp_min_channels": 256})):
        st, rows = run_steps(exact, opt, host, [hb], mesh, **kw)
        if name.startswith("TP"):
            check(any(type(m).__name__ == "_TrainSlicedConv"
                      for m in st.placement.rows[0].modules()),
                  "TP (1,2): no convolution runs as slices")
        numbers[name] = {"loss": rows[0]["loss"], "loss_unsharded":
                         ref[0]["loss"],
                         "worst_rel": same_steps(rows, ref, MESH_LOSS_RTOL,
                                                 name),
                         "worst_param_abs": same_params(st, ref_state, name)}
    seconds["DP and TP against unsharded"] = time.perf_counter() - t0

    # FSDP (2,1), default fsdp_min_size: 3 steps against DP
    mesh = mesh_of(2)
    rules = train_ts.train_state_shardings(exact, opt, mesh)
    loader = data_lib.Loader(ds, exact, MESH_BATCH, max_gt=16, device="cpu")
    batches = [hb] + list(loader._host_batches(1))[:2]
    fstate = train_ts.shard_train_state(
        train_ts.TrainState(copy.deepcopy(host).to(DEVICE),
                            opt.init(host), 0), mesh, fsdp=True)
    n_split = fsdp_slices(fstate, rules, "FSDP before the steps")
    fstep = train_ts.make_train_step(exact, opt, mesh=mesh, use_remat=False,
                                     fsdp=True)
    frows = []
    for b in batches:
        fstate, m = fstep(fstate, b)
        frows.append({k: float(v) for k, v in m.items()})
    fsdp_slices(fstate, rules, "FSDP after the steps")
    dstate, drows = run_steps(exact, opt, host, batches, mesh)
    numbers["FSDP (2,1)"] = {
        "split_leaves": n_split, "losses": [r["loss"] for r in frows],
        "worst_rel": same_steps(frows, drows, FSDP_LOSS_RTOL, "FSDP"),
        "worst_param_abs": same_params(fstate, dstate, "FSDP")}
    seconds["FSDP against DP"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # ms, device ms and launches a bf16 remat step, unsharded and split
    cuda_batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in hb.items()}
    numbers["timed"] = timed_mesh_steps(
        train_ts.make_optimizer(lr=1e-4, warmup_steps=0, total_steps=100),
        yolo11.init_params(torch.Generator().manual_seed(13), MODEL),
        cuda_batch, {"unsharded": (None, {}), "DP (2,1)": (mesh, {}),
                     "TP (1,2)": (mesh_of(1, 2), {"tp_min_channels": 256}),
                     "FSDP (2,1)": (mesh, {"fsdp": True})})
    seconds["timed steps"] = time.perf_counter() - t0 - sum(seconds.values())

    # Trainer.fit over DP (2,1): bf16, remat; validation through K1; save
    # and resume
    seg = detection_params(torch.Generator().manual_seed(0), MODEL,
                           device=DEVICE)
    val_ds = data_lib.SyntheticShapesDataset(n=MESH_BATCH, hw=FRAME_HW,
                                             n_classes=3, seed=1)
    tcfg = TrainConfig(epochs=1, batch=MESH_BATCH, max_gt=16, lr=1e-3,
                       warmup_steps=1, log_every=0,
                       ckpt_dir=str(MESH_DIR / "fit"),
                       val_max_images=MESH_BATCH)
    tr = Trainer(MODEL, tcfg, mesh=mesh, params=seg)
    val_counts = counted_evaluate(tr)
    with StepRecorder() as rec:
        hist = tr.fit(ds, val_dataset=val_ds, verbose=False)
    per_epoch = MESH_FIT_N // MESH_BATCH
    finite_steps(rec.rows, per_epoch, "mesh fit")
    check(tr.preflight_bytes is not None,
          "mesh fit: the memory preflight did not run")
    check(len(val_counts) == 1 and val_counts[0][0][K1["name"]] == 1
          and sum(post_counts(val_counts[0][0]).values()) == 1
          and val_counts[0][1] == {MESH_BATCH: 1},
          f"mesh fit validation launches {val_counts}; expected K1 once at "
          f"B={MESH_BATCH} and nothing else")
    launches["mesh train validation"] = val_counts[0][0][K1["name"]]
    check(tr.save() is not None, "mesh fit: save() wrote nothing")
    tr2 = Trainer(MODEL, tcfg, mesh=mesh)
    with StepRecorder() as rec2:
        tr2.fit(ds, resume=True, epochs=1, verbose=False)
    finite_steps(rec2.rows, per_epoch, "mesh resumed fit")
    check(tr2.state.step == 2 * per_epoch and len(tr2.history) == 2,
          f"mesh resume: step {tr2.state.step}, {len(tr2.history)} epochs")
    numbers["fit"] = {"history": hist, "steps": rec.rows,
                      "resumed_steps": rec2.rows,
                      "preflight_gb": (tr.preflight_bytes or 0) / 1e9}
    seconds["fit, validation, resume"] = time.perf_counter() - t0 - sum(
        seconds.values())

    # the DP distill step (YOLO11s-seg -> YOLO11n-seg) against the
    # unsharded one, float32 "highest"
    s_exact = dataclasses.replace(S_MODEL, dtype="float32",
                                  matmul_precision="highest")
    teacher = detection_params(torch.Generator().manual_seed(1), s_exact,
                               device=DEVICE).requires_grad_(False)
    images = {"images": np.random.default_rng(14).uniform(
        0, 1, (MESH_BATCH,) + MODEL.input_size + (3,)).astype(np.float32)}
    runs = []
    for m in (None, mesh):
        model = copy.deepcopy(host).to(DEVICE)
        state = train_ts.TrainState(model, opt.init(model), 0)
        step = make_distill_step(exact, s_exact, opt, mesh=m,
                                 use_remat=False, device=DEVICE)
        state, out = step(state, teacher, images)
        runs.append((state, [{k: float(v) for k, v in out.items()}]))
    numbers["distill DP (2,1)"] = {
        "loss": runs[1][1][0]["loss"],
        "worst_rel": same_steps(runs[1][1], runs[0][1], MESH_LOSS_RTOL,
                                "distill DP"),
        "worst_param_abs": same_params(runs[1][0], runs[0][0],
                                       "distill DP")}
    seconds["distill"] = time.perf_counter() - t0 - sum(seconds.values())

    # obb over DP (2,1): 2 steps against the unsharded step, then a fit
    # whose validation goes through K3
    obb_exact = dataclasses.replace(OBB_MODEL, dtype="float32",
                                    matmul_precision="highest")
    obb_ds = data_lib.SyntheticOBBDataset(n=8, hw=OBB_FRAME_HW)
    obb_batches = list(data_lib.Loader(obb_ds, obb_exact, 4, max_gt=8,
                                       device="cpu")._host_batches(0))
    # seeded init weights: detection_params makes every anchor fire alike,
    # and the rotated assigner's ties then turn rounding into another
    # assignment
    obb_init = yolo11.init_params(torch.Generator().manual_seed(15),
                                  obb_exact)
    ref_obb, ref_rows = run_steps(obb_exact, opt, obb_init, obb_batches)
    got_obb, got_rows = run_steps(obb_exact, opt, obb_init, obb_batches,
                                  mesh)
    numbers["obb DP (2,1)"] = {
        "losses": [r["loss"] for r in got_rows],
        "worst_rel": same_steps(got_rows, ref_rows, MESH_LOSS_RTOL,
                                "obb DP"),
        "worst_param_abs": same_params(got_obb, ref_obb, "obb DP")}
    tt = Trainer(OBB_MODEL, TrainConfig(epochs=1, batch=4, max_gt=8,
                                        warmup_steps=1, log_every=0,
                                        val_max_images=4),
                 mesh=mesh, params=detection_params(
                     torch.Generator().manual_seed(0), OBB_MODEL,
                     device=DEVICE))
    counts = counted_evaluate(tt)
    with StepRecorder() as r:
        tt.fit(obb_ds, val_dataset=data_lib.SyntheticOBBDataset(
            n=4, hw=OBB_FRAME_HW, seed=1), verbose=False)
    finite_steps(r.rows, 2, "obb mesh fit")
    check(len(counts) == 1 and counts[0][0][K3["name"]] == 1
          and sum(post_counts(counts[0][0]).values()) == 1,
          f"obb mesh validation launches {counts}; expected K3 once")
    launches["mesh train obb validation"] = counts[0][0][K3["name"]]
    seconds["obb"] = time.perf_counter() - t0 - sum(seconds.values())

    # the step across processes: world size 1 over nccl, the batch given
    # as this process's rows
    mh.initialize(f"localhost:{free_port()}", num_processes=1, process_id=0,
                  device=DEVICE)
    try:
        gmesh = mh.global_mesh()
        model = copy.deepcopy(host).to(DEVICE)
        state = train_ts.shard_train_state(
            train_ts.TrainState(model, opt.init(model), 0), gmesh)
        step = train_ts.make_train_step(exact, opt, mesh=gmesh,
                                        use_remat=False)
        state, m = step(state, mh.shard_host_batch(
            hb, gmesh, global_batch=MESH_BATCH))
        got = [{k: float(v) for k, v in m.items()}]
        check(all(abs(got[0][k] - ref[0][k]) < 1e-3
                  for k in ("loss", "grad_norm")),
              f"multihost step {got[0]} against the unsharded {ref[0]} "
              "(1e-3, tests/mh_worker.py's bound)")
        numbers["multihost"] = {
            "world": torch.distributed.get_world_size(),
            "backend": torch.distributed.get_backend(),
            "worst_rel": same_steps(got, ref, MESH_LOSS_RTOL, "multihost")}
    finally:
        torch.distributed.destroy_process_group()
    seconds["multihost"] = time.perf_counter() - t0 - sum(seconds.values())

    numbers["scripts"] = mesh_scripts(seg)
    seconds["scripts"] = time.perf_counter() - t0 - sum(seconds.values())
    seconds["whole phase"] = time.perf_counter() - t0
    timed = numbers["timed"]
    print(f"mesh_train: card {smi}: bf16 remat step of YOLO11n-seg at "
          f"b={MESH_BATCH}, {MODEL.input_size[0]}x{MODEL.input_size[1]}, "
          "on meshes that repeat the one card (host work of the split, not "
          "a speed-up): " + "; ".join(
              f"{k} {v['ms']:.2f} ms ({v['ms_least']:.2f}-"
              f"{v['ms_most']:.2f}), device {v['device_ms']:.2f} ms, "
              f"{v['launches']:.0f} launches" for k, v in timed.items()),
          flush=True)
    print("mesh_train: " + json.dumps({
        "card": smi, **numbers, "launches": launches,
        "seconds": {k: round(v, 2) for k, v in seconds.items()}}),
        flush=True)
    print(f"mesh_train: card {smi}: phase 13 took "
          f"{seconds['whole phase']:.1f} s", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 14. the .sentis route: load, serve, track, redeploy
# ---------------------------------------------------------------------------

def program_bytes_changed(a: bytes, b: bytes, prog) -> tuple:
    """(bytes of the program region that differ, whether each lies inside
    a scale/zero-point scalar the writer may patch)."""
    scalars = {p + i for p in prog.value_pos if p is not None
               for i in range(4)}
    moved = {i for i in range(prog.segment_base) if a[i] != b[i]}
    return len(moved), moved <= scalars


def within_step(got: yolo11.YOLO11, want: dict, what: str) -> float:
    """Every leaf of `got` within 0.51 * (max - min) / 255 + 1e-7 of the
    float32 leaf in `want` (the writer's round-trip bound), the range
    taken with 0 in it as the quantizer takes it; the worst error in
    steps."""
    worst = 0.0
    for k, v in got.state_dict().items():
        a = want[k].float().cpu()
        step = (max(float(a.max()), 0.0) - min(float(a.min()), 0.0)) / 255.0
        err = float((v.float().cpu() - a).abs().max())
        check(err <= 0.51 * step + 1e-7,
              f"{what}: {k} off by {err:.3e}, half a step is {step / 2:.3e}")
        worst = max(worst, err / step if step else 0.0)
    return worst


def phase_sentis(smi: str) -> dict:
    """YOLO11n-seg at full width written as a uint8 .sentis template,
    loaded through load_params_auto, served at b=1 and b=8 and tracked
    through K1, trained for a few bf16 steps, written back into a copy of
    the template and reloaded, and exported to ONNX."""
    t0 = time.perf_counter()
    shutil.rmtree(SENTIS_DIR, ignore_errors=True)
    SENTIS_DIR.mkdir(parents=True)
    seconds, numbers, launches = {}, {}, {}
    cfg = ExecutorConfig(model=MODEL)
    scan = dataclasses.replace(
        cfg, post=dataclasses.replace(cfg.post, nms_backend="scan"))
    src = detection_params(torch.Generator().manual_seed(0), MODEL,
                           device=DEVICE)
    template = sentis_template(MODEL, src, str(SENTIS_DIR / "deployed.sentis"))
    t = time.perf_counter()
    prog = parse_sentis(template)
    seconds["parse"] = time.perf_counter() - t
    t = time.perf_counter()
    host, got = load_params_auto(template, MODEL)
    seconds["load"] = time.perf_counter() - t
    check(got is MODEL, "load_params_auto changed the config")
    loaded = {k: v.clone() for k, v in host.state_dict().items()}
    numbers["template"] = {"bytes": Path(template).stat().st_size,
                           "chains": len(prog.chains),
                           "values": len(prog.values),
                           "segment_bytes": len(prog.segment)}
    within_step(host, {k: v.cpu() for k, v in src.state_dict().items()},
                "load")
    save_npz(str(SENTIS_DIR / "twin.npz"), host)
    twin, _ = load_params_auto(str(SENTIS_DIR / "twin.npz"), MODEL)
    model, twin = host.to(DEVICE), twin.to(DEVICE)
    frames = np.random.default_rng(1).integers(
        0, 256, (8,) + FRAME_HW + (3,), np.uint8)

    def pipes(c, m):
        return {b: build_pipeline(c, m, frame_hw=FRAME_HW, batch=b,
                                  device=DEVICE).warmup() for b in (1, 8)}

    kern, plain, npz = pipes(cfg, model), pipes(scan, model), pipes(cfg, twin)

    # --- serve: the main path, with the launch counters zeroed around it
    launch_counts.reset()
    runs = {b: kern[b](frames[:b]) for b in (1, 8)}
    torch.cuda.synchronize()
    launches["sentis serve"] = read_counters()
    check(launches["sentis serve"][K1["name"]] == 2
          and sum(post_counts(launches["sentis serve"]).values()) == 2,
          f"sentis serve launches {launches['sentis serve']}; expected K1 "
          "once at b=1 and once at b=8")
    for b, det in runs.items():
        check_det(det, b, True, f"sentis b={b}")
        for what, ref in (("the plain NMS", plain[b](frames[:b])),
                          ("the npz twin", npz[b](frames[:b]))):
            check(torch.equal(det["slate"], ref["slate"])
                  and torch.equal(det["indices"], ref["indices"]),
                  f"sentis b={b}: slate differs from {what}'s")
    print(f"sentis: loaded model at b=1 and b=8: 50/50 detections, slate "
          f"equal to the plain NMS's and the npz twin's; K1 launched "
          f"{launches['sentis serve'][K1['name']]} times", flush=True)

    # --- track: the fused tick on the loaded model
    xr = xr_frames(SENTIS_TICKS + 2, FRAME_HW, DEPTH_HW, seed=3)
    ex = Executor(ExecutorConfig(model=MODEL, fused_tick=True,
                                 emit_masks="none"),
                  params=model, frame_hw=FRAME_HW, device=DEVICE)
    loop = XRLoop(ex)
    tick_until_result(loop, xr[0])                # binds the tick program
    launch_counts.reset()
    before = ex.tracer.counters["frames_dispatched"]
    start_tracking(loop, xr)
    for i, frame in enumerate(xr[2:]):
        prev = ex.tracker.locked_box
        r, _ = tick_until_result(loop, frame)
        check_tracked(ex, prev, r, f"sentis tick {i}")
    torch.cuda.synchronize()
    launches["sentis tick"] = read_counters()
    dispatched = ex.tracer.counters["frames_dispatched"] - before
    check(launches["sentis tick"][K1["name"]] == dispatched
          == SENTIS_TICKS + 2,
          f"sentis ticks: K1 launched {launches['sentis tick'][K1['name']]}"
          f" times over {dispatched} dispatches")
    print(f"sentis: fused tick on the loaded model tracked the target over "
          f"{SENTIS_TICKS} ticks with a non-empty cloud, K1 once a "
          "dispatch", flush=True)

    # --- redeploy: bf16 steps, the template rewritten, reloaded, served
    ds = data_lib.SyntheticShapesDataset(n=SENTIS_BATCH, hw=FRAME_HW,
                                         n_classes=3)
    batch = next(data_lib.Loader(ds, MODEL, SENTIS_BATCH, max_gt=16,
                                 device="cpu")._host_batches(0))
    opt = train_ts.make_optimizer(lr=SENTIS_LR, warmup_steps=0,
                                  total_steps=10)
    student = copy.deepcopy(model)
    state = train_ts.TrainState(student, opt.init(student), 0)
    step = train_ts.make_train_step(MODEL, opt, device=DEVICE)
    t = time.perf_counter()
    for _ in range(SENTIS_STEPS):
        state, m = step(state, batch)
        check(all(np.isfinite(float(v)) for v in m.values()),
              f"sentis train step: non-finite metrics {m}")
    torch.cuda.synchronize()
    seconds[f"{SENTIS_STEPS} train steps"] = time.perf_counter() - t
    trained = {k: v.detach().cpu() for k, v in
               state.params.state_dict().items()}
    check(all(v.dtype == torch.float32 for v in trained.values()),
          "the train step's weights are not float32")
    check(any(not torch.equal(trained[k], loaded[k]) for k in trained),
          "the train steps moved no weight")
    orig = Path(template).read_bytes()
    same = str(SENTIS_DIR / "round_trip.sentis")
    write_yolo11_sentis(same, model, template, MODEL)
    n_same, _ = program_bytes_changed(orig, Path(same).read_bytes(), prog)
    check(n_same < SENTIS_PROGRAM_BYTES,
          f"the loaded weights written back changed {n_same} program bytes")
    out = str(SENTIS_DIR / "finetuned.sentis")
    t = time.perf_counter()
    write_yolo11_sentis(out, state.params, template, MODEL)
    seconds["write"] = time.perf_counter() - t
    new = Path(out).read_bytes()
    n_moved, scalars_only = program_bytes_changed(orig, new, prog)
    check(len(new) == len(orig) and scalars_only,
          "the redeployed file changed the program outside its "
          "scale/zero-point scalars")
    back, _ = load_params_auto(out, MODEL)
    worst = within_step(back, trained, "redeploy")
    reloaded = build_pipeline(cfg, back.to(DEVICE), frame_hw=FRAME_HW,
                              batch=8, device=DEVICE).warmup()
    ref = build_pipeline(scan, back, frame_hw=FRAME_HW, batch=8,
                         device=DEVICE)(frames)
    launch_counts.reset()
    det = reloaded(frames)
    torch.cuda.synchronize()
    launches["sentis redeploy"] = read_counters()
    check(launches["sentis redeploy"][K1["name"]] == 1
          and sum(post_counts(launches["sentis redeploy"]).values()) == 1,
          f"redeployed model launches {launches['sentis redeploy']}")
    check(bool(det["slate"].isfinite().all())
          and torch.equal(det["slate"], ref["slate"]),
          "redeployed model: slate not finite or not the plain NMS's")
    onnx = str(SENTIS_DIR / "finetuned.onnx")
    export_onnx(state.params, MODEL, onnx)
    back_onnx, _ = load_params_auto(onnx, MODEL)
    check(all(torch.equal(v, trained[k])
              for k, v in back_onnx.state_dict().items()),
          "the ONNX export of the trained model did not reload to it")
    print(f"sentis: {SENTIS_STEPS} bf16 train steps at b={SENTIS_BATCH}, "
          f"written into the template ({n_moved} program bytes moved, all "
          f"scale/zero-point scalars; the loaded weights written back move "
          f"{n_same}), reloaded within {worst:.3f} of a step of every "
          "trained leaf, served through K1 equal to the plain NMS; the "
          "ONNX export reloads bit for bit", flush=True)
    numbers.update(program_bytes_moved=n_moved, round_trip_bytes=n_same,
                   worst_error_in_steps=worst)
    seconds["whole phase"] = time.perf_counter() - t0
    line = {"smi": smi, "seconds": seconds, "numbers": numbers,
            "launches": {p: c[K1["name"]] for p, c in launches.items()}}
    print("sentis: " + json.dumps(line), flush=True)
    return {"launches": {p: c[K1["name"]] for p, c in launches.items()}}


# ---------------------------------------------------------------------------
# 15. the main path's probe tools
# ---------------------------------------------------------------------------

PROBE_FRAMES = 120                  # xr_probe's timed tracked frames
EXEC_PROBE_FRAMES = 60
PROBE_WARMUP = 8                    # executor_probe's default warm-up frames
LOAD_CLIENTS, LOAD_PER_CLIENT = 16, 20      # the JAX tool's defaults
LOAD_HW = (640, 640)
# the server's default shedding cap is 8 micro-batches (8 requests at
# micro-batch 1), which 16 clients overrun; the tool's in-process server
# takes one a client, and so does the separate one
LOAD_PENDING = LOAD_CLIENTS
O2O_FRAMES = 150
O2O_WARMUP = 10                     # the tool's default
O2O_SIZE = 640
SERVER_CMD = [sys.executable, "-m", "xrseg_tpu_torch.runtime.server"]
SERVER_START_S = 120.0
PROBE_DIR = Path(__file__).resolve().parent / "build" / "probes"


@contextlib.contextmanager
def dispatch_counts():
    """Count the calls of every frame program while the block runs:
    CompiledPipeline and XRTickPipeline calls (each one dispatch, warm-ups
    included) by (class, o2o), and their warm-ups. Yields the dict it
    fills."""
    counts: dict = {}
    saved = [(cls, name, cls.__dict__[name])
             for cls in (CompiledPipeline, XRTickPipeline)
             for name in ("__call__", "warmup")]

    def wrap(cls, name, fn):
        def counted_fn(self, *args, **kwargs):
            key = (cls.__name__, name, bool(self.cfg.model.o2o))
            counts[key] = counts.get(key, 0) + 1
            return fn(self, *args, **kwargs)
        return counted_fn

    for cls, name, fn in saved:
        setattr(cls, name, wrap(cls, name, fn))
    try:
        yield counts
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def n_calls(counts: dict, o2o=None) -> int:
    return sum(v for (_, name, o), v in counts.items()
               if name == "__call__" and (o2o is None or o == o2o))


def run_tool(main_fn, argv, what: str) -> tuple:
    """A tool's main(argv) on the card, the launch counters zeroed just
    before and read just after and its frame programs' calls counted:
    (its JSON rows, its stdout, its stderr, the counts, K1 by batch, the
    call counts, seconds)."""
    err = io.StringIO()
    launch_counts.reset()
    t0 = time.perf_counter()
    with dispatch_counts() as calls, contextlib.redirect_stderr(err):
        out = run_script(main_fn, argv, what)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counters()
    by_b = k1_by_batch()
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(bool(rows), f"{what} printed no JSON row: {out[-2000:]}")
    return rows, out, err.getvalue(), counts, by_b, calls, sec


def probe_xr(label: str, extra: list, numbers, launches, seconds) -> None:
    """xr_probe at full width: rc 0, points in every timed window, K1 once
    per dispatch and nothing else."""
    rows, out, _, counts, by_b, calls, sec = run_tool(
        tool_xr_probe.main, ["--frames", str(PROBE_FRAMES), *extra,
                             "--device", DEVICE], f"xr_probe {label}")
    for row in rows:
        check(row["frames_timed"] == PROBE_FRAMES and row["points_min"] > 0
              and row["weights"] == "fixture",
              f"xr_probe {label}: {row}")
    n = n_calls(calls)
    only(counts, {K1["name"]: n}, f"xr_probe {label} (dispatches {n})")
    lock = [ln for ln in out.splitlines() if ln.startswith("laser-selected")]
    numbers[f"xr_probe {label}"] = {
        "lock": lock, "dispatches": n, "k1_by_batch": by_b,
        "rows": [{k: row[k] for k in (
            "value", "frames_timed", "lost_frames", "points_min",
            "points_p50", "stage_p50_ms", "fused_tick", "pipelined_depth")}
            for row in rows]}
    launches[f"probes xr_probe {label}"] = counts[K1["name"]]
    seconds[f"xr_probe {label}"] = sec
    for row in rows:
        print(f"probes: xr_probe {label} depth {row['pipelined_depth']}: "
              f"{row['value']} tracked frames/s over {row['frames_timed']}, "
              f"lost {row['lost_frames']}, points min {row['points_min']} "
              f"p50 {row['points_p50']}, stage p50 ms "
              f"{row['stage_p50_ms']}; K1 {counts[K1['name']]} = "
              f"dispatches {n} (by batch {by_b})", flush=True)


def start_server_process(micro_batch: int, log: Path) -> tuple:
    """`python -m xrseg_tpu_torch.runtime.server --port 0` as a separate
    process: (process, url), read from its `serving on` line within
    SERVER_START_S. The caller stops it."""
    proc = subprocess.Popen(
        [*SERVER_CMD, "--port", "0", "--frame-hw", *map(str, LOAD_HW),
         "--micro-batch", str(micro_batch), "--max-pending",
         str(LOAD_PENDING)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=Path(__file__).resolve().parent)
    lines: list = []
    found = threading.Event()

    def read():
        for ln in proc.stdout:
            lines.append(ln)
            if "serving on http://" in ln:
                found.set()
        found.set()                          # the process ended
    threading.Thread(target=read, daemon=True).start()
    found.wait(SERVER_START_S)
    url = next((ln.split("serving on ")[1].split()[0] for ln in lines
                if "serving on http://" in ln), None)
    if url is None:
        stop_process(proc)
        log.write_text("".join(lines))
        raise SmokeFailure(f"server (micro-batch {micro_batch}) did not "
                           f"start within {SERVER_START_S} s: "
                           f"{''.join(lines)[-2000:]}")
    return proc, url, lines


def stop_process(proc) -> int:
    proc.terminate()
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def probe_load_in_process(mb: int, numbers, launches, seconds) -> dict:
    rows, _, _, counts, by_b, calls, sec = run_tool(
        tool_loadtest.main,
        ["--clients", str(LOAD_CLIENTS), "--per-client",
         str(LOAD_PER_CLIENT), "--micro-batch", str(mb), "--frame-hw",
         *map(str, LOAD_HW), "--device", DEVICE], f"loadtest mb {mb}")
    row = rows[-1]
    want = LOAD_CLIENTS * LOAD_PER_CLIENT
    check(row["errors"] == 0 and row["requests"] == want,
          f"loadtest in-process mb {mb}: {row}")
    batches = sum(row["batch_hist"].values())
    warmups = sum(v for (_, name, _), v in calls.items() if name == "warmup")
    only(counts, {K1["name"]: batches + warmups},
         f"loadtest in-process mb {mb} ({batches} batches, {warmups} "
         "pipeline warm-ups)")
    served = want + sum({1, 2, LOAD_CLIENTS})    # run_load's warm-ups too
    check(sum(int(k) * v for k, v in row["batch_hist"].items()) == served,
          f"loadtest in-process mb {mb}: batch_hist {row['batch_hist']} "
          f"does not add up to {served} requests")
    numbers[f"loadtest in-process mb {mb}"] = {**row, "k1_by_batch": by_b}
    launches[f"probes loadtest mb {mb}"] = counts[K1["name"]]
    seconds[f"loadtest in-process mb {mb}"] = sec
    print(f"probes: loadtest in-process micro-batch {mb}: {row['fps']} "
          f"requests/s, p50 {row['p50_ms']} ms p95 {row['p95_ms']} ms, "
          f"batches {row['batch_hist']}; K1 {counts[K1['name']]} = "
          f"{batches} batches + {warmups} warm-ups (by batch {by_b})",
          flush=True)
    return row


def probe_load_separate(mb: int, numbers, seconds) -> dict:
    t0 = time.perf_counter()
    log = PROBE_DIR / f"server_mb{mb}.log"
    proc, url, lines = start_server_process(mb, log)
    try:
        start_s = time.perf_counter() - t0
        out = run_script(tool_loadtest.main, [
            "--url", url, "--clients", str(LOAD_CLIENTS), "--per-client",
            str(LOAD_PER_CLIENT), "--frame-hw", *map(str, LOAD_HW)],
            f"loadtest --url mb {mb}")
        row = json.loads(out.strip().splitlines()[-1])
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        rc = stop_process(proc)
        log.write_text("".join(lines))
    want = LOAD_CLIENTS * LOAD_PER_CLIENT
    check(row["errors"] == 0 and row["requests"] == want,
          f"loadtest --url mb {mb}: {row}")
    # the server answered the load and run_load's warm-up bursts
    served = want + sum({1, 2, LOAD_CLIENTS})
    check(stats["requests"] == served and stats["errors"] == 0,
          f"separate server mb {mb}: /stats {stats['requests']} requests, "
          f"{stats['errors']} errors; expected {served}, 0")
    hist = stats.get("batch_hist", {})
    if mb > 1:
        check(sum(int(k) * v for k, v in hist.items()) == served,
              f"separate server mb {mb}: batch_hist {hist} does not add up "
              f"to {served} requests")
    numbers[f"loadtest separate process mb {mb}"] = {
        **row, "batch_hist": hist, "server_start_s": start_s,
        "server_exit": rc}
    seconds[f"loadtest separate process mb {mb}"] = time.perf_counter() - t0
    print(f"probes: loadtest against a separate server process, "
          f"micro-batch {mb}: {row['fps']} requests/s, p50 {row['p50_ms']} "
          f"ms p95 {row['p95_ms']} ms, batches {hist or 'not kept at 1'}; "
          f"the server started in {start_s:.1f} s and exited {rc}",
          flush=True)
    return row


def phase_probes(smi: str) -> dict:
    """The port's probe tools on the card at full width: xr_probe (the XR
    tick end to end, three modes), executor_probe, loadtest in-process
    and against a separate server process at micro-batch 1 and 8, and
    o2o_latency_ab; each tool's K1 launches counted around its run."""
    t0 = time.perf_counter()
    shutil.rmtree(PROBE_DIR, ignore_errors=True)
    PROBE_DIR.mkdir(parents=True)
    numbers, launches, seconds = {}, {}, {}

    for label, extra in (("sequential", []), ("fused", ["--fused"]),
                         ("pipelined", ["--fused", "--pipelined", "2"])):
        probe_xr(label, extra, numbers, launches, seconds)

    rows, _, err, counts, by_b, calls, sec = run_tool(
        tool_executor_probe.main, [str(EXEC_PROBE_FRAMES), "--warmup",
                                   str(PROBE_WARMUP), "--device", DEVICE],
        "executor_probe")
    row = rows[-1]
    check(row["n_frames"] == EXEC_PROBE_FRAMES and row["platform"] == DEVICE
          and row["p50_latency_ms"] > 0, f"executor_probe: {row}")
    n = n_calls(calls)
    # every frame, warm-up frames included, and the pipeline's warm-up
    check(n == EXEC_PROBE_FRAMES + PROBE_WARMUP + 1,
          f"executor_probe: {n} dispatches")
    only(counts, {K1["name"]: n}, "executor_probe")
    numbers["executor_probe"] = {**row, "k1_by_batch": by_b}
    launches["probes executor_probe"] = counts[K1["name"]]
    seconds["executor_probe"] = sec
    print(f"probes: executor_probe: p50 {row['p50_latency_ms']} ms p95 "
          f"{row['p95_latency_ms']} ms, {row['interactive_fps']} interactive "
          f"fps, RUNNING ticks p50 {row['running_ticks_p50']} max "
          f"{row['running_ticks_max']}, poll wait p50 "
          f"{row['running_wait_ms_p50']} ms, readback p50 "
          f"{row['readback_ms_p50']} ms; K1 {counts[K1['name']]} = "
          f"dispatches {n}", flush=True)
    print(f"probes: {err.strip()}", flush=True)

    for mb in (1, 8):
        probe_load_in_process(mb, numbers, launches, seconds)
    for mb in (8, 1):
        probe_load_separate(mb, numbers, seconds)

    rows, _, _, counts, by_b, calls, sec = run_tool(
        tool_o2o_ab.main, ["--frames", str(O2O_FRAMES), "--warmup",
                           str(O2O_WARMUP), "--size", str(O2O_SIZE),
                           "--device", DEVICE],
        "o2o_latency_ab")
    row = rows[-1]
    plain_calls, o2o_calls = n_calls(calls, False), n_calls(calls, True)
    check(plain_calls == o2o_calls == O2O_FRAMES + O2O_WARMUP + 1,
          f"o2o_latency_ab: calls plain {plain_calls}, o2o {o2o_calls}")
    only(counts, {K1["name"]: plain_calls}, "o2o_latency_ab (the o2o arm "
         "must launch no NMS kernel)")
    check(row["frames"] == O2O_FRAMES and all(
        0 <= i < O2O_FRAMES for arm in ("plain", "o2o")
        for i in row[arm]["worst_at_frame"]), f"o2o_latency_ab: {row}")
    numbers["o2o_latency_ab"] = row
    launches["probes o2o plain"] = counts[K1["name"]]
    seconds["o2o_latency_ab"] = sec
    print("probes: o2o_latency_ab b=1, ms: " + ", ".join(
        f"{arm} p50 {row[arm]['p50']} p95 {row[arm]['p95']} p99 "
        f"{row[arm]['p99']} worst {row[arm]['worst_ms']} at "
        f"{row[arm]['worst_at_frame']}" for arm in ("plain", "o2o"))
        + f"; p50 delta {row['p50_delta_ms']}; K1 {counts[K1['name']]} "
        f"(plain calls {plain_calls})", flush=True)

    seconds["whole phase"] = time.perf_counter() - t0
    print("probes: " + json.dumps({
        "card": smi, "numbers": numbers, "launches": launches,
        "seconds": {k: round(v, 2) for k, v in seconds.items()}}),
        flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 16. the last tools: stage_profile and the accuracy A/Bs
# ---------------------------------------------------------------------------

TOOLS_SIZE = 640                    # YOLO11n-seg and the YOLOv8n student
STAGE_BATCH = 128                   # the JAX bench's headline batch
STAGE_CALLS = 2 + 2 * 20            # count_flops, warm-up, 2 windows of 20
TOOLS_N_TRAIN, TOOLS_N_VAL = 16, 8
BF16_PEAK_TFLOPS = 989.0            # H100 SXM dense bf16 at 700 W
TOOLS_DIR = Path(__file__).resolve().parent / "build" / "tools"
EVAL_KEYS = {"box_mAP", "box_AP50", "box_AP75", "n_images", "n_gt"}


@contextlib.contextmanager
def k1_per_call(targets):
    """Wrap each (module, name) while the block runs so that every call
    records (name, kwargs, the K1 launches made inside it); yields the
    list it fills. The tools import these names inside main(), so they
    reach the wrappers."""
    log: list = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def counted_fn(*args, **kwargs):
            k0 = launch_counts.read()[K1["name"]]
            out = fn(*args, **kwargs)
            log.append((name, args, kwargs,
                        launch_counts.read()[K1["name"]] - k0))
            return out
        return counted_fn

    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def fit_losses():
    """Every epoch's mean loss of every Trainer.fit while the block runs."""
    losses: list = []
    real = Trainer.fit

    def fit(self, *args, **kwargs):
        history = real(self, *args, **kwargs)
        losses.extend(row["loss"] for row in history)
        return history

    Trainer.fit = fit
    try:
        yield losses
    finally:
        Trainer.fit = real


def finite_rows(rows, configs, extra: set, what: str) -> None:
    """The rows name `configs` in order, each with the JAX tool's keys and
    finite numbers."""
    check([r["config"] for r in rows] == configs,
          f"{what}: configs {[r['config'] for r in rows]}, expected "
          f"{configs}")
    for r in rows:
        check(EVAL_KEYS | extra <= set(r) and all(
            np.isfinite(v) for v in r.values()
            if isinstance(v, (int, float))), f"{what}: row {r}")


def ab_tool(main_fn, argv, what: str, numbers, launches, seconds) -> tuple:
    """An A/B tool's main(argv) on the card with K1 counted per eval,
    ranking and pseudo-labelling call and the losses of every fit: (its
    rows, its stdout, the call log). Every K1 launch of the run is one of
    those calls'."""
    with k1_per_call([(dataset_eval, "evaluate_dataset"),
                      (active_lib, "rank_frames"),
                      (pseudo_lib, "generate_pseudo_samples")]) as log, \
            fit_losses() as losses:
        rows, out, _, counts, by_b, _, sec = run_tool(main_fn, argv, what)
    losses = losses + [float(v) for v in re.findall(
        r" step +\d+ loss (\S+)", out)]
    check(bool(losses) and all(np.isfinite(v) for v in losses),
          f"{what}: losses {losses}")
    only(counts, {K1["name"]: sum(n for *_, n in log)},
         f"{what} (every launch inside an eval, a ranking or a "
         "pseudo-labelling)")
    numbers[what] = {"rows": rows, "losses": losses,
                     "k1_by_call": [(name, n) for name, _, _, n in log],
                     "k1_by_batch": by_b}
    launches[f"tools {what}"] = counts[K1["name"]]
    seconds[what] = sec
    return rows, out, log


def tools_stage_profile(smi: str, numbers, launches, seconds) -> None:
    """stage_profile at b=128: its rows, K1 at B=128 from the postprocess
    stage and the whole pipeline, the stages' FLOPs against the forward's
    and model_info's, the roofline shares, and the postprocess stage
    again on detection_params outputs."""
    rows, _, _, counts, by_b, calls, sec = run_tool(
        tool_stage_profile.main, [str(STAGE_BATCH), "--size",
                                  str(TOOLS_SIZE), "--device", DEVICE],
        "stage_profile")
    names = [r["stage"] for r in rows]
    check(names == [*tool_stage_profile.STAGES, "WHOLE_PIPELINE"],
          f"stage_profile: rows {names}")
    check(all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
          f"stage_profile: {rows}")
    pipe_calls = n_calls(calls)
    k1 = by_b.get(STAGE_BATCH, 0)
    check(set(by_b) == {STAGE_BATCH} and pipe_calls > 0
          and k1 == pipe_calls + STAGE_CALLS,
          f"stage_profile: K1 by batch {by_b}, pipeline calls {pipe_calls}, "
          f"postprocess stage calls {STAGE_CALLS}")
    only(counts, {K1["name"]: k1}, "stage_profile")
    launches["tools stage_profile"] = k1
    seconds["stage_profile"] = sec

    # the FLOPs, and the postprocess stage where every anchor fires
    t0 = time.perf_counter()
    cfg = ExecutorConfig(model=ModelConfig(
        input_size=(TOOLS_SIZE, TOOLS_SIZE)))
    model = detection_params(torch.Generator().manual_seed(0), cfg.model,
                             device=DEVICE)
    stages = tool_stage_profile.build_stages(
        model, cfg, STAGE_BATCH, torch.Generator().manual_seed(0), DEVICE)
    flops = {n: tool_stage_profile.count_flops(*stages[n])
             for n in tool_stage_profile.FORWARD_STAGES}
    x = stages["backbone_stem_b0-2"][1][0].permute(0, 2, 3, 1)
    forward = tool_stage_profile.count_flops(lambda a: model(a), (x,))
    info = model_info(cfg.model, model, device=DEVICE)["gflops"]
    total = sum(flops.values())
    check(total == forward, f"stage_profile: stages 2-7 count {total} "
          f"FLOPs, the b={STAGE_BATCH} forward {forward}")
    # model_info rounds its b=1 count to 0.01 GFLOP
    check(abs(total / 1e9 - STAGE_BATCH * info) <= STAGE_BATCH * 0.005,
          f"stage_profile: stages 2-7 {total / 1e9} GFLOPs, model_info "
          f"{info} x {STAGE_BATCH}")
    fn, args = stages["postprocess"]
    launch_counts.reset()
    with torch.no_grad():
        det = fn(*args)
    check(bool((det["count"] == MAX_DET).all()),
          f"stage_profile detection_params postprocess: count "
          f"{det['count'].tolist()}")
    post_ms = tool_stage_profile.best_ms(lambda: fn(*args), DEVICE)
    post_k1 = k1_by_batch()
    check(post_k1 == {STAGE_BATCH: 1 + 1 + 2 * 20},
          f"stage_profile detection_params postprocess: K1 {post_k1}")
    launches["tools stage_profile detection_params postprocess"] = \
        post_k1.get(STAGE_BATCH, 0)
    seconds["stage_profile flops + detection_params postprocess"] = \
        time.perf_counter() - t0
    del stages, det, model, x

    share = {r["stage"]: r["tf_per_s"] / BF16_PEAK_TFLOPS for r in rows[:-1]}
    numbers["stage_profile"] = {
        "rows": rows, "flops": flops, "forward_flops": forward,
        "model_info_gflops_b1": info, "bf16_peak_share": share,
        "detection_params_postprocess_ms": post_ms, "k1_by_batch": by_b,
        "pipeline_calls": pipe_calls}
    for r in rows[:-1]:
        print(f"tools: stage_profile b={STAGE_BATCH} {r['stage']}: "
              f"{r['ms']} ms, {r['gflops']} GFLOPs, {r['tf_per_s']} TF/s = "
              f"{share[r['stage']]:.4f} of the {BF16_PEAK_TFLOPS:g} TF/s "
              f"bf16 dense peak ({smi})", flush=True)
    print(f"tools: stage_profile WHOLE_PIPELINE b={STAGE_BATCH}: "
          f"{rows[-1]['ms']} ms (sum of stages {rows[-1]['sum_of_stages_ms']}"
          f" ms); K1 at B={STAGE_BATCH} {k1} = pipeline calls {pipe_calls} "
          f"+ postprocess stage calls {STAGE_CALLS}; stages 2-7 "
          f"{total / 1e9:.3f} GFLOPs = the forward's, model_info {info} x "
          f"{STAGE_BATCH} = {info * STAGE_BATCH:.2f} ({smi})", flush=True)
    print(f"tools: stage_profile postprocess on detection_params outputs "
          f"b={STAGE_BATCH} (50 detections an image): {post_ms:.4f} ms "
          f"({smi})", flush=True)


def phase_tools(smi: str) -> dict:
    """The last tools on the card at full width: stage_profile at b=128,
    then ab_o2o, ab_letterbox, ab_active and ab_distill on short runs,
    each tool's counters zeroed just before it and read just after."""
    t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    numbers, launches, seconds = {}, {}, {}
    tools_stage_profile(smi, numbers, launches, seconds)

    short = ["--size", str(TOOLS_SIZE), "--n-train", str(TOOLS_N_TRAIN),
             "--n-val", str(TOOLS_N_VAL), "--batch", "8", "--device", DEVICE]
    rows, _, log = ab_tool(
        tool_ab_o2o.main, [*short, "--epochs", "1", "--weights", "none",
                           "--out", str(TOOLS_DIR / "ab_o2o.json")],
        "ab_o2o", numbers, launches, seconds)
    finite_rows(rows, [f"{m}@{g}" for m in ("o2o_nms_free", "classic_nms")
                       for g in (0.05, 0.005)], set(), "ab_o2o")
    evals = [(a[0].o2o, n) for name, a, _, n in log
             if name == "evaluate_dataset"]
    check(len(evals) == 4 and all(n == 0 for o2o, n in evals if o2o)
          and all(n > 0 for o2o, n in evals if not o2o),
          f"ab_o2o: K1 by eval (o2o, launches) {evals}: the o2o_nms_free "
          "evaluations must launch none, the classic_nms ones some")
    check((TOOLS_DIR / "ab_o2o.json.student.npz").exists(),
          "ab_o2o: no student npz")

    rows, _, log = ab_tool(
        tool_ab_letterbox.main, [*short, "--epochs", "1", "--weights",
                                 "none"], "ab_letterbox", numbers, launches,
        seconds)
    finite_rows(rows, [f"train_{t}__deploy_{d}" for t in ("stretch",
                                                          "letterbox")
                       for d in ("stretch", "letterbox")], set(),
                "ab_letterbox")
    evals = [(kw.get("resize_mode"), n) for name, _, kw, n in log
             if name == "evaluate_dataset"]
    check(sorted(m for m, _ in evals) == ["letterbox"] * 2 + ["stretch"] * 2
          and all(n > 0 for _, n in evals),
          f"ab_letterbox: K1 by deploy geometry {evals}")

    donor = TOOLS_DIR / "donor80.npz"
    save_npz(str(donor), detection_params(
        torch.Generator().manual_seed(0), ModelConfig(
            input_size=(TOOLS_SIZE, TOOLS_SIZE), dtype="float32"),
        device=DEVICE))
    rows, _, log = ab_tool(
        tool_ab_active.main, [*short, "--seed-set", "4", "--budget", "4",
                              "--epochs", "1", "--seed-epochs", "1",
                              "--weights", str(donor), "--out",
                              str(TOOLS_DIR / "ab_active.json")],
        "ab_active", numbers, launches, seconds)
    finite_rows(rows[:1], ["seed_model"], set(), "ab_active")
    finite_rows(rows[1:], ["random_k_only", "active_k_only", "pseudo_only",
                           "random_k_mix", "active_k_mix", "full_gt"],
                {"n_train_images", "epochs"}, "ab_active")
    kinds = [name for name, *_ in log]
    check(kinds == ["evaluate_dataset", "rank_frames",
                    "generate_pseudo_samples"] + ["evaluate_dataset"] * 6
          and all(n > 0 for *_, n in log),
          f"ab_active: K1 by call {[(k, n) for k, *_, n in log]}")
    with open(TOOLS_DIR / "ab_active.json") as f:
        proto = json.load(f)["protocol"]
    check(proto["pool"] == TOOLS_N_TRAIN - 4 and 0 <= proto[
        "random_active_overlap"] <= 4, f"ab_active: protocol {proto}")

    rows, _, log = ab_tool(
        tool_ab_distill.main, [*short, "--steps", "2", "--teacher-epochs",
                               "1", "--label-fraction", "0.5",
                               "--pure-arm", "--combo-arm", "--weights",
                               str(donor)],
        "ab_distill", numbers, launches, seconds)
    finite_rows(rows, ["teacher"] + [f"student_{a}" for a in (
        "scratch", "distill", "pure", "pseudo", "combo")], set(),
        "ab_distill")
    kinds = [name for name, *_ in log]
    check(kinds == ["evaluate_dataset", "generate_pseudo_samples"]
          + ["evaluate_dataset"] * 5 and all(n > 0 for *_, n in log),
          f"ab_distill: K1 by call {[(k, n) for k, *_, n in log]}")

    for what in ("ab_o2o", "ab_letterbox", "ab_active", "ab_distill"):
        got = numbers[what]
        print(f"tools: {what}: {len(got['rows'])} rows, every number "
              f"finite; losses {[round(v, 4) for v in got['losses']]}; K1 "
              f"by call {got['k1_by_call']} ({seconds[what]:.1f} s)",
              flush=True)
        for r in got["rows"]:
            print(f"tools: {what} {json.dumps(r)}", flush=True)
    seconds["whole phase"] = time.perf_counter() - t0
    print(f"tools: phase 16 took {seconds['whole phase']:.1f} s", flush=True)
    print("tools: " + json.dumps({
        "card": smi, "numbers": numbers, "launches": launches,
        "seconds": {k: round(v, 2) for k, v in seconds.items()}},
        default=float), flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# launch counters and the kernel line
# ---------------------------------------------------------------------------

def read_counters() -> dict:
    """K1-K7's launches since the last launch_counts.reset()."""
    counts = launch_counts.read()
    return {k["name"]: counts[k["name"]] for k in (K1, K2, K3, K4, K5, K6, K7)}


def k1_by_batch() -> dict:
    """K1's launches since the last launch_counts.reset(), by batch size."""
    return {key[1]: n for key, n in launch_counts.read().items()
            if isinstance(key, tuple) and key[0] == K1["name"]}


def post_counts(counts: dict) -> dict:
    """The counts of K1-K6 alone: the conv epilogue (K7) runs once a
    conv in every bf16 forward, so the checks of which postprocessing
    kernels a path launched leave it out."""
    return {k: v for k, v in counts.items() if k != K7["name"]}


CASE_KEYS = ("case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "cluster", "steps", "us_per_step", "inside_share", "n")


def kernel_line(kernels) -> dict:
    rows = []
    for k in kernels:
        m = k["main"]
        rows.append(dict(
            name=k["name"], route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=k["launches"],
            max_abs_err=max(c["max_abs_err"] for c in k["cases"]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m.get("library_ms"),
            shape=m["case"],
            check=("crop equal to the plain version, values within 1e-5"
                   if k["name"] == K4["name"] else
                   "every output bit-equal to the plain version"
                   if k["name"] == K7["name"] else
                   "every output equal to the plain scan in every case"
                   if k["name"] in (K5["name"], K6["name"]) else
                   "idx/ok equal to the plain version in every case"),
            **{key: k[key] for key in ("launches_note", "launches_by_path",
                                       "replaces_note") if key in k},
            cases=[{key: c[key] for key in CASE_KEYS if key in c}
                   for c in k["cases"]],
            **({"on_paths": k["on_paths"]} if "on_paths" in k else {})))
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seconds = {}                              # wall seconds per phase
    try:
        smi = phase_device()
        kernels = phase_nms_kernels() + [phase_k4_seeded()]
        epilogue = phase_conv_epilogue()
        seconds["device, kernels"] = time.perf_counter() - t0
        det, seg = phase_segment()
        kernels[-1]["cases"].append(k4_case(
            det["coefs"].contiguous(), det["protos"].contiguous(),
            det["boxes_xywh"].contiguous(), "K4 segment path b=8 coefs-only"))
        seconds["segment"] = time.perf_counter() - t0 - sum(seconds.values())
        obb = phase_obb()
        seconds["obb"] = time.perf_counter() - t0 - sum(seconds.values())
        tick = phase_tick()
        seconds["tick"] = time.perf_counter() - t0 - sum(seconds.values())
        # each kernel's count on the paths that run it (K1: the segment
        # path and the fused ticks); K4 runs on none
        for k in kernels:
            k["launches"] = (obb if k["name"] == K3["name"] else seg)[k["name"]]
        kernels[0]["launches"] += tick[K1["name"]]
        kernels[0]["launches_by_path"] = {"segment": seg[K1["name"]],
                                          "tick": tick[K1["name"]]}
        kernels[-1]["launches"] = sum(p[K4["name"]] for p in (seg, obb, tick))
        serve = phase_serve()
        seconds["serve"] = time.perf_counter() - t0 - sum(seconds.values())
        for path in ("serve", "stream"):
            kernels[0]["launches"] += serve[path][K1["name"]]
            kernels[0]["launches_by_path"][path] = serve[path][K1["name"]]
            kernels[-1]["launches"] += serve[path][K4["name"]]
        print("serve: " + json.dumps(serve["numbers"]), flush=True)
        tasks = phase_tasks(smi)
        seconds["tasks"] = time.perf_counter() - t0 - sum(seconds.values())
        for k, path in ((kernels[0], "tasks"), (kernels[0], "tasks serve"),
                        (kernels[2], "tasks")):
            counts = tasks["serve" if path == "tasks serve" else "launches"]
            k["launches"] += counts[k["name"]]
            k.setdefault("launches_by_path", {})[path] = counts[k["name"]]
        kernels[2]["launches_by_path"]["obb"] = obb[K3["name"]]
        kernels[0]["cases"] += tasks["k1_cases"]
        kernels[2]["cases"] += tasks["k3_cases"]
        acc = phase_accuracy(smi)
        seconds["accuracy"] = time.perf_counter() - t0 - sum(seconds.values())
        kernels[0]["launches"] += acc["launches"][K1["name"]]
        kernels[0]["launches_by_path"]["ensemble"] = \
            acc["launches"][K1["name"]]
        kernels += wbf_kernels(acc)
        ev = phase_eval(smi)["launches"]
        seconds["eval"] = time.perf_counter() - t0 - sum(seconds.values())
        for k, paths in ((kernels[0], ("segment", "pose")),
                         (kernels[2], ("obb",))):
            for path in paths:
                k["launches"] += ev[path][k["name"]]
                k["launches_by_path"][f"eval {path}"] = ev[path][k["name"]]
        tr = phase_train(smi)["launches"]
        seconds["train"] = time.perf_counter() - t0 - sum(seconds.values())
        for k, path in ((kernels[0], "train validation"),
                        (kernels[2], "train obb validation")):
            k["launches"] += tr[path]
            k["launches_by_path"][path] = tr[path]
        le = phase_label_efficiency(smi)["launches"]
        seconds["label efficiency"] = time.perf_counter() - t0 - sum(
            seconds.values())
        for path, n in le.items():
            kernels[0]["launches"] += n
            kernels[0]["launches_by_path"][path] = n
        par = phase_parallel(smi)["launches"]
        seconds["parallel"] = time.perf_counter() - t0 - sum(seconds.values())
        for k in (kernels[0], kernels[2]):
            for path, counts in par.items():
                if counts[k["name"]]:
                    k["launches"] += counts[k["name"]]
                    k["launches_by_path"][path] = counts[k["name"]]
        mt = phase_mesh_train(smi)["launches"]
        seconds["mesh train"] = time.perf_counter() - t0 - sum(
            seconds.values())
        for k, path in ((kernels[0], "mesh train validation"),
                        (kernels[2], "mesh train obb validation")):
            k["launches"] += mt[path]
            k["launches_by_path"][path] = mt[path]
        st = phase_sentis(smi)["launches"]
        seconds["sentis"] = time.perf_counter() - t0 - sum(seconds.values())
        for path, n in st.items():
            kernels[0]["launches"] += n
            kernels[0]["launches_by_path"][path] = n
        pr = phase_probes(smi)["launches"]
        seconds["probes"] = time.perf_counter() - t0 - sum(seconds.values())
        for path, n in pr.items():
            kernels[0]["launches"] += n
            kernels[0]["launches_by_path"][path] = n
        tl = phase_tools(smi)["launches"]
        seconds["tools"] = time.perf_counter() - t0 - sum(seconds.values())
        for path, n in tl.items():
            kernels[0]["launches"] += n
            kernels[0]["launches_by_path"][path] = n
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        return 1
    # K7 by path, from the same zeroed counters as K1 (its timed cases
    # above are on no path and are not counted)
    by_path, ep = epilogue["launches_by_path"], K7["name"]
    by_path.update({"segment": seg[ep], "obb": obb[ep], "tick": tick[ep],
                    "serve": serve["serve"][ep],
                    "stream": serve["stream"][ep],
                    "tasks": tasks["launches"][ep],
                    "tasks serve": tasks["serve"][ep],
                    "ensemble": acc["launches"][ep]})
    by_path.update({f"eval {path}": c[ep] for path, c in ev.items()})
    by_path.update({path: c[ep] for path, c in par.items() if c[ep]})
    epilogue["launches"] = sum(by_path.values())
    kernels.append(epilogue)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s; by phase "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }", flush=True)
    print(json.dumps(kernel_line(kernels)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
