"""The port's tools, each runnable as
`python -m xrseg_tpu_torch.tools.<name> --help` and callable as
`main(argv)`: pseudo_label (COCO JSON from the deployed pipeline),
select_frames (active selection), track_video (MOTChallenge rows from the
multi-target tracker), task_accuracy_report (pose, obb and classify
parity against the CPU oracle), the main path's probes: xr_probe (the
whole XR tick), executor_probe (the Executor's state machine), loadtest
(HTTP load, in-process or against --url) and o2o_latency_ab (b=1 plain
against o2o), stage_profile (the b=128 pipeline split into 8 stages with
their ms, FLOPs and TF/s, beside the whole pipeline), and the accuracy
A/Bs on the synthetic-shapes dataset: ab_o2o (one dual-head checkpoint,
NMS-free against NMS), ab_letterbox (the 2x2 train/deploy geometry
matrix), ab_active (active against random labels, with pseudo labels)
and ab_distill (distillation against GT-only training). The A/Bs' donor
weights come from --weights or, unset, the reference project's .sentis
under $XRSEG_REFERENCE (_donor.py)."""
