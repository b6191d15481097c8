"""The port's tools, each runnable as
`python -m xrseg_tpu_torch.tools.<name> --help` and callable as
`main(argv)`: pseudo_label (COCO JSON from the deployed pipeline),
select_frames (active selection), track_video (MOTChallenge rows from the
multi-target tracker), task_accuracy_report (pose, obb and classify
parity against the CPU oracle), and the main path's probes: xr_probe (the
whole XR tick), executor_probe (the Executor's state machine), loadtest
(HTTP load, in-process or against --url) and o2o_latency_ab (b=1 plain
against o2o)."""
