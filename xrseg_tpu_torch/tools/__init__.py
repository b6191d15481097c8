"""The port's tools, each runnable as
`python -m xrseg_tpu_torch.tools.<name> --help` and callable as
`main(argv)`: pseudo_label (COCO JSON from the deployed pipeline),
select_frames (active selection), track_video (MOTChallenge rows from the
multi-target tracker) and task_accuracy_report (pose, obb and classify
parity against the CPU oracle)."""
