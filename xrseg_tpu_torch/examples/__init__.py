"""The port's examples, each runnable as
`python -m xrseg_tpu_torch.examples.<name> --help` and callable as
`main(argv)`: train (Trainer.fit, --weights through transfer_params),
train_tasks (pose, obb, classify), train_toy and distill; demo (the test
and XR scenes) and serve (image paths in, JSON detections out)."""
