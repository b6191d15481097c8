"""The port's label-efficiency tools, each runnable as
`python -m xrseg_tpu_torch.tools.<name> --help` and callable as
`main(argv)`: pseudo_label (COCO JSON from the deployed pipeline) and
select_frames (active selection)."""
