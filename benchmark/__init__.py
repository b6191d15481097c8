"""The benchmark of xrseg_tpu_torch (see run.py)."""
