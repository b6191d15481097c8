"""The kernels' share (%) of their roofline: the step's least time (per
layer the larger of FLOPs over 989 TFLOP/s and bytes over 3.35 TB/s,
summed; harness/counts.py) times the batches completed in the traced
window, over the device's busy time there."""


def read(run):
    tr, n, least = run.get("trace"), run.get("trace_steps"), \
        run.get("least_step_s")
    if not tr or not n or not least or not tr["busy_s"]:
        return None
    return 100.0 * least * n / tr["busy_s"]
