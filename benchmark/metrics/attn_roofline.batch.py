"""The fused area attention's share (%) of its roofline: the least time
of a step's attention calls (per call the larger of 4 * B * a * heads *
(N/a)^2 * head_dim FLOPs over 989 TFLOP/s and q, k, v and o in bf16 over
3.35 TB/s; harness/arch.pipeline_counts) times the batches completed in
the traced window, over the device's busy time inside the program's
`xrseg.area_attn` ranges there (harness/ranges.py). None where the
trace holds no such range."""


def read(run):
    tr, n, least = run.get("trace"), run.get("trace_steps"), \
        run.get("attn_least_s")
    rng = ((tr or {}).get("ranges") or {}).get("xrseg.area_attn")
    if not n or not least or not rng or not rng["device_s"]:
        return None
    return 100.0 * least * n / rng["device_s"]
