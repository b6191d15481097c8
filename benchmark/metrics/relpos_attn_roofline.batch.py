"""The rel-pos attention's share (%) of its roofline: the least time of a
step's biased attention calls in SAM's image encoder (per call the larger
of 4 * B' * heads * N^2 * d + 2 * B' * heads * N * (qh + qw) * d FLOPs,
the two products and the two rel-pos products, over 989 TFLOP/s, and q,
k, v and o in bf16 plus the two rel-pos tables, no bias, over 3.35 TB/s;
harness/sam.pipeline_counts) times the batches completed in the traced
window, over the device's busy time inside the program's
`xrseg.relpos_attn` ranges there (harness/ranges.py). The same work
whatever runs the attention. None where the trace holds no such range."""


def read(run):
    tr, n, least = run.get("trace"), run.get("trace_steps"), \
        run.get("relpos_least_s")
    rng = ((tr or {}).get("ranges") or {}).get("xrseg.relpos_attn")
    if not n or not least or not rng or not rng["device_s"]:
        return None
    return 100.0 * least * n / rng["device_s"]
