"""The process-wide launch count of the port's kernel layer
(xrseg_tpu_torch/ops/launches.py), on the CPU: every wrapper's name and
its details count apart, a reading is a copy, and reset zeroes them all.
The wrappers' own counts on the card are checked where each kernel is
(marker `cuda`). Every reader of the count takes differences within one
test or resets first, so the resets here disturb no other test."""
import pytest

from xrseg_tpu_torch.ops import launches

# each wrapper's name and a detail it counts under (None: it has none)
WRAPPERS = {
    "nms_select_batched_cuda": 32,
    "nms_select_cuda": None,
    "nms_rotated_batched_cuda": None,
    "mask_synth_crop_cuda": None,
    "wbf_scan_cuda": None,
    "wbf_rotated_scan_cuda": None,
    "conv_epilogue_cuda": "channels_last",
    "area_attention_cuda": None,
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_reset_zeroes_every_count_details_included(name):
    detail = WRAPPERS[name]
    launches.count(name, detail)
    launches.count(name)
    got = launches.read()
    assert got[name] == 2
    if detail is not None:
        assert got[name, detail] == 1
    launches.reset()
    got = launches.read()
    assert got[name] == 0 and got[name, detail] == 0 and not got


def test_every_wrapper_counts_apart_and_a_reading_is_a_copy():
    launches.reset()
    for name, detail in WRAPPERS.items():
        launches.count(name, detail)
    reading = launches.read()
    launches.count("nms_select_batched_cuda", 8)
    assert reading == {**{name: 1 for name in WRAPPERS},
                       ("nms_select_batched_cuda", 32): 1,
                       ("conv_epilogue_cuda", "channels_last"): 1}
    now = launches.read()
    assert now["nms_select_batched_cuda"] == 2
    assert {k[1]: n for k, n in now.items() if isinstance(k, tuple)
            and k[0] == "nms_select_batched_cuda"} == {32: 1, 8: 1}


def test_threads_counting_at_once_lose_no_launch():
    """More threads than cores count the same names, with the switch
    interval shortened so that a lost update would show."""
    import os
    import sys
    import threading
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 5000
    launches.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            launches.count("conv_epilogue_cuda", "channels_last")
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = launches.read()
    assert got["conv_epilogue_cuda"] == n_threads * per_thread
    assert got["conv_epilogue_cuda", "channels_last"] == n_threads * per_thread
