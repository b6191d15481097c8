"""The NMS kernels' launch plan (xrseg_tpu_torch.ops.nms_kernels.launch_plan).

The plan is a pure function of the batch, the candidate count and the
card's limits, so it is tested here without a card, on an H100's: 132 SMs,
232448 bytes of opt-in shared memory a block, and room for 132, 66, 30 and
15 clusters of 1, 2, 4 and 8 blocks with an SM to each block (what the
card answers through the kernels' libraries). Every
(kernel, B, K) cell is one test. The C launchers only validate a plan
(csrc/nms_common.cuh); that they accept these plans and give the plain
versions' results is tests/test_torch_cuda.py's part, on the card.
"""
import pytest

from xrseg_tpu_torch.ops import nms_kernels as tk
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

SM_COUNT, SMEM_OPTIN = 132, 232448
ROOM = {1: 132, 2: 66, 4: 30, 8: 15}
BUDGET = SMEM_OPTIN - tk.STATIC_SMEM_RESERVE
KERNELS = sorted(tk.BYTES_PER_CANDIDATE)
BATCHES = [1, 8, 16, 17, 32, 128, 133]
# "max": the largest K the kernel takes on this card; 16800, 43008 and
# 64512 are test-time augmentation's 2 x 8400, 2 x 21504 and 3 x 21504
WIDTHS = [1, 33, 257, 1024, 8399, 8400, 16800, 21504, 43008, 64512, "max"]


def _k(what, K):
    return tk.max_k(what, SMEM_OPTIN) if K == "max" else K


def _smallest_fit(what, K):
    per = tk.BYTES_PER_CANDIDATE[what]
    return next(c for c in tk.CLUSTER_SIZES if -(-K // c) * per <= BUDGET)


def _check_plan(what, K, cluster, threads, smem):
    """The blocks' slices cover [0, K) exactly once, fit the blocks' shared
    memory, and the threads are whole warps."""
    assert cluster in (1, 2, 4, 8)
    S = -(-K // cluster)
    slices = [range(min(K, r * S), min(K, r * S + S)) for r in range(cluster)]
    assert sum(len(s) for s in slices) == K
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    assert slices[0].start == 0 and slices[-1].stop == K
    assert smem == S * tk.BYTES_PER_CANDIDATE[what] <= BUDGET
    assert threads % 32 == 0 and 32 <= threads <= 1024
    # the fewest passes over the slice, and no warp more than they need
    passes = -(-S // 1024)
    assert (passes - 1) * threads < S <= passes * threads
    assert passes * (threads - 32) < S or threads == 32


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("what", KERNELS)
def test_plan(what, B, K):
    K = _k(what, K)
    cluster, threads, smem = tk.launch_plan(what, B, K, SM_COUNT, SMEM_OPTIN,
                                            ROOM)
    _check_plan(what, K, cluster, threads, smem)
    fit = _smallest_fit(what, K)
    if K <= 1024:
        assert cluster == 1     # a candidate a thread: no cluster needed
    else:
        # the largest cluster that leaves the images' clusters SMs of their
        # own (one past the card's answer is let through), unless K needs a
        # larger one: then the smallest that holds K
        own = [c for c in tk.CLUSTER_SIZES if B <= ROOM[c] + 1]
        assert cluster == max(own[-1] if own else 1, fit)


@pytest.mark.parametrize("what,B,K,cluster", [
    ("nms_select", 1, 8400, 8), ("nms_select", 16, 21504, 8),
    ("nms_select", 17, 8400, 4), ("nms_select", 31, 8400, 4),
    ("nms_select", 32, 8400, 2), ("nms_select", 67, 8400, 2),
    ("nms_select", 128, 8400, 1), ("nms_select", 1, 1024, 1),
    ("nms_select", 1, 1025, 8), ("nms_select", 128, 21504, 2),
    ("nms_rotated", 1, 21504, 8), ("nms_rotated", 16, 21504, 8),
    ("nms_rotated", 32, 21504, 4), ("nms_rotated", 128, 21504, 4),
    ("nms_rotated", 128, 8400, 2), ("nms_rotated", 133, 1024, 1),
    # test-time augmentation: K1 at 2 x 8400, K3 at 2 and 3 x 21504 (the
    # last needs all 8 blocks of a cluster at any batch)
    ("nms_select", 1, 16800, 8), ("nms_select", 8, 16800, 8),
    ("nms_rotated", 1, 43008, 8), ("nms_rotated", 8, 43008, 8),
    ("nms_rotated", 1, 64512, 8), ("nms_rotated", 8, 64512, 8),
    ("nms_rotated", 32, 64512, 8)])
def test_plan_at_the_main_shapes(what, B, K, cluster):
    assert tk.launch_plan(what, B, K, SM_COUNT, SMEM_OPTIN,
                          ROOM)[0] == cluster


def test_room_defaults_to_sms_over_cluster_size():
    """Without the card's answer a cluster of c blocks counts c SMs."""
    assert tk.launch_plan("nms_select", 17, 8400, SM_COUNT,
                          SMEM_OPTIN)[0] == 8          # 17 <= 132 // 8 + 1
    assert tk.launch_plan("nms_select", 18, 8400, SM_COUNT,
                          SMEM_OPTIN)[0] == 4
    assert tk.launch_plan("nms_select", 18, 8400, 264, SMEM_OPTIN)[0] == 8


@pytest.mark.parametrize("cluster", tk.CLUSTER_SIZES)
@pytest.mark.parametrize("K", [1, 33, 8399, 21503])
@pytest.mark.parametrize("what", KERNELS)
def test_forced_cluster(what, K, cluster):
    """A forced size is taken as it is when its blocks hold K, and refused
    otherwise (21503 candidates need 2 blocks for K1 and 4 for K3)."""
    if cluster < _smallest_fit(what, K):
        with pytest.raises(ValueError, match="cannot hold"):
            tk.launch_plan(what, 3, K, SM_COUNT, SMEM_OPTIN, ROOM,
                           cluster=cluster)
        return
    got = tk.launch_plan(what, 3, K, SM_COUNT, SMEM_OPTIN, ROOM,
                         cluster=cluster)
    assert got[0] == cluster
    _check_plan(what, K, *got)


@pytest.mark.parametrize("B", [1, 133])
@pytest.mark.parametrize("what", KERNELS)
def test_beyond_the_largest_k_is_refused(what, B):
    limit = tk.max_k(what, SMEM_OPTIN)
    assert limit == 8 * (BUDGET // tk.BYTES_PER_CANDIDATE[what]) > 21504
    with pytest.raises(ValueError, match=f"shared-memory limit of {limit} "):
        tk.launch_plan(what, B, limit + 1, SM_COUNT, SMEM_OPTIN)
    with pytest.raises(ValueError, match="the sizes that can are"):
        tk.launch_plan(what, B, 64, SM_COUNT, SMEM_OPTIN, cluster=3)
    with pytest.raises(ValueError, match="K >= 1"):
        tk.launch_plan(what, B, 0, SM_COUNT, SMEM_OPTIN)
