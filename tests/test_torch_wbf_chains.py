"""The split schedule of the WBF kernels K5/K6 (xrseg_tpu_torch/csrc/wbf.cu),
modelled in plain torch on the CPU, against the plain scans
(ops/wbf.wbf_scan_plain, wbf_rotated_scan_plain) and JAX's WBF
(xrseg_tpu/ops/wbf.py); and the kernels' launch plan (ops/wbf.launch_plan).

The model mirrors the kernels step for step: a candidate goes to chain
label mod G (one chain without class_aware); pass A runs every chain over
its members in stream order, opening while the chain holds fewer than D
clusters; T_cap is the D-th open position of the image over all chains;
pass B reruns each chain that opened after T_cap, opening only at
t <= T_cap; a kept cluster's slot is the rank of its open position. Each
step is the plain scan's, with the plain scan's own expressions
(_iou_rows, _gauss, probiou_gauss, the contributions), on the chain's
clusters only. The model's outputs must EQUAL the plain scan's, every one
of them; its fused slate must hold JAX's slate to indices, labels, valid
and count equal and boxes and scores within 1e-5 relative (the
tolerance of tests/test_torch_wbf.py: cos, sin and atan2 round
differently in the two libraries).

Streams are seeded with numpy: jittered clusters, bf16-tied scores, 1, 3,
15 and 80 labels, G at the plan's value and below the label count (shared
chains), class_aware off, D = 1, 7 and 50 with the cap hit at the first
opens, hit late and not hit, and B = 3 with an image all below the gate.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrseg_tpu.ops import wbf as jwbf
from xrseg_tpu_torch.ops import wbf as twbf
from xrseg_tpu_torch.ops.nms_kernels import PROBIOU_EPS, as_f32, probiou_gauss
from xrseg_tpu_torch.testing import limit_cpu_threads

limit_cpu_threads()

THR, GATE = 0.55, 0.3
REL = 1e-5


def raw_candidates(seed, B, K, rotated, n_labels, centres):
    """Jittered clusters around `centres` centres an image, bf16-tied
    scores in [0, 1], labels drawn per candidate from n_labels; the last
    image of a batch of more than one lies all below the gate."""
    r = np.random.default_rng(seed)
    pick = r.integers(0, centres, (B, K))
    take = pick[..., None].repeat(2, -1)
    xy = np.take_along_axis(r.uniform(20, 600, (B, centres, 2)), take, 1) \
        + r.normal(0, 2, (B, K, 2))
    wh = np.take_along_axis(r.uniform(8, 80, (B, centres, 2)), take, 1) \
        * r.uniform(0.9, 1.1, (B, K, 2))
    boxes = np.concatenate([xy, wh], -1)
    if rotated:
        ang = np.take_along_axis(
            r.uniform(-np.pi / 2, np.pi / 2, (B, centres)), pick, 1) \
            + r.normal(0, 0.05, (B, K))
        boxes = np.concatenate([boxes, ang[..., None]], -1)
    scores = torch.from_numpy(r.uniform(0, 1, (B, K)).astype(
        np.float32)).bfloat16().float().numpy()
    if B > 1:
        scores[-1] = np.minimum(scores[-1], GATE * 0.9)
    labels = r.integers(0, n_labels, (B, K)).astype(np.int32)
    return boxes.astype(np.float32), scores, labels


def split_scan(stream, D, class_aware, G, rotated):
    """The kernels' schedule in plain torch. Returns the plain scan's
    output tuple and, per image, (T_cap or None, chains rerun in pass B,
    the longest chain's length, the live prefix)."""
    boxes, scores, labels, order = stream
    B, K = scores.shape
    thr = as_f32(THR)
    s = scores[..., None]
    if rotated:
        twice = 2 * boxes[..., 4:5]
        contrib = torch.cat([s * boxes[..., :4], s * torch.cos(twice),
                             s * torch.sin(twice), s, torch.ones_like(s)],
                            -1)
        twelve = boxes.new_tensor(12.0)
        cg = twbf._gauss(boxes, twelve)
        eps = as_f32(PROBIOU_EPS)

        def overlap(acc, b, t):
            fg = twbf._gauss(twbf._fuse_rotated(acc), twelve)
            return probiou_gauss(*(v[b, t] for v in cg), *fg,
                                 eps).clamp_min(0)
    else:
        contrib = torch.cat([s * boxes, s, torch.ones_like(s)], -1)
        cc, ca = twbf._corners_area(boxes)

        def overlap(acc, b, t):
            fused = acc[:, :4] / acc[:, 4].clamp_min(1e-12)[:, None]
            fc, fa = twbf._corners_area(fused)
            return twbf._iou_rows(cc[b, t][None], ca[b, t][None], fc[None],
                                  fa[None])[0]

    def run_chain(b, members, may_open):
        """The plain step over one chain's members: clusters in open order
        (sums rows, (top_i, lab, open position))."""
        acc, meta = contrib.new_zeros((0, contrib.shape[-1])), []
        for t in members:
            label = int(labels[b, t])
            if meta:
                iou = overlap(acc, b, t)
                cand = iou >= thr
                if class_aware:
                    cand = cand & torch.tensor([m[1] == label for m in meta])
                if bool(cand.any()):
                    k = int(torch.where(cand, iou, -1.0).argmax())
                    acc[k] = acc[k] + contrib[b, t]
                    continue
            if may_open(t, len(meta)):
                acc = torch.cat([acc, contrib[b, t][None]])
                meta.append((int(order[b, t]), label, t))
        return acc, meta

    acc_out = contrib.new_zeros((B, D, contrib.shape[-1]))
    meta_out = torch.tensor([0, -1], dtype=torch.int32).expand(
        B, D, 2).clone()
    n_open = torch.zeros(B, dtype=torch.int64)
    stats = []
    for b in range(B):
        dead = (~(scores[b] > as_f32(GATE))).nonzero()
        live = int(dead[0]) if len(dead) else K
        chain = [int(labels[b, t]) % G if class_aware else 0
                 for t in range(live)]
        members = {g: [t for t in range(live) if chain[t] == g]
                   for g in sorted(set(chain))}
        part = {g: run_chain(b, m, lambda t, n: n < D)
                for g, m in members.items()}
        opens = sorted(p for _, meta in part.values() for *_, p in meta)
        T = opens[D - 1] if len(opens) >= D else math.inf
        rerun = [g for g, (_, meta) in part.items() if meta[-1][2] > T]
        for g in rerun:
            part[g] = run_chain(b, members[g],
                                lambda t, n: t <= T and n < D)
        slot = {p: i for i, p in enumerate(p for p in opens if p <= T)}
        for acc, meta in part.values():
            for row, (top, lab, p) in zip(acc, meta):
                acc_out[b, slot[p]] = row
                meta_out[b, slot[p]] = torch.tensor([top, lab])
        n_open[b] = len(slot)
        stats.append((None if T == math.inf else T, len(rerun),
                      max((len(m) for m in members.values()), default=0),
                      live))
    return twbf._state(acc_out, meta_out, n_open, 3 if rotated else 1), stats


def slate_of(state, rotated):
    """The state -> the nms_fixed slate, as wbf_(rotated_)fixed_batched
    fuse it."""
    if rotated:
        wsum, cs, sn, ssum, n, top_i, lab, active, n_open = state
        fused = twbf._fuse_rotated(torch.cat(
            [wsum, cs[..., None], sn[..., None], ssum[..., None]], -1))
        return twbf._slate(fused, ssum, n, top_i, lab, active, n_open,
                           "boxes_xywhr")
    wsum, ssum, n, top_i, lab, active, n_open = state
    fused = wsum / ssum.clamp_min(1e-12)[..., None]
    return twbf._slate(fused, ssum, n, top_i, lab, active, n_open,
                       "boxes_xywh")


def assert_slate_close(t, j, key):
    for k in ("indices", "labels", "valid", "count"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    for k in (key, "scores"):
        want = np.asarray(j[k], np.float32)
        np.testing.assert_allclose(t[k].numpy(), want, rtol=REL,
                                   atol=REL * np.abs(want).max(), err_msg=k)


def plan_chains(rotated, D, class_aware):
    what = "xrseg_wbf_rotated" if rotated else "xrseg_wbf"
    return twbf.launch_plan(what, D, class_aware).chains


# (id, rotated, B, K, centres, labels, D, class_aware, G or None for the
# plan's, the cap: "first" = at the first opens, "late", "none")
CASES = [
    ("1lab-D1", False, 3, 160, 20, 1, 1, True, None, "first"),
    ("1lab-D7", False, 3, 160, 20, 1, 7, True, None, "first"),
    ("1lab-D50", False, 3, 160, 20, 1, 50, True, None, "none"),
    ("3lab-D50-late", False, 3, 400, 18, 3, 50, True, None, "late"),
    ("3lab-D50-agnostic", False, 3, 400, 18, 3, 50, False, None, "none"),
    ("15lab-D7", False, 3, 240, 24, 15, 7, True, None, "first"),
    ("15lab-D50-G4", False, 3, 240, 24, 15, 50, True, 4, "late"),
    ("80lab-D50", False, 3, 240, 30, 80, 50, True, None, "late"),
    ("80lab-D50-G7", False, 1, 240, 30, 80, 50, True, 7, "late"),
    ("80lab-D1", False, 1, 240, 30, 80, 1, True, None, "first"),
    ("rot-1lab-D7", True, 3, 120, 16, 1, 7, True, None, "first"),
    ("rot-3lab-D40-late", True, 3, 300, 14, 3, 40, True, None, "late"),
    ("rot-15lab-D50", True, 3, 200, 20, 15, 50, True, None, "late"),
    ("rot-15lab-D7-G4", True, 1, 200, 20, 15, 7, True, 4, "first"),
    ("rot-80lab-D50-agnostic", True, 1, 160, 20, 80, 50, False, None,
     "none"),
]
JAX_CASES = {"1lab-D7", "3lab-D50-late", "80lab-D50", "15lab-D50-G4",
             "rot-3lab-D40-late", "rot-15lab-D50"}


@pytest.mark.parametrize(
    "name,rotated,B,K,centres,n_labels,D,class_aware,G,cap", CASES,
    ids=[c[0] for c in CASES])
def test_split_schedule_equals_the_plain_scan(name, rotated, B, K, centres,
                                              n_labels, D, class_aware, G,
                                              cap):
    boxes, scores, labels = raw_candidates(zlib.crc32(name.encode()), B, K,
                                           rotated, n_labels, centres)
    stream = twbf._topk_candidates(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(labels), 0)
    if G is None:
        G = plan_chains(rotated, D, class_aware)
    got, stats = split_scan(stream, D, class_aware, G, rotated)
    plain = twbf.wbf_rotated_scan_plain if rotated else twbf.wbf_scan_plain
    ref = plain(*stream, THR, GATE, D, class_aware)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and torch.equal(g, r), (name, i)
    # the schedule the case is meant to exercise
    for b, (T, rerun, longest, live) in enumerate(stats[:2]):
        if cap == "none":
            assert T is None and rerun == 0, stats
        elif cap == "first":
            assert T is not None and T < live // 4, stats
        else:
            assert T is not None and T >= live // 4, stats
    if cap != "none" and n_labels > 1 and class_aware:
        assert any(rerun for _, rerun, *_ in stats), stats   # pass B ran
    if B > 1:
        assert stats[-1][3] == 0 and int(got[-1][-1]) == 0
    if name in JAX_CASES:
        jf = jwbf.wbf_rotated_fixed_batched if rotated else \
            jwbf.wbf_fixed_batched
        j = jf(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
               iou_threshold=THR, score_threshold=GATE, max_det=D,
               class_aware=class_aware)
        assert_slate_close(slate_of(got, rotated), j,
                           "boxes_xywhr" if rotated else "boxes_xywh")


def test_negative_labels_go_to_their_residue_chain():
    """The plain scan takes any int32 label: a negative one goes to the
    chain of its non-negative residue, and the result stays the scan's."""
    boxes, scores, labels = raw_candidates(5, 1, 160, False, 6, 16)
    labels = labels - 3
    stream = twbf._topk_candidates(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(labels), 0)
    got, _ = split_scan(stream, 12, True, 4, False)
    ref = twbf.wbf_scan_plain(*stream, THR, GATE, 12, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# ---------------------------------------------------------------------------
# The launch plan: a pure function, no card, no JAX
# ---------------------------------------------------------------------------

KERNELS = sorted(twbf.REC_BYTES)
DS = [1, 7, 31, 32, 33, 50, 63, 64, 65, 100, 256, 257, 512, 1000, 1023,
      1024]


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("what", KERNELS)
def test_plan(what, D, class_aware):
    p = twbf.launch_plan(what, D, class_aware)
    ring = twbf.STAGES * twbf.CHUNK * twbf.REC_BYTES[what]
    if not class_aware:
        assert p.chains == 1
    else:
        assert p.chains == min(twbf.MAX_CHAINS, twbf.CHAIN_SLOTS // D)
        assert p.chains * D <= twbf.CHAIN_SLOTS
    # every cluster has a register: per_thread x the team's threads >= D,
    # with no thread or register more than needed
    team_threads = 32 * p.team_warps
    assert p.per_thread * team_threads >= D
    if D <= twbf.WARP_CHAIN_D[what]:           # a warp a chain, no barrier
        assert p.team_warps == 1 and p.per_thread == -(-D // 32)
        assert p.smem == twbf.WARP_CHAINS * ring
    else:                                      # a block a chain
        assert p.per_thread == 1 and p.team_warps == -(-D // 32)
        assert (p.team_warps - 1) * 32 < D <= team_threads <= 1024
        assert p.smem == ring
    assert p.smem <= 48 * 1024                 # no opt-in needed


def test_plan_at_the_paths():
    """max_det 50 on the segment (80 classes) and obb (15) paths: a chain
    a class; K5 runs a chain as a warp with two clusters a lane (four
    chains a block); K6 as a block of two warps."""
    assert twbf.launch_plan("xrseg_wbf", 50, True) == twbf.ChainPlan(
        128, 1, 2, 24576)
    assert twbf.launch_plan("xrseg_wbf_rotated", 50, True) == \
        twbf.ChainPlan(128, 2, 1, 8192)
    assert twbf.launch_plan("xrseg_wbf_rotated", 32, True).team_warps == 1
    assert twbf.launch_plan("xrseg_wbf", 64, False) == twbf.ChainPlan(
        1, 1, 2, 24576)
    assert twbf.launch_plan("xrseg_wbf", 1024, True) == twbf.ChainPlan(
        32, 32, 1, 6144)


@pytest.mark.parametrize("D", [0, -1, 1025])
def test_plan_refuses_what_the_kernels_do_not_hold(D):
    with pytest.raises(ValueError, match="1 to 1024 clusters"):
        twbf.launch_plan("xrseg_wbf", D, True)
