"""The cluster argmax and cluster plan of the FPS and NMS kernels, on the CPU.

`ops/csrc/cluster_argmax.cuh` picks a winner in levels: each thread over
its points (strided by the block size), the warp over its 32 threads, the
CTA over its warps, the cluster over its CTAs, each CTA owning a contiguous
share of the set. `_two_level_argmax` below repeats that partition in
plain torch; the tests hold it against the flat rule of the plain versions
(largest key, then the lowest index) for every cluster size, on data full
of ties: FPS's distance keys and NMS's scores under the kernel's ordered
key. The cluster plan (`ops/dispatch.py:cluster_plan`, `fps_plan`,
`nms_plan`) is tested with a stand-in for the kernels' occupancy query.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from heterofusionrcnn_torch.ops.dispatch import MAX_CLUSTER, cluster_plan, cluster_threads
from heterofusionrcnn_torch.ops.nms import NMS_MAX_SHARE, nms_plan
from heterofusionrcnn_torch.ops.sampling import (
    FPS_POINTS_PER_THREAD,
    farthest_point_sample_plain,
    fps_plan,
)

NO_INDEX = 0xFFFFFFFF
CLUSTERS = [1, 2, 4, 8, 16]
H100_SMS = 132


def _reduce(keys, idx, dim):
    """(largest key, lowest index holding it) along `dim`."""
    top = keys.amax(dim=dim, keepdim=True)
    low = torch.where(keys == top, idx, NO_INDEX).amin(dim=dim, keepdim=True)
    return top.squeeze(dim), low.squeeze(dim)


def _two_level_argmax(keys, valid, cluster, per_thread):
    """The kernels' partition: CTA r of the cluster owns items [r * share,
    (r + 1) * share); thread t of a CTA its items t, t + T, t + 2T, ...
    Each thread takes its first largest key (key 0 and NO_INDEX without
    one), then the warp, the CTA and the cluster each keep the largest key
    and the lowest index holding it; `per_thread` items a thread as the
    wrapper launches it. keys: (n,) int64 in [0, 2^32)."""
    n = keys.shape[0]
    share = -(-n // cluster)
    threads = cluster_threads(n, cluster, per_thread)
    ppt = -(-share // threads)
    k = torch.full((cluster, ppt, threads), -1, dtype=torch.int64)
    i = torch.full((cluster, ppt, threads), NO_INDEX, dtype=torch.int64)
    for r in range(cluster):
        for j in range(ppt):
            lo = r * share + j * threads
            hi = min(lo + threads, (r + 1) * share, n)
            if hi > lo:
                k[r, j, : hi - lo] = torch.where(valid[lo:hi], keys[lo:hi], -1)
                i[r, j, : hi - lo] = torch.arange(lo, hi)
    # A thread: its first (lowest index) largest valid key.
    j = k.argmax(dim=1, keepdim=True)
    tk, ti = k.gather(1, j)[:, 0], i.gather(1, j)[:, 0]
    ti = torch.where(tk < 0, NO_INDEX, ti)
    tk = tk.clamp(min=0)
    wk, wi = _reduce(tk.reshape(cluster, threads // 32, 32), ti.reshape(cluster, threads // 32, 32), 2)
    ck, ci = _reduce(wk, wi, 1)
    return _reduce(ck, ci, 0)


def _flat_argmax(keys, valid):
    """The plain versions' rule: the largest valid key, its lowest index."""
    k = torch.where(valid, keys, -1)
    top = k.max()
    return int(top), int(torch.where(k == top, torch.arange(keys.shape[0]), NO_INDEX).min())


def _score_key(scores):
    """nms.cu's `score_key`: float32 scores as unsigned keys in their order,
    -0 taken as +0."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _fps_keys(rng, n):
    """Squared distances of grid points to a picked set, as the kernel's
    keys (float32 bits, distances >= 0): few distinct values, many zeros."""
    pts = torch.from_numpy(rng.integers(-3, 4, (1, n, 3)).astype(np.float32))
    picked = farthest_point_sample_plain(pts, 24)[0].long()
    d = ((pts[0, :, None] - pts[0, picked][None]) ** 2).sum(-1).amin(1)
    return d.view(torch.int32).to(torch.int64)


@pytest.mark.parametrize("n", [1, 100, 1000, 5000, 16384, 16383])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_two_level_argmax_matches_flat_fps(cluster, n):
    """FPS: the partitioned argmax picks the flat rule's point at every
    cluster size, on grid points whose distances tie everywhere."""
    rng = np.random.default_rng(n)
    keys = _fps_keys(rng, n)
    valid = torch.ones(n, dtype=torch.bool)
    k, i = _two_level_argmax(keys, valid, cluster, FPS_POINTS_PER_THREAD)
    assert (int(k), int(i)) == _flat_argmax(keys, valid)


@pytest.mark.parametrize("n", [1, 100, 9000, 9001])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_two_level_argmax_matches_flat_nms(cluster, n):
    """NMS: the partitioned argmax over alive boxes, under the kernel's
    ordered key, picks the box the plain version picks (largest score by
    float comparison, lowest index), with scores drawn from few values
    (-inf, negatives, -0 and +0 among them) and a mask; a mask with nothing
    alive gives NO_INDEX."""
    rng = np.random.default_rng(n + 1)
    values = np.array([-np.inf, -2.5, -1.0, -0.0, 0.0, 0.25, 0.5, 0.5, 3.0], np.float32)
    scores = torch.from_numpy(rng.choice(values, n))
    for alive in (torch.from_numpy(rng.uniform(size=n) > 0.4), torch.zeros(n, dtype=torch.bool)):
        k, i = _two_level_argmax(_score_key(scores), alive, cluster, 1)
        if not alive.any():
            assert (int(k), int(i)) == (0, NO_INDEX)
            continue
        top = scores[alive].max()
        want = int(torch.nonzero(alive & (scores == top))[0, 0])
        assert int(i) == want


def test_score_key_orders_like_floats():
    """Every score's key is above 0 (the key of "nothing alive"), and keys
    compare as the floats do, -0 equal to +0."""
    s = torch.tensor([-np.inf, -3e38, -1.0, -1e-38, -0.0, 0.0, 1e-38, 1.0, 3e38, np.inf],
                     dtype=torch.float32)
    k = _score_key(s)
    assert bool((k > 0).all())
    for a in range(len(s)):
        for b in range(len(s)):
            assert bool(s[a] < s[b]) == bool(k[a] < k[b])
            assert bool(s[a] == s[b]) == bool(k[a] == k[b])


def _fits_up_to(largest):
    return lambda c, threads: c <= largest


@pytest.mark.parametrize("b,n,want", [
    (4, 16384, 16),   # the RPN's first FPS: 1024 points a CTA
    (1, 16384, 16),   # the CLI's batch 1
    (4, 4096, 4),
    (4, 1024, 1),
    (4, 256, 1),
    (400, 512, 1),    # the RCNN's 400 sets fill the card already
    (16, 16384, 8),   # 16 sets: 16 x C CTAs stay within the SMs
    (40, 16384, 2),
])
def test_fps_plan(b, n, want):
    c, threads = fps_plan(b, n, H100_SMS, _fits_up_to(MAX_CLUSTER))
    assert c == want
    assert threads == cluster_threads(n, c, FPS_POINTS_PER_THREAD)
    assert threads % 32 == 0 and threads <= 1024
    assert b * c <= max(H100_SMS, b)


@pytest.mark.parametrize("b,n,want", [
    (4, 9000, 16),    # the RPN's NMS
    (1, 9000, 16),
    (4, 100, 1),      # the final NMS
    (4, 1, 1),
    (1, 32768, 16),
])
def test_nms_plan(b, n, want):
    c, threads = nms_plan(b, n, H100_SMS, _fits_up_to(MAX_CLUSTER))
    assert c == want
    assert -(-n // c) <= NMS_MAX_SHARE
    assert threads == cluster_threads(n, c)


def test_plan_halves_to_a_cluster_that_fits():
    """The occupancy query vetoes clusters larger than the card can hold;
    the plan halves until one fits, and raises when none does."""
    assert fps_plan(4, 16384, H100_SMS, _fits_up_to(8)) == (8, 512)
    assert nms_plan(4, 9000, H100_SMS, _fits_up_to(4)) == (4, 1024)
    with pytest.raises(RuntimeError):
        fps_plan(4, 16384, H100_SMS, _fits_up_to(0))


def test_nms_plan_keeps_each_share_in_shared_memory():
    """A frame too large for one CTA's shared memory never gets a smaller
    cluster than it needs, even on a small card; the plan raises before it
    would go below."""
    assert nms_plan(400, 20000, H100_SMS, _fits_up_to(MAX_CLUSTER))[0] == 4
    with pytest.raises(RuntimeError):
        nms_plan(4, 20000, H100_SMS, _fits_up_to(2))


def test_cluster_plan_rule():
    """C doubles while a CTA holds more than per_cta items and b * 2C CTAs
    fit the SMs, from `least` up to MAX_CLUSTER."""
    every = _fits_up_to(MAX_CLUSTER)
    assert cluster_plan(2, 100, 132, 10, 1, every)[0] == 16
    assert cluster_plan(2, 100, 132, 50, 1, every)[0] == 2
    assert cluster_plan(40, 100, 132, 10, 1, every)[0] == 2
    assert cluster_plan(1, 100, 132, 1000, 1, every, least=4)[0] == 4
    assert cluster_plan(4, 16384, 132, 1024, 4, every) == (16, 256)
    assert cluster_threads(100, 16) == 32 and cluster_threads(5000, 1) == 1024
    assert cluster_threads(4096, 1, 4) == 1024 and cluster_threads(512, 1, 4) == 128
