"""The sorted KNN arm on the CPU: its schedule mirrored in torch
(tests/knn_mirror.py) against the plain version, the JAX package's jnp
mirror `_knn_reference_jnp` and its Pallas sorted kernel run interpreted;
the Morton key against `_morton_key_bev`; the skip bound against the
distance; the arm choice.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Tolerances: indices bit for bit everywhere; distances bit for bit against
the plain version and `_knn_reference_jnp`, 1e-5 relative against the
interpreted Pallas kernel (its fused three-term sum may round otherwise).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from heterofusionrcnn_tpu.ops import pallas_knn as pk

from heterofusionrcnn_torch.ops import grouping
from heterofusionrcnn_torch.ops.grouping import knn_point, knn_point_plain, knn_prep_plain

from tests.knn_mirror import box_bound, cloud, sorted_schedule, sq_dist


# (cloud, b, n, queries (None: the same set), k); tiles of 32 candidates.
CASES = [
    ("uniform", 2, 1000, None, 8),
    ("uniform", 2, 1000, 333, 8),     # P not a multiple of 32
    ("flat", 2, 1500, 500, 8),
    ("grid", 2, 700, None, 12),       # N not a multiple of T
    ("grid", 1, 517, 77, 16),
    ("dup", 2, 512, None, 4),
    ("dup", 1, 600, 45, 12),
    ("same", 1, 300, None, 16),
    ("same", 2, 20, 40, 1),           # N smaller than a tile
    ("line", 1, 400, None, 8),
    ("line", 2, 257, 31, 12),
    ("grid", 1, 16, None, 16),        # k = N
    ("uniform", 2, 12, 5, 12),        # k = N, N not a multiple of T
    ("flat", 1, 64, 64, 1),
    ("huge", 2, 300, None, 8),        # inf distances, ties by index
]


def _inputs(kind, b, n, p, seed=0):
    xyz = cloud(kind, seed, b, n)
    qrs = xyz if p is None else cloud(kind, seed + 1, b, p)
    return xyz, qrs


@pytest.mark.parametrize("kind,b,n,p,k", CASES)
def test_schedule_matches_plain_and_jax(kind, b, n, p, k):
    xyz, qrs = _inputs(kind, b, n, p)
    tx = torch.from_numpy(xyz)
    tq = tx if p is None else torch.from_numpy(qrs)
    got_d, got_i, visited = sorted_schedule(k, tx, tq)
    want_d, want_i = knn_point_plain(k, tx, tq)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    jd, ji = pk._knn_reference_jnp(k, jnp.asarray(xyz), jnp.asarray(qrs))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))
    assert 0 < visited <= b * tq.shape[1] * n


@pytest.mark.parametrize("n,p", [(300, 300), (100, 300)])
def test_equal_but_distinct_queries_are_another_set(n, p):
    """Only the same object is the same set: queries equal to the
    candidates but another tensor (as many, or more) are sorted as another
    query set, and the schedule stays exact."""
    xyz = torch.from_numpy(cloud("dup", 8, 2, n))
    qrs = xyz.repeat(1, -(-p // n), 1)[:, :p].clone()
    t = knn_prep_plain(xyz, qrs)
    assert t.qperm is not None and t.qperm.shape == (2, p)
    got_d, got_i, _ = sorted_schedule(8, xyz, qrs)
    want_d, want_i = knn_point_plain(8, xyz, qrs)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


@pytest.mark.parametrize("same_set", [False, True])
def test_schedule_matches_interpreted_pallas_sorted_kernel(same_set):
    """The JAX sorted arm at the small tiles of
    tests/test_pallas_kernels.py::test_sorted_knn_fold_modes_exact (module
    attributes set here and restored), duplicate points for ties."""
    saved = (pk._SORTED_TILE_N, pk._SORTED_TILE_Q, pk._SORTED_MIN_N)
    try:
        pk._SORTED_TILE_N, pk._SORTED_TILE_Q, pk._SORTED_MIN_N = 128, 128, 256
        rng = np.random.default_rng(7)
        xyz = rng.uniform(-20, 20, (2, 512, 3)).astype(np.float32)
        xyz[:, 300:332] = xyz[:, 100:132]
        q = xyz if same_set else np.ascontiguousarray(xyz[:, 5:133])
        jd, ji = pk._knn_pallas_sorted(8, jnp.asarray(xyz), jnp.asarray(q), same_set=same_set,
                                       interpret=True)
    finally:
        pk._SORTED_TILE_N, pk._SORTED_TILE_Q, pk._SORTED_MIN_N = saved
    tx = torch.from_numpy(xyz)
    got_d, got_i, _ = sorted_schedule(8, tx, tx if same_set else torch.from_numpy(q))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd), rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["uniform", "flat", "grid", "same", "line"])
def test_bev_key_matches_jax(kind):
    xyz = cloud(kind, 3, 2, 777)
    got = grouping.morton_keys(torch.from_numpy(xyz), torch.from_numpy(xyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pk._morton_key_bev(jnp.asarray(xyz))))


@pytest.mark.parametrize("same_set", [True, False])
def test_prep_tiles_hold_their_points(same_set):
    """The prepared candidates are the input in key order with their
    original index in the fourth word, and each box is its tile's bounds."""
    xyz, qrs = _inputs("dup", 2, 300, None if same_set else 70, seed=4)
    tx = torch.from_numpy(xyz)
    t = knn_prep_plain(tx, tx if same_set else torch.from_numpy(qrs))
    order = t.cand.view(torch.int32)[..., 3].long()
    assert torch.equal(order.sort(dim=1).values, torch.arange(300).expand(2, 300))
    assert torch.equal(t.cand[..., :3], torch.gather(tx, 1, order[..., None].expand(2, 300, 3)))
    assert torch.equal(t.skeys, grouping.knn_sort_keys(tx, tx).gather(1, order))
    assert bool((t.skeys[:, 1:] >= t.skeys[:, :-1]).all())
    for i in range(t.boxes.shape[1]):
        pts = t.cand[:, 32 * i:32 * (i + 1), :3]
        assert torch.equal(t.boxes[:, i, 0, :3], pts.amin(dim=1))
        assert torch.equal(t.boxes[:, i, 1, :3], pts.amax(dim=1))
    assert bool((t.boxes[..., 3] == 0).all())
    if not same_set:
        assert bool((t.sqkeys[:, 1:] >= t.sqkeys[:, :-1]).all())
        assert torch.equal(t.sqkeys, grouping.knn_sort_keys(torch.from_numpy(qrs), tx)
                           .gather(1, t.qperm.long()))


def test_schedule_skips_tiles():
    """On a spread cloud most tiles are skipped; on identical points (every
    distance 0, every bound 0) none may be."""
    x = torch.from_numpy(cloud("uniform", 5, 1, 4096))
    _, _, visited = sorted_schedule(8, x, x)
    assert visited < 0.5 * 4096 * 4096
    s = torch.from_numpy(cloud("same", 5, 1, 256))
    _, _, visited = sorted_schedule(4, s, s)
    assert visited == 256 * 256


_COORD = st.one_of(
    st.floats(-1024.0, 1024.0, width=32),
    st.floats(-(2.0 ** -66), 2.0 ** -66, width=32),
    st.floats(-(2.0 ** 65), 2.0 ** 65, width=32),
)
_POINTS = st.lists(st.tuples(_COORD, _COORD, _COORD), min_size=1, max_size=5)


@settings(max_examples=300, deadline=None)
@given(_POINTS, _POINTS)
def test_box_bound_never_exceeds_distance(qs, cs):
    """lb(query box, candidate box) <= the kernel's rounded distance of
    every pair drawn from the two boxes (mixed signs and magnitudes,
    overflow to inf included)."""
    q = torch.tensor(qs, dtype=torch.float32)
    c = torch.tensor(cs, dtype=torch.float32)
    lb = box_bound(q.amin(0), q.amax(0), c.amin(0), c.amax(0))
    d = sq_dist(q[:, None], c[None])
    assert bool((lb <= d).all())


# The batch-4 forward's 13 KNN calls (sets, candidates, queries) and the
# arm the stated threshold gives each.
MAIN_PATH_ARMS = [
    ((4, 16384, 16384), "sorted"), ((4, 4096, 1024), "sorted"), ((4, 1024, 256), "brute"),
    ((4, 256, 64), "brute"), ((4, 64, 64), "brute"), ((4, 64, 256), "brute"),
    ((4, 256, 1024), "brute"), ((4, 1024, 4096), "brute"), ((4, 4096, 16384), "sorted"),
    ((400, 512, 512), "brute"), ((400, 512, 128), "brute"), ((400, 128, 32), "brute"),
    ((400, 32, 8), "brute"),
]


def test_arm_choice_by_shape():
    """Nothing but the shape decides: from 4096 candidates on the sorted arm,
    below it and past the prep's 16384 points a set the brute arm."""
    assert grouping.KNN_SORTED_MIN_N == 4096
    for (_, n, p), arm in MAIN_PATH_ARMS:
        assert grouping.knn_arm(n, p) == arm
    assert grouping.knn_arm(16385, 16385) == "brute"
    assert grouping.knn_arm(4096, 16385) == "brute"


def test_forced_arms_run_plain_on_cpu():
    xyz = torch.from_numpy(cloud("grid", 6, 2, 90))
    want = knn_point_plain(4, xyz, xyz)
    for arm in (None, "brute", "sorted"):
        got = knn_point(4, xyz, xyz, arm=arm)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        knn_point(4, xyz, xyz, arm="tiled")
