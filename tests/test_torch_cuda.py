"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with `nvcc` (marker `cuda`) and skips
without one. The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: indices and the index-exact kernels' distances bit for bit
(the kernels round term by term, built without FMA contraction, like the
plain versions); fused XConv features atol/rtol 1e-4 (FP32 sums in another
order); the fused 3x3 conv and transposed conv within 1e-4 + 1e-4 |plain|
(3xTF32 products with FP32 sums in another order than cuDNN's FP32, TF32
off); the crop gather bit for bit (a copy).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from heterofusionrcnn_torch.ops.conv import (
    conv3x3_affine_relu,
    conv3x3_affine_relu_plain,
    convtranspose3x3_affine_relu,
    convtranspose3x3_affine_relu_plain,
)
from heterofusionrcnn_torch.ops.cropping import crop_gather, crop_gather_plain
from heterofusionrcnn_torch.ops import grouping
from heterofusionrcnn_torch.ops.grouping import knn_point, knn_point_plain
from heterofusionrcnn_torch.ops import nms as nms_ops
from heterofusionrcnn_torch.ops import sampling
from heterofusionrcnn_torch.ops.dispatch import MAX_CLUSTER, sm_count
from heterofusionrcnn_torch.ops.nms import oriented_nms, oriented_nms_plain
from heterofusionrcnn_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_plain,
)
from heterofusionrcnn_torch.ops.xconv import (
    XCONV_EPILOGUE_KERNEL,
    XConvWeights,
    fused_xconv,
    fused_xconv_plain,
    plan_xconv,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _points(rng, b, n, grid):
    if grid:  # integer coordinates: exact distances and exact ties
        return rng.integers(-6, 7, (b, n, 3)).astype(np.float32)
    return rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)


def _bev_boxes(rng, b, n):
    cx = rng.uniform(-4, 4, (b, n))
    cz = rng.uniform(-4, 4, (b, n))
    hl = rng.uniform(0.5, 2.5, (b, n))
    hw = rng.uniform(0.3, 1.5, (b, n))
    ry = rng.uniform(-np.pi, np.pi, (b, n))
    return np.stack([cx - hl, cz - hw, cx + hl, cz + hw, ry], -1).astype(np.float32)


def _bn(rng, c):
    return (
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2.0, c).astype(np.float32),
    )


def _xconv_params(rng, k, cf, cin, dm, d):
    return {
        "w1": (rng.standard_normal((3, cf)) * 0.5).astype(np.float32),
        "bn1": _bn(rng, cf),
        "w2": (rng.standard_normal((cf, cf)) * 0.3).astype(np.float32),
        "bn2": _bn(rng, cf),
        "wx0": (rng.standard_normal((k * 3, k * k)) * 0.4).astype(np.float32),
        "bnx0": _bn(rng, k * k),
        "wx1": (rng.standard_normal((k, k, k)) * 0.4).astype(np.float32),
        "bnx1": _bn(rng, k * k),
        "wx2": (rng.standard_normal((k, k, k)) * 0.4).astype(np.float32),
        "bnx2": _bn(rng, k * k),
        "wd": (rng.standard_normal((k, cin, dm)) * 0.3).astype(np.float32),
        "wp": (rng.standard_normal((cin * dm, d)) * 0.2).astype(np.float32),
        "bnc": _bn(rng, d),
    }


def _fold(scale, bias, mean, var, eps=1e-3):
    s = scale / np.sqrt(var + eps)
    return torch.from_numpy(s), torch.from_numpy(bias - mean * s)


def _torch_weights(p, with_x):
    t = torch.from_numpy
    k, cin, dm = p["wd"].shape
    wc = np.einsum("kcm,cmd->kcd", p["wd"], p["wp"].reshape(cin, dm, -1))
    w = XConvWeights(t(p["w1"]), *_fold(*p["bn1"]), t(p["w2"]), *_fold(*p["bn2"]),
                     t(np.ascontiguousarray(wc)), *_fold(*p["bnc"]))
    if with_x:
        w.wx0, (w.sx0, w.bx0) = t(p["wx0"]), _fold(*p["bnx0"])
        w.wx1, (w.sx1, w.bx1) = t(p["wx1"]), _fold(*p["bnx1"])
        w.wx2, (w.sx2, w.bx2) = t(p["wx2"]), _fold(*p["bnx2"])
    return w



@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(16384, 512), (512, 128), (100, 30)])
def test_fps_kernel_matches_plain(cuda, n, npoint):
    xyz = torch.from_numpy(_points(np.random.default_rng(4), 2, n, False)).to(cuda)
    got = farthest_point_sample(xyz, npoint)
    torch.testing.assert_close(got, farthest_point_sample_plain(xyz, npoint), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,k", [(False, 8), (True, 12), (False, 4)])
def test_knn_kernel_matches_plain(cuda, grid, k):
    rng = np.random.default_rng(5)
    xyz = torch.from_numpy(_points(rng, 2, 3000, grid)).to(cuda)
    qrs = torch.from_numpy(_points(rng, 2, 700, grid)).to(cuda)
    got_d, got_i = knn_point(k, xyz, qrs)
    want_d, want_i = knn_point_plain(k, xyz, qrs)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


# The batch-4 forward's 13 KNN calls: (sets, candidates, queries (None: the
# same set), k). RPN: the PointCNN's XConv / XDConv layers; RCNN: 400 crops.
KNN_MAIN_PATH = [
    (4, 16384, None, 8), (4, 4096, 1024, 8), (4, 1024, 256, 8), (4, 256, 64, 8),
    (4, 64, None, 8), (4, 64, 256, 8), (4, 256, 1024, 8), (4, 1024, 4096, 8),
    (4, 4096, 16384, 8),
    (400, 512, None, 4), (400, 512, 128, 8), (400, 128, 32, 12), (400, 32, 8, 12),
]


def _main_path_knn_inputs(b, n, p, device):
    """Points like the main path's: the RPN's over random_batch's volume,
    the RCNN's inside a car-sized crop whose first 400 points repeat (the
    crop's wrap). A query set is the candidates' first P points (an FPS
    subset) or the candidates are the queries' first N (XDConv)."""
    rng = np.random.default_rng(n * 7 + (p or 0))
    m = max(n, p or 0)
    if b == 400:
        pts = rng.uniform([-2, -1, -1], [2, 1, 1], (b, m, 3))
        if m > 400:
            pts[:, 400:] = pts[:, :m - 400]
    else:
        pts = rng.uniform(-40, 40, (b, m, 3))
        pts[..., 2] = np.abs(pts[..., 2]) + 1.0
    pts = torch.from_numpy(pts.astype(np.float32)).to(device)
    xyz = pts[:, :n].contiguous()
    return xyz, xyz if p is None else pts[:, :p].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["brute", "sorted"])
@pytest.mark.parametrize("b,n,p,k", KNN_MAIN_PATH)
def test_knn_arms_match_plain_at_main_path_shapes(cuda, b, n, p, k, arm):
    xyz, qrs = _main_path_knn_inputs(b, n, p, cuda)
    got_d, got_i = knn_point(k, xyz, qrs, arm=arm)
    want_d, want_i = knn_point_plain(k, xyz, qrs)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["brute", "sorted"])
@pytest.mark.parametrize("kind,b,n,p,k", [
    ("grid", 2, 700, None, 12),      # ties; N not a multiple of T
    ("grid", 1, 517, 77, 16),        # P not a multiple of 32
    ("dup", 2, 512, None, 4),
    ("dup", 1, 600, 45, 12),
    ("same", 1, 300, None, 16),      # identical points, extents 0
    ("same", 2, 20, 40, 1),          # N smaller than a tile
    ("line", 1, 400, None, 8),       # collinear
    ("line", 2, 257, 31, 12),
    ("grid", 1, 16, None, 16),       # k = N
    ("uniform", 2, 12, 5, 12),       # k = N, N not a multiple of T
    ("flat", 2, 5000, 1111, 8),
    ("huge", 2, 300, None, 8),       # inf distances, ties by index
    ("huge", 1, 700, 90, 12),
])
def test_knn_arms_match_plain_at_edge_cases(cuda, kind, b, n, p, k, arm):
    """The CPU file's edge cases (tests/test_torch_knn.py) on the card."""
    from tests.knn_mirror import cloud

    xyz = torch.from_numpy(cloud(kind, 0, b, n)).to(cuda)
    qrs = xyz if p is None else torch.from_numpy(cloud(kind, 1, b, p)).to(cuda)
    got_d, got_i = knn_point(k, xyz, qrs, arm=arm)
    want_d, want_i = knn_point_plain(k, xyz, qrs)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(300, 300), (100, 300)])
def test_knn_sorted_takes_equal_but_distinct_queries_as_another_set(cuda, n, p):
    """Only the same object is the same set: queries equal to the
    candidates but another tensor (as many, or more) are sorted apart."""
    from tests.knn_mirror import cloud

    xyz = torch.from_numpy(cloud("dup", 8, 2, n)).to(cuda)
    qrs = xyz.repeat(1, -(-p // n), 1)[:, :p].clone()
    assert grouping.knn_prep(xyz, qrs).qperm is not None
    got_d, got_i = grouping.knn_sorted(8, xyz, qrs)
    want_d, want_i = knn_point_plain(8, xyz, qrs)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "uniform", "grid", "line"])
def test_knn_sorted_visits_the_mirrors_pairs(cuda, kind):
    """The search kernel follows tests/knn_mirror.py's schedule: the same
    prepared points as the plain prep, bit for bit, and the same count of
    evaluated pairs, for the same set and for another query set."""
    from tests.knn_mirror import cloud, sorted_schedule

    xyz = torch.from_numpy(cloud(kind, 2, 2, 3000))
    for qrs in (xyz, torch.from_numpy(cloud(kind, 3, 2, 900))):
        want_d, want_i, want_v = sorted_schedule(8, xyz, qrs)
        cx = xyz.to(cuda)
        cq = cx if qrs is xyz else qrs.to(cuda)
        assert _prep_equal(grouping.knn_prep(cx, cq), grouping.knn_prep_plain(xyz, qrs))
        visited = torch.zeros(1, dtype=torch.int64, device=cuda)
        got_d, got_i = grouping.knn_sorted(8, cx, cq, visited=visited)
        assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_d.cpu(), want_d)
        assert int(visited) == want_v


def _prep_equal(got, want):
    """Two `KnnTiles` alike: the candidates bit for bit (their fourth word
    holds index bits, not a number), the rest by value."""
    if not torch.equal(got.cand.cpu().view(torch.int32), want.cand.view(torch.int32)):
        return False
    return all(w is None or torch.equal(g.cpu(), w) for g, w in zip(got[1:], want[1:]))


@pytest.mark.cuda
def test_knn_sorted_refuses_other_options(cuda):
    big = torch.rand(1, grouping.KNN_SORTED_MAX_POINTS + 1, 3, device=cuda)
    with pytest.raises(ValueError):
        grouping.knn_sorted(4, big, big)
    assert grouping.knn_arm(big.shape[1], big.shape[1]) == "brute"
    xyz = torch.rand(1, 100, 3, device=cuda)
    with pytest.raises(ValueError):
        grouping.knn_sorted(4, xyz, xyz, visited=torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(RuntimeError):
        grouping.knn_sorted(17, xyz, xyz)


@pytest.mark.cuda
@pytest.mark.parametrize("n,keep,thresh,masked", [(2000, 100, 0.5, False), (100, 100, 0.01, True)])
def test_nms_kernel_matches_plain(cuda, n, keep, thresh, masked):
    rng = np.random.default_rng(6)
    boxes = torch.from_numpy(_bev_boxes(rng, 4, n)).to(cuda)
    scores = torch.from_numpy(rng.uniform(0, 1, (4, n)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(4, n)) > 0.3).to(cuda) if masked else None
    got, _ = oriented_nms(boxes, scores, thresh, keep, valid)
    torch.testing.assert_close(got, oriented_nms_plain(boxes, scores, thresh, keep, valid),
                               rtol=0, atol=0)


# Every cluster size the FPS and NMS kernels take.
CLUSTERS = [1, 2, 4, 8, MAX_CLUSTER]

FPS_CASES = {
    "rpn_4x16384": (4, 16384, 4096, "uniform"),  # the main path's first call
    "cli_1x16384": (1, 16384, 4096, "uniform"),  # the KITTI CLI's batch 1
    "n16383": (2, 16383, 1024, "uniform"),       # not a multiple of C x threads
    "n5000": (2, 5000, 700, "uniform"),
    "n100": (3, 100, 100, "uniform"),            # fewer points than C x 32
    "npoint_above_n": (2, 20, 40, "uniform"),    # picks repeat once all are taken
    "rcnn_400x512": (400, 512, 128, "uniform"),
    "grid": (2, 3000, 500, "grid"),              # integer coordinates: exact ties
    "duplicates": (2, 2048, 600, "duplicates"),  # every point 7 times: zero distances
}


@functools.lru_cache(maxsize=None)
def _fps_case(name):
    """Points of an FPS case on the card and the plain version's picks."""
    b, n, npoint, kind = FPS_CASES[name]
    rng = np.random.default_rng(12)
    if kind == "duplicates":
        pts = np.repeat(_points(rng, b, -(-n // 7), False), 7, axis=1)[:, :n]
        pts = np.ascontiguousarray(pts[:, rng.permutation(n)])
    else:
        pts = _points(rng, b, n, kind == "grid")
    xyz = torch.from_numpy(pts).cuda()
    return xyz, npoint, farthest_point_sample_plain(xyz, npoint)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", list(FPS_CASES))
def test_fps_kernel_clusters_match_plain(cuda, case, cluster):
    """The FPS kernel with each set on a cluster of each size: picks bit for
    bit equal to the plain version's."""
    xyz, npoint, want = _fps_case(case)
    got = sampling._fps_kernel(xyz, npoint, cluster)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,threads", [
    (1, 160), (1, 320), (1, 1024), (4, 64), (4, 320), (4, 1024), (16, 32), (16, 96), (16, 320),
])
def test_fps_kernel_block_sizes_match_plain(cuda, cluster, threads):
    """Every points-a-thread template (1 to 32; z in shared memory from 8)
    through the block size the wrapper otherwise picks itself."""
    xyz, npoint, want = _fps_case("n5000")
    got = sampling._fps_kernel(xyz, npoint, cluster, threads)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


NMS_CASES = {
    # name: (frames, boxes, max_keep, thresh, scores, boxes kind, mask)
    "rpn_4x9000": (4, 9000, 100, 0.8, "uniform", "random", None),  # the RPN's call
    "final_4x100": (4, 100, 100, 0.01, "uniform", "random", "random"),  # the final NMS
    "equal_scores": (2, 700, 50, 0.5, "equal", "random", None),
    "identical_boxes": (2, 300, 20, 0.5, "uniform", "identical", None),  # one kept, -1 after
    "few_survive": (3, 40, 100, 0.1, "uniform", "random", None),  # -1 padding
    "one_box": (3, 1, 5, 0.5, "uniform", "random", None),
    "frame_without_valid": (3, 500, 30, 0.3, "uniform", "random", "frame 1 empty"),
    "thresh_0": (2, 500, 60, 0.0, "uniform", "random", None),
}


@functools.lru_cache(maxsize=None)
def _nms_case(name):
    """Boxes, scores and mask of an NMS case on the card and the plain
    version's keep list."""
    b, n, keep, thresh, score_kind, box_kind, mask = NMS_CASES[name]
    rng = np.random.default_rng(13)
    boxes = _bev_boxes(rng, b, n)
    if box_kind == "identical":
        boxes[:] = boxes[:, :1]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if score_kind == "equal":
        scores[:] = 0.5
    valid = None
    if mask is not None:
        valid = rng.uniform(size=(b, n)) > 0.3
        if mask == "frame 1 empty":
            valid[1] = False
        valid = torch.from_numpy(valid).cuda()
    args = (torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda(), thresh, keep, valid)
    return args, oriented_nms_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_kernel_clusters_match_plain(cuda, case, cluster):
    """The NMS kernel with each frame on a cluster of each size: keep lists
    bit for bit equal to the plain version's, -1 padding included."""
    args, want = _nms_case(case)
    got = nms_ops._nms_kernel(*args, cluster)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,threads", [(1, 1024), (2, 512), (4, 256), (8, 1024), (16, 64)])
def test_nms_kernel_block_sizes_match_plain(cuda, cluster, threads):
    """Several boxes a thread (up to 16), through the block size the
    wrapper otherwise picks itself, on the RPN's shape."""
    args, want = _nms_case("rpn_4x9000")
    got = nms_ops._nms_kernel(*args, cluster, threads)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_rpn_calls_run_on_clusters(cuda):
    """The RPN's FPS (4 x 16384) and NMS (4 x 9000) spread each set over a
    cluster of more than one CTA, one the card can schedule; the RCNN's 400
    sets and the final NMS's 100 boxes keep one CTA each."""
    sms = sm_count(cuda)
    fps_fits = lambda n: lambda c, t: sampling.fps_clusters(n, c, t) > 0  # noqa: E731
    nms_fits = lambda n: lambda c, t: nms_ops.nms_clusters(n, c, t) > 0  # noqa: E731
    assert sampling.fps_plan(4, 16384, sms, fps_fits(16384))[0] > 1
    assert nms_ops.nms_plan(4, 9000, sms, nms_fits(9000))[0] > 1
    assert sampling.fps_plan(400, 512, sms, fps_fits(512))[0] == 1
    assert nms_ops.nms_plan(4, 100, sms, nms_fits(100))[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [3, 32])
def test_cluster_kernels_refuse_other_sizes(cuda, cluster):
    """A cluster size the kernels do not take raises; nothing retries with
    another size or falls back to the plain version."""
    xyz, npoint, _ = _fps_case("n5000")
    with pytest.raises(RuntimeError):
        sampling._fps_kernel(xyz, npoint, cluster)
    args, _ = _nms_case("equal_scores")
    with pytest.raises(RuntimeError):
        nms_ops._nms_kernel(*args, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("k,cf,cp,d,with_x", [(8, 64, 1, 256, True), (12, 128, 40, 512, False)])
def test_xconv_kernel_matches_plain(cuda, k, cf, cp, d, with_x):
    rng = np.random.default_rng(7)
    b, n, p = 2, 300, 100
    params = _xconv_params(rng, k, cf, cf + cp, 2, d)
    w = _torch_weights(params, with_x)
    for f in w.__dataclass_fields__:
        if getattr(w, f) is not None:
            setattr(w, f, getattr(w, f).to(cuda))
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(cuda)
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32)).to(cuda)
    fts = torch.from_numpy(rng.standard_normal((b, n, cp)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32)).to(cuda)
    torch.testing.assert_close(fused_xconv(pts, fts, qrs, idx, w),
                               fused_xconv_plain(pts, fts, qrs, idx, w), rtol=1e-4, atol=1e-4)



@pytest.mark.cuda
@pytest.mark.parametrize("k,cf,cp,d,b,p,with_x,fscale", [
    (4, 128, 512, 512, 2, 300, True, 1.0),      # K = 4, the RCNN's first layer
    (8, 64, 256, 256, 2, 200, False, 1.0),      # K = 8 without the X-transform
    (12, 128, 512, 1024, 1, 150, True, 1.0),    # K = 12, D = 1024
    (12, 256, 1280, 1024, 1, 100, True, 1.0),   # Cf 256, Cin 1536, contraction 18432
    (8, 256, 1280, 1024, 4, 64, True, 1.0),     # few queries: the split path
    (8, 128, 512, 1024, 2, 128, False, 1.0),    # the split path without X
    (8, 64, 3, 132, 1, 70, False, 1.0),         # Cp % 4 != 0, D not a multiple of 128
    (8, 64, 64, 256, 2, 100, True, 1e3),        # features x 1e3, Wc x 1e-3
])
def test_xconv_kernel_shapes_match_plain(cuda, k, cf, cp, d, b, p, with_x, fscale):
    """The tensor-core XConv against the plain version within 1e-4 + 1e-4
    |plain| (3xTF32 products, FP32 sums in another order), at each K, the
    widest Cf / Cin / D, the few-query split path and large features. The
    large-feature case scales Wc down as much, so the outputs keep the
    gate's scale (as the conv card test does). Wc is scaled as He's init
    scales a weight, to std 1 / sqrt(K Cin): with `_xconv_params`' Cin-blind
    scale the K = 12 cases reach pre-activations near 1e3, where the gate's
    absolute 1e-4 is about one FP32 ulp and the plain FP32 version is
    itself 4.7e-4 off the exact sum."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    n = 400
    params = _xconv_params(rng, k, cf, cf + cp, 2, d)
    w = _torch_weights(params, with_x)
    w.wc = w.wc / (w.wc.std() * np.sqrt(k * (cf + cp)) * fscale)
    for f in w.__dataclass_fields__:
        if getattr(w, f) is not None:
            setattr(w, f, getattr(w, f).to(cuda))
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(cuda)
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32)).to(cuda)
    fts = torch.from_numpy((rng.standard_normal((b, n, cp)) * fscale).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32)).to(cuda)
    splits = plan_xconv(b * p, k, cf, cp, d, torch.cuda.get_device_properties(cuda)
                        .multi_processor_count).splits
    before = XCONV_EPILOGUE_KERNEL.launches
    got = fused_xconv(pts, fts, qrs, idx, w)
    torch.cuda.synchronize()
    assert XCONV_EPILOGUE_KERNEL.launches - before == (1 if splits > 1 else 0)
    if b * p <= 256:
        assert splits > 1
    want = fused_xconv_plain(pts, fts, qrs, idx, w)
    assert got.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= 1e-4 + 1e-4 * want.abs()).all()), float(err.max())

def _conv_case(rng, cuda, b, cin, cout, h, w, transpose, xscale=1.0):
    x = (rng.standard_normal((b, cin, h, w)) * xscale).astype(np.float32)
    wshape = (cin, cout, 3, 3) if transpose else (cout, cin, 3, 3)
    wt = (rng.standard_normal(wshape) * np.sqrt(2.0 / (9 * cin)) / xscale).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(cuda) for a in (x, wt, scale, shift)]


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convt"])
@pytest.mark.parametrize("b,cin,cout,h,w,xscale", [
    (2, 3, 32, 45, 151, 1.0),     # odd H and W, the first VGG layer's Cin
    (1, 40, 20, 5, 7, 1.0),       # C not a multiple of 32 or 128, tiny odd map
    (2, 256, 128, 23, 75, 1.0),   # wide channels, odd map (a 45x150 pool level)
    (1, 64, 64, 90, 300, 1.0),
    (1, 256, 256, 45, 150, 1.0),  # Cout 256 at K = 2304
    (1, 512, 64, 23, 75, 1.0),    # Cin 512, K = 4608
    (3, 7, 100, 3, 5, 1.0),       # M = 15 pixels a frame, Cin < 8, Cout not a multiple of 8
    (4, 256, 128, 45, 150, 1.0),  # the main path's widest transposed conv, batch 4
    (2, 128, 64, 23, 75, 1e3),    # inputs x 1e3 (weights / 1e3): the split's small part
])
def test_conv_kernels_match_plain(cuda, transpose, b, cin, cout, h, w, xscale):
    """Kernel vs plain within 1e-4 + 1e-4 |plain|. The large-input case
    scales the weights down by as much, so the output keeps the gate's
    scale: with outputs near 1e3 the absolute 1e-4 is about one FP32 ulp of
    the partial sums (6.1e-5 to 1.2e-4 between 512 and 2048), which any
    summation order other than cuDNN's can miss on outputs near zero."""
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, shift = _conv_case(np.random.default_rng(8), cuda, b, cin, cout, h, w, transpose,
                                     xscale)
    if transpose:
        got = convtranspose3x3_affine_relu(x, wt, scale, shift)
        want = convtranspose3x3_affine_relu_plain(x, wt, scale, shift)
    else:
        got = conv3x3_affine_relu(x, wt, scale, shift)
        want = conv3x3_affine_relu_plain(x, wt, scale, shift)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,nb,r", [(4, 16384, 544, 400, 512), (4, 16384, 288, 400, 512),
                                        (2, 300, 36, 7, 50), (1, 64, 4, 3, 33)])
def test_crop_gather_kernel_matches_plain(cuda, b, n, c, nb, r):
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, (nb, r)).astype(np.int32)).to(cuda)
    box_ind = torch.from_numpy(np.sort(rng.integers(0, b, nb)).astype(np.int32)).to(cuda)
    torch.testing.assert_close(crop_gather(src, idx, box_ind), crop_gather_plain(src, idx, box_ind),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_crop_gather_kernel_refuses_ragged_rows(cuda):
    src = torch.zeros((1, 8, 33), device=cuda)
    idx = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        crop_gather(src, idx, torch.zeros(1, dtype=torch.int32, device=cuda))


def _crop_data(rng, b, n, nb, r, data):
    """idx (nb, r) and box_ind (nb,) as numpy int64: "recorded" like the main
    path's call under random weights (nine boxes in ten empty, so all their
    rows index 0; the rest wrap a few members), "distinct" uniform over the
    source, "unsorted" uniform with box_ind in no order."""
    box_ind = np.sort(rng.integers(0, b, nb))
    if data == "recorded":
        idx = np.zeros((nb, r), np.int64)
        for i in np.flatnonzero(rng.uniform(size=nb) < 0.1):
            members = np.sort(rng.choice(n, int(rng.integers(1, 2 * r)), replace=False))[:r]
            idx[i] = members[np.arange(r) % len(members)]
    else:
        idx = rng.integers(0, n, (nb, r))
        if data == "unsorted":
            box_ind = rng.integers(0, b, nb)
    return idx, box_ind


def _crop_rows(case):
    """Rows a box for the card cases: one block's rows (crop.cu's kRows, 32)
    plus one, or one and a half blocks' plus three."""
    return {"block+1": 33, "ragged": 51}.get(case, case)


# (B, N, C, Nb, R, data, idx dtype, box_ind dtype): the main path's call
# recorded-like and all-distinct, R of 1, of one block's rows (32) plus one
# and of no multiple of them, rows of one 16-byte vector (C 4 in float32, 8 in
# bf16: "vec"), unsorted box_ind, int32 and int64 indices, and 70,000 boxes
# (beyond a grid dimension's 65,535).
CROP_CASES = [
    (4, 16384, 288, 400, 512, "recorded", torch.int32, torch.int64),
    (4, 16384, 288, 400, 512, "distinct", torch.int32, torch.int64),
    (2, 300, 40, 7, 1, "distinct", torch.int64, torch.int64),
    (2, 300, 40, 7, "block+1", "distinct", torch.int32, torch.int32),
    (3, 500, 288, 5, "ragged", "distinct", torch.int64, torch.int32),
    (1, 64, "vec", 3, 33, "distinct", torch.int32, torch.int32),
    (2, 100, "vec", 9, 70, "unsorted", torch.int64, torch.int64),
    (4, 2000, 288, 60, 512, "unsorted", torch.int32, torch.int64),
    (4, 1000, 16, 70000, 8, "distinct", torch.int32, torch.int64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("b,n,c,nb,r,data,idx_dtype,box_dtype", CROP_CASES)
def test_crop_gather_kernel_cases_match_plain(cuda, dtype, b, n, c, nb, r, data, idx_dtype,
                                              box_dtype):
    """Each entry of crop.cu against crop_gather_plain, bit for bit, with
    exactly one launch of its kernel (no cast kernel: the indices go in as
    they are)."""
    from heterofusionrcnn_torch.ops.cropping import CROP_BF16_KERNEL, CROP_KERNEL

    size = 4 if dtype == torch.float32 else 2
    c = 16 // size if c == "vec" else c
    r = _crop_rows(r)
    rng = np.random.default_rng(10)
    idx, box_ind = _crop_data(rng, b, n, nb, r, data)
    src = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda).to(dtype)
    idx = torch.from_numpy(idx).to(cuda, idx_dtype)
    box_ind = torch.from_numpy(box_ind).to(cuda, box_dtype)
    kernel = CROP_KERNEL if dtype == torch.float32 else CROP_BF16_KERNEL
    before = kernel.launches
    got = crop_gather(src, idx, box_ind)
    assert kernel.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (nb, r, c)
    assert torch.equal(got, crop_gather_plain(src, idx, box_ind))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_crop_op_launches_one_kernel(cuda, dtype):
    """The op on the main path's index dtypes (int32 idx, int64 box_ind)
    launches the crop kernel and nothing else (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    idx, box_ind = _crop_data(rng, 4, 2000, 40, 512, "recorded")
    src = torch.from_numpy(rng.standard_normal((4, 2000, 288)).astype(np.float32))
    src, idx, box_ind = src.to(cuda, dtype), torch.from_numpy(idx).to(cuda, torch.int32), \
        torch.from_numpy(box_ind).to(cuda)
    crop_gather(src, idx, box_ind)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            crop_gather(src, idx, box_ind)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    assert len(kernels) == 1 and "crop_gather_kernel" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 3


# The bf16 forms (compute_dtype "bfloat16"): each kernel against its plain
# bf16 version, which rounds at the same points. Tolerance: 2^-7 |plain| (two
# bf16 ulps where the spacing is finest, one where it is coarsest: a float32
# sum in another order rounds to the neighbouring bf16 value) plus 2^-8 of
# the output's largest magnitude (one ulp there: an intermediate rounding to
# bf16 that flips, its float32 input computed another way, ahead of a shift
# that cancels the result to about 0). The crop gather is a copy: bit for bit.


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * w.abs() + 2.0 ** -8 * float(w.abs().max())
    assert bool(((g - w).abs() <= bound).all()), float(((g - w).abs() - bound).max())
    assert bool(torch.isfinite(g).all())


def _xconv_bf16_case(rng, cuda, k, cf, cp, d, b, p, with_x, n=400):
    params = _xconv_params(rng, k, cf, cf + cp, 2, d)
    w = _torch_weights(params, with_x)
    w.wc = w.wc / (w.wc.std() * np.sqrt(k * (cf + cp)))
    for f in w.__dataclass_fields__:
        if getattr(w, f) is not None:
            setattr(w, f, getattr(w, f).to(cuda))
    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    fts = f32(b, n, cp).to(torch.bfloat16) if cp else None
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32)).to(cuda)
    return f32(b, n, 3), fts, f32(b, p, 3), idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("k,cf,cp,d,b,p,with_x", [
    (4, 128, 544, 512, 2, 300, True),      # K = 4, the RCNN's first layer (Cp % 16 == 0)
    (8, 64, 1, 256, 2, 300, True),         # the RPN's first layer: 1 feature (scalar gather)
    (8, 64, 256, 256, 2, 200, False),      # K = 8 without the X-transform
    (12, 128, 512, 1024, 1, 150, True),    # K = 12, D = 1024
    (12, 256, 1280, 1024, 1, 100, True),   # Cf 256, Cin 1536
    (8, 256, 1024, 1024, 4, 64, True),     # few queries: the split path
    (8, 64, 0, 132, 1, 70, False),         # no features, D not a multiple of 128
    (8, 64, 20, 256, 2, 100, True),        # Cp % 8 != 0
    (4, 64, 32, 256, 1, 130, True),        # K = 4, D 256: consumer tiles of 128, h kept
    (4, 32, 0, 1024, 1, 200, True),        # K = 4, Cp = 0, a cluster of 2
    (4, 128, 544, 1024, 1, 50, True),      # K = 4, a cluster of 2 and splits
    (8, 128, 512, 512, 2, 333, True),      # K = 8, D 512, h recomputed, ragged queries
    (8, 64, 256, 512, 1, 500, True),       # K = 8, D 512, h kept
    (8, 128, 512, 1024, 4, 64, False),     # K = 8, a cluster of 2, splits, without X
    (12, 64, 100, 256, 1, 97, True),       # K = 12, D 256, ragged queries
    (12, 128, 512, 512, 1, 90, False),     # K = 12, D 512, without X
    (12, 256, 0, 1024, 2, 40, True),       # K = 12, Cp = 0, a cluster of 2 and splits
])
def test_xconv_bf16_kernel_matches_plain(cuda, k, cf, cp, d, b, p, with_x):
    from heterofusionrcnn_torch.ops.xconv import XCONV_BF16_KERNEL, XCONV_EPILOGUE_BF16_KERNEL
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, fts, qrs, idx, w = _xconv_bf16_case(np.random.default_rng(13), cuda, k, cf, cp, d, b, p,
                                             with_x)
    splits = plan_xconv(b * p, k, cf, cp, d, sm_count(cuda), torch.bfloat16).splits
    before = XCONV_BF16_KERNEL.launches, XCONV_EPILOGUE_BF16_KERNEL.launches
    got = fused_xconv(pts, fts, qrs, idx, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert (XCONV_BF16_KERNEL.launches - before[0],
            XCONV_EPILOGUE_BF16_KERNEL.launches - before[1]) == (1, int(splits > 1))
    _bf16_close(got, fused_xconv_plain(pts, fts, qrs, idx, w, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convt"])
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (2, 3, 32, 45, 151),      # odd H and W, the first VGG layer's Cin
    (1, 40, 20, 5, 7),        # C not a multiple of 16, tiny odd map
    (2, 256, 128, 23, 75),    # wide channels, odd map
    (1, 64, 64, 90, 300),
    (1, 512, 64, 23, 75),     # Cin 512, K = 4608
    (3, 7, 100, 3, 5),        # 15 pixels a frame, Cout not a multiple of 8
    (2, 32, 32, 37, 150),     # W 150: an NCHW row pitch of 300 bytes
    (1, 7, 20, 19, 151),      # Cin 7 (padded to 8), W 151
    (1, 40, 100, 12, 75),     # Cin 40 (a zero-filled channel group), Cout 100
    (2, 128, 256, 17, 150),   # two Cout tiles of 128 (the transposed conv: four of 64)
    (1, 3, 20, 64, 128),      # whole 64-column tiles, no ragged edge
])
def test_conv_bf16_kernels_match_plain(cuda, layout, transpose, b, cin, cout, h, w):
    """Each bf16 kernel against its plain version on NCHW and channels-last
    inputs; the output channels-last either way, one launch a call."""
    from heterofusionrcnn_torch.ops.conv import CONV_BF16_KERNEL, CONVT_BF16_KERNEL
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, shift = _conv_case(np.random.default_rng(8), cuda, b, cin, cout, h, w, transpose)
    x = x.to(torch.bfloat16)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    kernel = CONVT_BF16_KERNEL if transpose else CONV_BF16_KERNEL
    before = kernel.launches
    if transpose:
        got = convtranspose3x3_affine_relu(x, wt, scale, shift)
        want = convtranspose3x3_affine_relu_plain(x, wt, scale, shift)
    else:
        got = conv3x3_affine_relu(x, wt, scale, shift)
        want = conv3x3_affine_relu_plain(x, wt, scale, shift)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convt"])
def test_conv_bf16_follows_in_place_weight_update(cuda, transpose):
    """The bf16 kernels' weight operand is arranged once per weight
    version: after an in-place update of the weight the next call computes
    with the new weight."""
    rng = np.random.default_rng(15)
    x, wt, scale, shift = _conv_case(rng, cuda, 2, 40, 36, 21, 70, transpose)
    x = x.to(torch.bfloat16)
    fn, plain = ((convtranspose3x3_affine_relu, convtranspose3x3_affine_relu_plain) if transpose
                 else (conv3x3_affine_relu, conv3x3_affine_relu_plain))
    first = fn(x, wt, scale, shift)
    _bf16_close(first, plain(x, wt, scale, shift))
    with torch.no_grad():
        wt.add_(torch.from_numpy(rng.standard_normal(wt.shape).astype(np.float32)).to(cuda)
                * float(wt.std()))
    second = fn(x, wt, scale, shift)
    torch.cuda.synchronize()
    _bf16_close(second, plain(x, wt, scale, shift))
    assert not torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,nb,r", [(4, 16384, 288, 400, 512), (2, 300, 40, 7, 50),
                                        (1, 64, 8, 3, 33)])
def test_crop_gather_bf16_kernel_matches_plain(cuda, b, n, c, nb, r):
    from heterofusionrcnn_torch.ops.cropping import CROP_BF16_KERNEL
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda)
    src = src.to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, n, (nb, r)).astype(np.int32)).to(cuda)
    box_ind = torch.from_numpy(np.sort(rng.integers(0, b, nb)).astype(np.int32)).to(cuda)
    before = CROP_BF16_KERNEL.launches
    got = crop_gather(src, idx, box_ind)
    assert CROP_BF16_KERNEL.launches == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got, crop_gather_plain(src, idx, box_ind), rtol=0, atol=0)
    with pytest.raises(ValueError):  # bf16 rows of C % 8 != 0 are not whole vectors
        crop_gather(src[..., :c - 4].contiguous(), idx, box_ind)


def _bf16_op_cases(cuda):
    rng = np.random.default_rng(14)
    pts, fts, qrs, idx, w = _xconv_bf16_case(rng, cuda, 8, 64, 72, 256, 2, 100, True, n=300)
    ws = [getattr(w, f) for f in w.__dataclass_fields__]
    x, wt, scale, shift = _conv_case(rng, cuda, 2, 40, 20, 15, 21, False)
    xt, wtt, scale_t, shift_t = _conv_case(rng, cuda, 2, 40, 20, 15, 21, True)
    crop_idx = torch.from_numpy(rng.integers(0, 400, (10, 64)).astype(np.int32)).to(cuda)
    box_ind = torch.from_numpy(np.sort(rng.integers(0, 2, 10)).astype(np.int32)).to(cuda)
    src = torch.from_numpy(rng.standard_normal((2, 400, 40)).astype(np.float32)).to(cuda)
    partial = torch.from_numpy(rng.standard_normal((4, 300, 256)).astype(np.float32)).to(cuda)
    return {
        "fused_xconv": (pts, fts, qrs, idx, ws, torch.bfloat16),
        "xconv_split_epilogue": (partial, w.sc, w.bc, torch.bfloat16),
        "crop_gather": (src.to(torch.bfloat16), crop_idx, box_ind),
        "conv3x3_affine_relu": (x.to(torch.bfloat16), wt, scale, shift, True),
        "convtranspose3x3_affine_relu": (xt.to(torch.bfloat16), wtt, scale_t, shift_t, True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_xconv", "xconv_split_epilogue", "crop_gather",
                                  "conv3x3_affine_relu", "convtranspose3x3_affine_relu"])
def test_bf16_ops_fake_functions_match_the_card(cuda, name):
    """Each op's bf16 form on the card gives bf16 outputs, of the dtype and
    shape its fake function gives for the same inputs under torch.export's
    fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _bf16_op_cases(cuda)[name]
    op = getattr(torch.ops.hfr, name)
    got = op(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_cuda
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [None if t is None else mode.from_tensor(t) for t in a]
                     if isinstance(a, list) else a for a in args]
        fake = op(*fake_args)
    assert (fake.dtype, tuple(fake.shape), fake.device.type) == (got.dtype, tuple(got.shape),
                                                                  "cuda")


# The training path on the card: rpn_unittest on the fixture frames, batch
# 2, dropout and path drop off. Tolerances as tests/test_torch_training.py:
# losses rtol 1e-4 / atol 1e-5; gradients and parameters after a step rtol
# 1e-3 / atol 1e-5. Adam moves an element by about the learning rate times
# the sign of its gradient, so where the card's and the CPU's gradients (the
# step's own, read back from Adam's first moment; a second backward on the
# card need not repeat the step's rounding, since its scatter-adds use
# atomics) agree only within the absolute part of that tolerance (rounding noise of
# two summation orders: the biases that a training BatchNorm follows, whose
# gradient is 0 in exact arithmetic, and elements of a tiny gradient) the
# updated element is held within 2 x lr more; every other one at 1e-3 / 1e-5.


def _train_setup(pc_sample_pts=None):
    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights

    cfg = common.resolve_config("rpn_unittest")
    lc = cfg.model_config.layers_config
    for fc in lc.rpn_fc_layers + lc.pc_pointcnn.fc_layers:
        fc.dropout_rate = 0.0
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    if pc_sample_pts:
        cfg.model_config.input_config.pc_sample_pts = pc_sample_pts
    dataset = common.build_dataset(cfg, "train")
    dataset.seed(0)
    batch = common.make_batch_fn(cfg, dataset, "rpn", 2)()
    model, loss_fn = common.build_model(cfg, dataset, "train")
    return cfg, init_weights(model, 0), loss_fn, {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_step(cfg, model, loss_fn, batch, device):
    """One train step from a fresh Adam: the metrics, the module's state
    dict, and the step's own clipped gradient by name (Adam's first moment
    after one step from zero is (1 - b1) times it)."""
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1, build_optimizer
    from heterofusionrcnn_torch.runtime.train_state import TrainState, make_rpn_train_step

    model = model.to(device)
    opt = build_optimizer(model, cfg.train_config.optimizer, 1, cfg.train_config.grad_clip_norm)
    metrics = make_rpn_train_step(loss_fn)(TrainState.create(model, opt),
                                           {k: v.to(device) for k, v in batch.items()})
    grads = {n: (mu / (1 - ADAM_B1)).cpu() for n, mu in opt.state_dict()["state"]["mu"].items()}
    return {k: float(v) for k, v in metrics.items()}, model.state_dict(), grads


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One train step (forward in training, loss, backward, clip, Adam,
    BatchNorm statistics) on the card and on the CPU from the same weights:
    the losses, the step's gradients and the updated state."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg, model, loss_fn, batch = _train_setup()
    want_l, want, want_g = _train_step(cfg, copy.deepcopy(model), loss_fn, batch, "cpu")
    got_l, got, got_g = _train_step(cfg, model, loss_fn, batch, cuda)
    for key, val in want_l.items():
        assert got_l[key] == pytest.approx(val, rel=1e-4, abs=1e-5), key
    for name, g in want_g.items():
        torch.testing.assert_close(got_g[name], g, rtol=1e-3, atol=1e-5, msg=name)
    lr = cfg.train_config.optimizer.initial_learning_rate
    for name, val in want.items():
        if not val.is_floating_point():
            continue
        tol = 1e-5 + 1e-3 * val.abs()
        if name in want_g:
            tol = tol + 2 * lr * ((got_g[name] - want_g[name]).abs() > 1e-3 * want_g[name].abs())
        assert bool(((got[name].cpu() - val).abs() <= tol).all()), (
            name, float(((got[name].cpu() - val).abs() - tol).max()))


def _rcnn_step(cfg, model, loss_fn, batch, device):
    """One RCNN train step from a fresh Adam: as `_train_step`."""
    from heterofusionrcnn_torch.experiments.common import make_rcnn_train_step
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1, build_optimizer
    from heterofusionrcnn_torch.runtime.train_state import TrainState

    model = model.to(device)
    opt = build_optimizer(model, cfg.train_config.optimizer, 1, cfg.train_config.grad_clip_norm)
    metrics = make_rcnn_train_step(loss_fn)(TrainState.create(model, opt),
                                            {k: v.to(device) for k, v in batch.items()})
    grads = {n: (mu / (1 - ADAM_B1)).cpu() for n, mu in opt.state_dict()["state"]["mu"].items()}
    return {k: float(v) for k, v in metrics.items()}, model.state_dict(), grads


@pytest.mark.cuda
def test_rcnn_train_step_on_card_matches_cpu(cuda, tmp_path):
    """One RCNN train step (rcnn_unittest, batch 2 of 16 RoIs from a
    synthetic handoff over the fixture frames, dropout and path drop off)
    on the card and on the CPU from the same weights: the losses, the
    step's gradients (tests/rcnn_fixtures.py `grads_agree`) and the updated
    state, widened by 2 x lr where the gradients agree only within the
    absolute part of that tolerance."""
    import copy

    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from tests.rcnn_fixtures import grads_agree, write_handoff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = common.resolve_config("rcnn_unittest")
    lc = cfg.model_config.layers_config
    for fc in lc.rcnn_mlp_layers + lc.rcnn_fc_layers + lc.rcnn_pc_pointcnn.fc_layers:
        fc.dropout_rate = 0.0
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    dataset = common.build_dataset(cfg, "train")
    dataset.seed(0)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = write_handoff(
        dataset, str(tmp_path))
    batch = {k: torch.from_numpy(v)
             for k, v in common.make_batch_fn(cfg, dataset, "rcnn", 2)().items()}
    model, loss_fn = common.build_model(cfg, dataset, "train")
    init_weights(model, 0)
    want_l, want, want_g = _rcnn_step(cfg, copy.deepcopy(model), loss_fn, batch, "cpu")
    got_l, got, got_g = _rcnn_step(cfg, model, loss_fn, batch, cuda)
    assert want_l["rcnn_reg_loss"] > 0
    for key, val in want_l.items():
        assert got_l[key] == pytest.approx(val, rel=1e-4, abs=1e-5), key
    for name, g in want_g.items():
        assert grads_agree(got_g[name], g, name), (name, float((got_g[name] - g).abs().max()))
    lr = cfg.train_config.optimizer.initial_learning_rate
    for name, val in want.items():
        if not val.is_floating_point():
            continue
        tol = 1e-5 + 1e-3 * val.abs()
        if name in want_g:
            tol = tol + 2 * lr * ((got_g[name] - want_g[name]).abs() > 1e-3 * want_g[name].abs())
        assert bool(((got[name].cpu() - val).abs() <= tol).all()), (
            name, float(((got[name].cpu() - val).abs() - tol).max()))


@pytest.mark.cuda
def test_rpn_evaluator_frame_on_card_matches_cpu(cuda, tmp_path):
    """`RpnEvaluator` on one fixture train frame (rpn_unittest, val mode,
    features saved) on the card and on the CPU from the same weights: the
    proposals within 1e-3 (%.3f rows), the IoU table and the feature file
    within 1e-4, the ledgers within 1e-4. The proposal head is scaled by
    0.1 so every decoded box has a positive size (tests/
    test_torch_evaluator.py)."""
    import glob
    import os

    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.runtime.evaluator import RpnEvaluator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = common.resolve_config("rpn_unittest")
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    roots = []
    for i, device in enumerate(("cpu", cuda)):
        dataset = common.build_dataset(cfg, "val", "train")
        dataset.sample_list = dataset.sample_list[:1]
        dataset.num_samples = 1
        model, _ = common.build_model(cfg, dataset, "val", save_rpn_feature=True)
        init_weights(model, 0)
        with torch.no_grad():
            model.fc_output.Dense_0.weight.mul_(0.1)
            model.fc_output.Dense_0.bias.mul_(0.1)
        root = str(tmp_path / str(i))
        RpnEvaluator(model.to(device), dataset, cfg, root,
                     save_rpn_feature=True).run_checkpoint_once(None, 7)
        roots.append(os.path.join(root, "rpn_unittest", "predictions"))
    for pattern, atol in (("proposals_and_scores/train/7/*.txt", 1e-3 + 1e-6),
                          ("proposals_iou/train/7/*.txt", 1e-4),
                          ("rpn_feature/train/7/*.npy", 1e-4),
                          ("rpn_avg_losses.csv", 1e-4), ("rpn_avg_seg_acc.csv", 1e-4),
                          ("rpn_total_recall.csv", 1e-4)):
        files = [sorted(glob.glob(os.path.join(r, pattern))) for r in roots]
        assert len(files[0]) == len(files[1]) == 1, pattern
        load = (np.load if pattern.endswith(".npy") else
                lambda p: np.loadtxt(p, ndmin=2, delimiter="," if p.endswith(".csv") else None))
        want, got = (load(f[0]) for f in files)
        assert got.shape == want.shape, pattern
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=pattern)


@pytest.mark.cuda
@pytest.mark.parametrize("n,image", [(5, False), (16, False), (2, True)])
def test_batchnorm_training_on_card_matches_cpu(cuda, n, image):
    """Train-mode BatchNorm (flax's biased variance, momentum 0.99): output,
    gradients and running statistics on the card as on the CPU."""
    from heterofusionrcnn_torch.models.extractors.layers import BatchNorm, BatchNorm2d

    rng = np.random.default_rng(n)
    c = 6
    x = torch.from_numpy((rng.standard_normal((n, c, 3, 3) if image else (n, c)) * 2 + 1)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    out = []
    for device in ("cpu", cuda):
        bn = (BatchNorm2d(c) if image else BatchNorm(c)).to(device).train()
        with torch.no_grad():
            bn.weight.copy_(scale)
            bn.running_var.fill_(0.7)
        xt = x.detach().to(device).requires_grad_()
        y = bn(xt)
        (y * y).sum().backward()
        out.append([t.detach().cpu() for t in (y, xt.grad, bn.weight.grad, bn.running_mean,
                                               bn.running_var)])
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_train_step_kernel_calls_match_plain(cuda, monkeypatch):
    """Every FPS and KNN call of one train step (4096 points, so both KNN
    arms run) bit for bit against the plain version, and the step launches
    no fused XConv and no NMS."""
    from heterofusionrcnn_torch.models.extractors import pointcnn
    from heterofusionrcnn_torch.ops.nms import NMS_KERNEL
    from heterofusionrcnn_torch.ops.xconv import XCONV_KERNEL

    calls = {"knn": [], "fps": []}

    def recorder(name, fn):
        def rec(*args):
            calls[name].append(args)
            return fn(*args)
        return rec

    monkeypatch.setattr(pointcnn, "knn_point", recorder("knn", pointcnn.knn_point))
    monkeypatch.setattr(pointcnn, "farthest_point_sample",
                        recorder("fps", pointcnn.farthest_point_sample))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, loss_fn, batch = _train_setup(pc_sample_pts=4096)
    before = (XCONV_KERNEL.launches, NMS_KERNEL.launches)
    _train_step(cfg, model, loss_fn, batch, cuda)
    assert (XCONV_KERNEL.launches, NMS_KERNEL.launches) == before
    arms = {grouping.knn_arm(xyz.shape[1], qrs.shape[1]) for _, xyz, qrs in calls["knn"]}
    assert arms == {"brute", "sorted"} and calls["fps"]
    for k, xyz, qrs in calls["knn"]:
        for got, want in zip(knn_point(k, xyz, qrs), knn_point_plain(k, xyz, qrs)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    for xyz, npoint in calls["fps"]:
        torch.testing.assert_close(farthest_point_sample(xyz, npoint),
                                   farthest_point_sample_plain(xyz, npoint), rtol=0, atol=0)


@pytest.mark.cuda
def test_xconv_eval_with_grad_launches_or_raises(cuda):
    """An eval-mode XConv on the card launches the fused kernel under
    no_grad and where autograd has nothing to differentiate, and raises,
    launching nothing, where autograd would differentiate its parameters:
    it never leaves the kernel for the layer-by-layer path."""
    from heterofusionrcnn_torch.models.extractors.pointcnn import XConv
    from heterofusionrcnn_torch.ops.xconv import XCONV_KERNEL

    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.standard_normal((2, 256, 3)).astype(np.float32)).to(cuda)
    fts = torch.from_numpy(rng.standard_normal((2, 256, 8)).astype(np.float32)).to(cuda)
    qrs = pts[:, :64]
    mod = XConv(8, 1, 64, 32, 8, 2).to(cuda).eval()
    before = XCONV_KERNEL.launches
    with torch.no_grad():
        mod(pts, fts, qrs)
    assert XCONV_KERNEL.launches == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        mod(pts, fts, qrs)
    assert XCONV_KERNEL.launches == before + 1
    mod.requires_grad_(False)
    mod(pts, fts, qrs)
    assert XCONV_KERNEL.launches == before + 2


# The custom ops (`torch.ops.hfr`, ops/library.py): each one on CUDA tensors
# launches its kernel, on the same inputs on the CPU runs its plain version;
# the two agree within the kernel's tolerance (module docstring). Inputs on
# two devices raise.


def _op_case(name, cuda):
    """(args on the card, the kernel counters that must rise, tolerance)."""
    rng = np.random.default_rng(12)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    if name in ("knn", "knn_sorted"):
        xyz = torch.from_numpy(_points(rng, 2, 5000, False)).to(cuda)
        if name == "knn_sorted":
            return (xyz, xyz, 8, True, "sorted"), (grouping.KNN_KERNEL,
                                                   grouping.KNN_PREP_KERNEL), 0.0
        return (xyz, xyz, 8, True, "brute"), (grouping.KNN_KERNEL,), 0.0
    if name == "farthest_point_sample":
        return (f32(2, 3000, 3), 256), (sampling.FPS_KERNEL,), 0.0
    if name == "oriented_nms":
        bev = torch.from_numpy(_bev_boxes(rng, 2, 500)).to(cuda)
        return (bev, f32(2, 500), 0.5, 50, f32(2, 500) > -0.5), (nms_ops.NMS_KERNEL,), 0.0
    if name == "fused_xconv":
        w = _torch_weights(_xconv_params(rng, 8, 64, 64 + 8, 2, 256), True)
        ws = [None if getattr(w, f) is None else getattr(w, f).to(cuda)
              for f in w.__dataclass_fields__]
        idx = torch.from_numpy(rng.integers(0, 300, (2, 100, 8)).astype(np.int32)).to(cuda)
        from heterofusionrcnn_torch.ops.xconv import XCONV_KERNEL
        return (f32(2, 300, 3), f32(2, 300, 8), f32(2, 100, 3), idx, ws), (XCONV_KERNEL,), 1e-4
    if name == "xconv_split_epilogue":
        return (f32(4, 300, 256), f32(256), f32(256)), (XCONV_EPILOGUE_KERNEL,), 1e-4
    if name == "crop_gather":
        idx = torch.from_numpy(rng.integers(0, 400, (10, 64)).astype(np.int32)).to(cuda)
        box_ind = torch.from_numpy(np.sort(rng.integers(0, 2, 10)).astype(np.int32)).to(cuda)
        from heterofusionrcnn_torch.ops.cropping import CROP_KERNEL
        return (f32(2, 400, 36), idx, box_ind), (CROP_KERNEL,), 0.0
    from heterofusionrcnn_torch.ops.conv import CONV_KERNEL, CONVT_KERNEL
    transpose = name.startswith("convtranspose")
    args = _conv_case(rng, cuda, 2, 40, 20, 15, 21, transpose)
    return (*args, True), (CONVT_KERNEL if transpose else CONV_KERNEL,), 1e-4


def _to(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, (list, tuple)):
        return [_to(t, device) for t in a]
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knn", "knn_sorted", "farthest_point_sample", "oriented_nms",
                                  "fused_xconv", "xconv_split_epilogue", "crop_gather",
                                  "conv3x3_affine_relu", "convtranspose3x3_affine_relu"])
def test_custom_ops_dispatch_by_device(cuda, name):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args, counters, tol = _op_case(name, cuda)
    op = getattr(torch.ops.hfr, name.replace("_sorted", ""))
    before = [k.launches for k in counters]
    got = op(*args)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1] * len(counters)
    want = op(*_to(args, "cpu"))
    assert [k.launches - b for k, b in zip(counters, before)] == [1] * len(counters)
    for g, w in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
        assert g.is_cuda and not w.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        g = g.cpu()
        if tol:
            assert bool(((g - w).abs() <= tol + tol * w.abs()).all()), float((g - w).abs().max())
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    if name != "farthest_point_sample":  # one tensor
        mixed = _to(args, "cpu")
        mixed[1] = _to(args[1], cuda)
        with pytest.raises(ValueError, match="inputs on"):
            op(*mixed)


@pytest.mark.cuda
def test_export_roundtrip_on_card(cuda, tmp_path):
    """The `*_unittest` two-stage detector, both switches on, exported on
    the card and loaded: on a batch of another seed equal to the eager
    forward (kept boxes within 1e-4 + 1e-4 |eager|, classes, valid flags
    and counts exact), launching each kernel as often as the eager
    forward; refused for the CPU."""
    from heterofusionrcnn_torch.configs.presets import rcnn_unittest, rpn_unittest
    from heterofusionrcnn_torch.inference import build_two_stage, random_batch
    from heterofusionrcnn_torch.runtime.export import export_fused_inference, load_exported
    from heterofusionrcnn_torch.ops import conv, cropping, xconv

    det, inputs = build_two_stage(2, 3, "cuda", rpn_unittest(), rcnn_unittest(),
                                  conv_kernels=True, crop_kernel=True)
    path = str(tmp_path / "two_stage.pt2")
    export_fused_inference(det, *inputs, path)
    loaded = load_exported(path)
    host = random_batch(rpn_unittest(), 2, 8)
    new = [torch.from_numpy(host[k]).to(cuda)
           for k in ("point_cloud", "image_input", "stereo_calib_p2")]
    kernels = [grouping.KNN_KERNEL, grouping.KNN_PREP_KERNEL, sampling.FPS_KERNEL,
               nms_ops.NMS_KERNEL, xconv.XCONV_KERNEL, XCONV_EPILOGUE_KERNEL,
               conv.CONV_KERNEL, conv.CONVT_KERNEL, cropping.CROP_KERNEL]
    counts = []
    outs = []
    for fn in (loaded, det):
        before = [k.launches for k in kernels]
        outs.append(fn(*new))
        torch.cuda.synchronize()
        counts.append([k.launches - b for k, b in zip(kernels, before)])
    assert counts[0] == counts[1] and all(counts[0][i] for i in (0, 2, 3, 4, 6, 7, 8))
    got, want = outs
    for key in ("proposals", "proposal_scores", "final_boxes", "final_scores"):
        assert bool(((got[key] - want[key]).abs() <= 1e-4 + 1e-4 * want[key].abs()).all()), key
    for key in ("final_classes", "final_valid", "num_final"):
        assert torch.equal(got[key], want[key]), key
    assert not torch.allclose(loaded(*inputs)["proposals"], got["proposals"])
    with pytest.raises(ValueError, match="not on 'cpu'"):
        load_exported(path, device="cpu")


@pytest.mark.cuda
def test_bf16_export_roundtrip_on_card(cuda, tmp_path):
    """The `*_unittest` two-stage detector in bf16, both switches on,
    exported on the card and loaded: on a batch of another seed the loaded
    forward launches each bf16 kernel as often as the eager forward and
    equals it (kept boxes within 1e-4 + 1e-4 |eager|, classes, valid flags
    and counts exact); the bf16 weight operands the eager forward cached
    are not part of the artifact."""
    from heterofusionrcnn_torch.configs.presets import rcnn_unittest, rpn_unittest
    from heterofusionrcnn_torch.inference import build_two_stage, random_batch
    from heterofusionrcnn_torch.runtime.export import export_fused_inference, load_exported
    from heterofusionrcnn_torch.ops import conv, cropping, xconv

    det, inputs = build_two_stage(2, 3, "cuda", rpn_unittest(), rcnn_unittest(),
                                  conv_kernels=True, crop_kernel=True,
                                  compute_dtype="bfloat16")
    det(*inputs)
    path = str(tmp_path / "two_stage_bf16.pt2")
    export_fused_inference(det, *inputs, path)
    loaded = load_exported(path)
    host = random_batch(rpn_unittest(), 2, 8)
    new = [torch.from_numpy(host[k]).to(cuda)
           for k in ("point_cloud", "image_input", "stereo_calib_p2")]
    kernels = [xconv.XCONV_BF16_KERNEL, conv.CONV_BF16_KERNEL, conv.CONVT_BF16_KERNEL,
               cropping.CROP_BF16_KERNEL]
    counts = []
    outs = []
    for fn in (loaded, det):
        before = [k.launches for k in kernels]
        outs.append(fn(*new))
        torch.cuda.synchronize()
        counts.append([k.launches - b for k, b in zip(kernels, before)])
    assert counts[0] == counts[1] and all(counts[0])
    got, want = outs
    for key in ("proposals", "proposal_scores", "final_boxes", "final_scores"):
        g, w = got[key].float(), want[key].float()
        assert bool(((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all()), key
    for key in ("final_classes", "final_valid", "num_final"):
        assert torch.equal(got[key], want[key]), key
