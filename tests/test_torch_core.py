"""The port's core geometry, bin decode, projection, rotated IoU and crop
ops against the JAX package's on the same numpy inputs.

Tolerances: geometry and projection atol/rtol 1e-5 (f32, same formulas,
einsum vs elementwise order); crops exact indices and gathered values,
crop-and-resize 1e-5; rotated overlaps 1e-5 absolute on areas of order 1-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heterofusionrcnn_tpu.core import bin_codec as jbin
from heterofusionrcnn_tpu.core import geometry as jgeo
from heterofusionrcnn_tpu.core import projection as jproj
from heterofusionrcnn_tpu.core import rotated_iou as jiou
from heterofusionrcnn_tpu.ops.cropping import pc_crop_and_sample as j_crop
from heterofusionrcnn_tpu.ops.image_crop import crop_and_resize as j_crop_resize

from heterofusionrcnn_torch.core import bin_codec as tbin
from heterofusionrcnn_torch.core import geometry as tgeo
from heterofusionrcnn_torch.core import projection as tproj
from heterofusionrcnn_torch.core import rotated_iou as tiou
from heterofusionrcnn_torch.ops import dispatch
from heterofusionrcnn_torch.ops.cropping import pc_crop_and_sample as t_crop
from heterofusionrcnn_torch.ops.image_crop import crop_and_resize as t_crop_resize

TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-10, 10, n)
    b[:, 1] = rng.uniform(0.5, 2, n)
    b[:, 2] = rng.uniform(8, 40, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------ geometry --


@pytest.mark.parametrize("fn", ["box_3d_to_corners", "boxes_3d_to_bev"])
def test_box_formats(fn):
    boxes = _boxes(np.random.default_rng(0), 40).reshape(4, 10, 7)
    _close(getattr(tgeo, fn)(torch.from_numpy(boxes)), getattr(jgeo, fn)(jnp.asarray(boxes)))


def test_points_in_box_and_canonical_transform():
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 6)
    pts = (boxes[:, None, :3] + rng.normal(0, 2.0, (6, 200, 3))).astype(np.float32)
    corners_j = jgeo.box_3d_to_corners(jnp.asarray(boxes))
    corners_t = tgeo.box_3d_to_corners(torch.from_numpy(boxes))
    inside_t = tgeo.points_in_box_3d(torch.from_numpy(pts), corners_t)
    inside_j = jgeo.points_in_box_3d(jnp.asarray(pts), corners_j)
    np.testing.assert_array_equal(inside_t.numpy(), np.asarray(inside_j))
    assert 0 < int(inside_t.sum()) < inside_t.numel()
    _close(tgeo.canonical_transform(torch.from_numpy(pts), torch.from_numpy(boxes)),
           jgeo.canonical_transform(jnp.asarray(pts), jnp.asarray(boxes)))
    _close(tgeo.expand_box_3d(torch.from_numpy(boxes), 1.0),
           jgeo.expand_box_3d(jnp.asarray(boxes), 1.0))


# ----------------------------------------------------------- bin decode --


@pytest.mark.parametrize("with_theta", [False, True])
def test_bin_decode(with_theta):
    rng = np.random.default_rng(2)
    b, p, k = 2, 30, 3
    ref = rng.uniform(-20, 20, (b, p, 3)).astype(np.float32)
    theta = rng.uniform(-3, 3, (b, p)).astype(np.float32)
    bins = [rng.integers(0, 12, (b, p, k)).astype(np.int32) for _ in range(3)]
    res = [rng.uniform(-0.5, 0.5, (b, p, k)).astype(np.float32) for _ in range(4)]
    size = rng.uniform(-0.3, 0.3, (b, p, k, 3)).astype(np.float32)
    mean = np.broadcast_to(np.asarray([[3.9, 1.6, 1.56], [0.8, 0.66, 1.74], [1.76, 0.6, 1.73]],
                                      np.float32), (b, p, k, 3)).copy()
    S = np.asarray([3.0, 1.5, 1.5], np.float32)
    DELTA = np.asarray([0.5, 0.25, 0.25], np.float32)
    R, DT = 0.25 * np.pi, 0.5 * np.pi / 12
    want = jbin.decode(jnp.asarray(ref), jnp.asarray(theta) if with_theta else 0.0,
                       jnp.asarray(bins[0]), jnp.asarray(res[0]), jnp.asarray(bins[1]),
                       jnp.asarray(res[1]), jnp.asarray(bins[2]), jnp.asarray(res[2]),
                       jnp.asarray(res[3]), jnp.asarray(size), jnp.asarray(mean),
                       jnp.asarray(S), jnp.asarray(DELTA), R, DT)
    t = torch.from_numpy
    got = tbin.decode(t(ref), t(theta) if with_theta else None, t(bins[0]), t(res[0]),
                      t(bins[1]), t(res[1]), t(bins[2]), t(res[2]), t(res[3]), t(size),
                      t(mean), S, DELTA, R, DT)
    _close(got, want)


# ----------------------------------------------------------- projection --


def test_projection():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 20).reshape(2, 10, 7)
    p2 = np.tile(np.array([[700.0, 0, 600, 40], [0, 700.0, 180, 2], [0, 0, 1, 0]],
                          np.float32), (2, 1, 1))
    pts = boxes[..., :3]
    _close(tproj.rect_to_image(torch.from_numpy(pts), torch.from_numpy(p2)),
           jproj.rect_to_image(jnp.asarray(pts), jnp.asarray(p2)), rtol=1e-5, atol=1e-3)
    got = tproj.project_boxes_to_image_space(torch.from_numpy(boxes), torch.from_numpy(p2), 1200, 360)
    want = jproj.project_boxes_to_image_space(jnp.asarray(boxes), jnp.asarray(p2), 1200, 360)
    _close(got[0], want[0], rtol=1e-5, atol=1e-3)
    _close(got[1], want[1])
    _close(tproj.boxes_2d_to_yxyx(got[1]), jproj.boxes_2d_to_yxyx(want[1]))


# ---------------------------------------------------------- rotated IoU --


def test_bev_overlap_random_pairs():
    rng = np.random.default_rng(4)
    a = _boxes(rng, 50)
    b = a.copy()
    b[:, [0, 2]] += rng.normal(0, 1.0, (50, 2)).astype(np.float32)
    b[:, 6] += rng.normal(0, 0.5, 50).astype(np.float32)
    bev_a, bev_b = tgeo.boxes_3d_to_bev(torch.from_numpy(a)), tgeo.boxes_3d_to_bev(torch.from_numpy(b))
    got = tiou.bev_overlap(bev_a[:, None], bev_b[None])
    want = jiou.bev_overlap(jnp.asarray(bev_a.numpy())[:, None], jnp.asarray(bev_b.numpy())[None])
    _close(got, want)
    _close(tiou.bev_iou(bev_a, bev_b), jiou.bev_iou(jnp.asarray(bev_a.numpy()), jnp.asarray(bev_b.numpy())))


def test_bev_overlap_degenerate_boundaries():
    """Identical boxes (same-direction shared edges count once), touching
    boxes (opposite edges cancel) and nested boxes."""
    boxes = np.asarray([
        [0, 0, 2, 1, 0.0], [0, 0, 2, 1, 0.0],     # identical
        [0, 0, 2, 1, 0.0], [2, 0, 4, 1, 0.0],     # touching
        [0, 0, 4, 4, 0.3], [1, 1, 3, 3, 0.3],     # nested, rotated
    ], np.float32)
    a, b = boxes[0::2], boxes[1::2]
    got = tiou.bev_overlap(torch.from_numpy(a), torch.from_numpy(b))
    want = jiou.bev_overlap(jnp.asarray(a), jnp.asarray(b))
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), [2.0, 0.0, 4.0], atol=1e-5)


# ---------------------------------------------------------------- crops --


def test_pc_crop_and_sample():
    """First R members in index order, wrap-fill j % cnt, empty box -> idx 0
    and non_empty False."""
    rng = np.random.default_rng(5)
    b, n, c, r = 2, 300, 5, 24
    boxes = _boxes(rng, 6)
    boxes[:, 3:6] = rng.uniform(1.0, 3.0, (6, 3))
    box_ind = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    pts = (boxes[:, None, :3] + rng.normal(0, 1.5, (6, n // 3, 3))).reshape(b, n, 3)
    pts = pts.astype(np.float32)
    boxes[5, :3] = [500.0, 0.0, 500.0]  # no points: an empty box
    fts = rng.standard_normal((b, n, c)).astype(np.float32)
    inten = rng.uniform(-0.5, 0.5, (b, n, 1)).astype(np.float32)
    mask = (rng.uniform(size=(b, n)) > 0.5).astype(np.float32)
    expanded = jgeo.expand_box_3d(jnp.asarray(boxes), 1.0)
    corners = np.array(jgeo.box_3d_to_corners(expanded))

    want = j_crop(jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(inten), jnp.asarray(mask),
                  jnp.asarray(corners), jnp.asarray(box_ind), r)
    got = t_crop(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(inten),
                 torch.from_numpy(mask), torch.from_numpy(corners), torch.from_numpy(box_ind), r)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[5][5]) and int(got[4][5].abs().sum()) == 0
    assert bool(got[5][:5].all())


def test_crop_and_resize():
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 15, 23, 4)).astype(np.float32)
    boxes = np.sort(rng.uniform(-0.2, 1.2, (7, 2, 2)), axis=1).reshape(7, 4)[:, [0, 2, 1, 3]]
    boxes = boxes.astype(np.float32)
    ind = rng.integers(0, 2, 7).astype(np.int32)
    want = j_crop_resize(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(ind), 5)
    got = t_crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), torch.from_numpy(ind), 5)
    _close(got, want)


# ------------------------------------------------------------- dispatch --


def test_dispatch_by_device():
    """The op's device key picks the implementation: a CPU tensor runs the
    plain version, a meta tensor only the fake (shape) function, and
    inputs on two devices raise."""
    from heterofusionrcnn_torch.ops import sampling

    xyz = torch.from_numpy(np.random.default_rng(0).uniform(-5, 5, (2, 40, 3)).astype(np.float32))
    assert torch.equal(sampling.farthest_point_sample(xyz, 8),
                       sampling.farthest_point_sample_plain(xyz, 8))
    meta = sampling.farthest_point_sample(xyz.to("meta"), 8)
    assert meta.device.type == "meta" and meta.shape == (2, 8) and meta.dtype == torch.int32
    assert dispatch.one_device(xyz, None) == torch.device("cpu")
    with pytest.raises(ValueError):
        dispatch.one_device(xyz, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        torch.ops.hfr.crop_gather(torch.zeros(1, 4, 4), torch.zeros(1, 2, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32, device="meta"))
