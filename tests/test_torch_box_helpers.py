"""The last helper modules of the port against the JAX package on the CPU:
`core/box_3d_encoder`, the `core/geometry` additions (`bev_box_corners`,
`canonical_untransform`, `box_3d_volume`), the `core/projection` anchor
projections and `core/box_2d` (torch: float32 within 1e-6 relative and
1e-6 absolute); `core/box_8c`, `utils/format_checker` and
`utils/np_box_ops.indices_to_dense_vector` (numpy: bit-equal, errors and
messages included); and `runtime/native_eval.run_kitti_native_eval_async`
(a spawned child) against the JAX evaluator. Inputs are seeded numpy."""

from __future__ import annotations

import filecmp
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heterofusionrcnn_tpu.core import box_2d as j_box_2d
from heterofusionrcnn_tpu.core import box_3d_encoder as j_enc
from heterofusionrcnn_tpu.core import box_8c as j_box_8c
from heterofusionrcnn_tpu.core import geometry as j_geom
from heterofusionrcnn_tpu.core import projection as j_proj
from heterofusionrcnn_tpu.runtime import native_eval as j_native_eval
from heterofusionrcnn_tpu.utils import format_checker as j_fc
from heterofusionrcnn_tpu.utils import np_box_ops as j_np_box_ops

from heterofusionrcnn_torch.core import box_2d, box_3d_encoder, box_8c, geometry, projection
from heterofusionrcnn_torch.runtime import native_eval
from heterofusionrcnn_torch.utils import format_checker, np_box_ops

TOL = dict(rtol=1e-6, atol=1e-6)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "kitti")


def _close(got, want, **tol):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, **tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _boxes_3d(rng, n):
    return np.concatenate([rng.uniform([-20, -2, 5], [20, 2, 60], (n, 3)),
                           rng.uniform(0.5, 4.5, (n, 3)),
                           rng.uniform(-math.pi, math.pi, (n, 1))], axis=1).astype(np.float32)


def _boxes_2d(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(-5, 40, (n, 2))], axis=1).astype(np.float32)


def _ry_cases():
    """Seeded angles, exact multiples of pi/2 and the half-way angles
    between them (where the snap rounds half to even)."""
    rng = np.random.default_rng(0)
    half = np.float32(math.pi / 2)
    k = np.arange(-4, 5, dtype=np.float32)
    return [("random", rng.uniform(-2 * math.pi, 2 * math.pi, 64).astype(np.float32)),
            ("multiples", k * half),
            ("half_way", (k + np.float32(0.5)) * half)]


@pytest.mark.parametrize("ortho", [False, True], ids=["exact", "ortho"])
@pytest.mark.parametrize("case", _ry_cases(), ids=lambda c: c[0])
def test_box_3d_to_anchor(case, ortho):
    _, ry = case
    boxes = _boxes_3d(np.random.default_rng(1), len(ry))
    boxes[:, 6] = ry
    want = j_enc.box_3d_to_anchor(jnp.asarray(boxes), ortho)
    _close(box_3d_encoder.box_3d_to_anchor(torch.from_numpy(boxes), ortho), want)
    got_np = box_3d_encoder.np_box_3d_to_anchor(boxes.astype(np.float64), ortho)
    assert got_np.dtype == np.float32
    _close(got_np, j_enc.np_box_3d_to_anchor(boxes.astype(np.float64), ortho))


def test_half_way_snap_rounds_to_even():
    """ry / (pi/2) exactly 0.5 and 2.5 snap down to 0 and 2 (half to
    even), as jnp.round does."""
    half = math.pi / 2
    ry = torch.tensor([0.5, 2.5, -0.5]) * half
    boxes = torch.zeros(3, 7)
    boxes[:, 6] = ry
    boxes[:, 3], boxes[:, 4] = 4.0, 1.0
    assert torch.equal(torch.round(boxes[:, 6] / half), torch.tensor([0.0, 2.0, -0.0]))
    want = j_enc.box_3d_to_anchor(jnp.asarray(boxes.numpy()), True)
    _close(box_3d_encoder.box_3d_to_anchor(boxes, True), want)


def test_anchor_to_box_3d():
    anchors = np.random.default_rng(2).uniform(-10, 10, (3, 5, 6)).astype(np.float32)
    _close(box_3d_encoder.anchor_to_box_3d(torch.from_numpy(anchors)),
           j_enc.anchor_to_box_3d(jnp.asarray(anchors)))


def test_geometry_additions():
    rng = np.random.default_rng(3)
    boxes = _boxes_3d(rng, 12).reshape(3, 4, 7)
    bev = np.array(j_geom.boxes_3d_to_bev(jnp.asarray(boxes)))
    _close(geometry.bev_box_corners(torch.from_numpy(bev)), j_geom.bev_box_corners(jnp.asarray(bev)))
    _close(geometry.box_3d_volume(torch.from_numpy(boxes)), j_geom.box_3d_volume(jnp.asarray(boxes)))
    pts = rng.uniform(-3, 3, (3, 4, 9, 3)).astype(np.float32)
    _close(geometry.canonical_untransform(torch.from_numpy(pts), torch.from_numpy(boxes)),
           j_geom.canonical_untransform(jnp.asarray(pts), jnp.asarray(boxes)), rtol=1e-6, atol=1e-5)


def test_canonical_untransform_inverts_transform():
    rng = np.random.default_rng(4)
    boxes = torch.from_numpy(_boxes_3d(rng, 6))
    pts = torch.from_numpy(rng.uniform([-30, -3, 0], [30, 3, 70], (6, 50, 3)).astype(np.float32))
    back = geometry.canonical_untransform(geometry.canonical_transform(pts, boxes), boxes)
    torch.testing.assert_close(back, pts, rtol=0, atol=1e-5)


def test_project_anchors():
    rng = np.random.default_rng(5)
    anchors = np.concatenate([rng.uniform([-15, -1, 8], [15, 2, 50], (20, 3)),
                              rng.uniform(0.5, 4, (20, 3))], axis=1).astype(np.float32)
    extents = ((-40.0, 40.0), (0.0, 70.0))
    _close(projection.project_anchors_to_bev(torch.from_numpy(anchors), extents),
           j_proj.project_anchors_to_bev(jnp.asarray(anchors), extents))
    p2 = np.array([[721.5, 0.0, 609.6, 44.9], [0.0, 721.5, 172.9, 0.2], [0.0, 0.0, 1.0, 0.003]],
                  np.float32)
    got = projection.project_anchors_to_image_space(torch.from_numpy(anchors), p2, (375, 1242))
    want = j_proj.project_anchors_to_image_space(jnp.asarray(anchors), jnp.asarray(p2), (375, 1242))
    _close(got[0], want[0], rtol=1e-6, atol=1e-4)  # pixels, up to ~1e3
    _close(got[1], want[1])
    # Not clipped: some of these anchors project outside the image.
    assert float(got[0].min()) < 0 or float(got[0][:, 2].max()) > 1242


BOX_2D_PAIRWISE = ("intersection", "iou", "ioa", "sq_dist")
BOX_2D_MATCHED = ("matched_intersection", "matched_iou")


@pytest.mark.parametrize("name", BOX_2D_PAIRWISE + BOX_2D_MATCHED)
def test_box_2d_pairs(name):
    rng = np.random.default_rng(6)
    a = _boxes_2d(rng, 7)
    b = _boxes_2d(rng, 5 if name in BOX_2D_PAIRWISE else 7)
    b[0] = a[0]
    got = getattr(box_2d, name)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(j_box_2d, name)(jnp.asarray(a), jnp.asarray(b))
    # sq_dist's sums of squares reach ~5e4: float32 resolves them to ~4e-3.
    _close(got, want, **(dict(rtol=1e-6, atol=1e-2) if name == "sq_dist" else {}))


def test_box_2d_single():
    rng = np.random.default_rng(7)
    a = _boxes_2d(rng, 9).reshape(3, 3, 4)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    window = (10.0, 5.0, 80.0, 90.0)
    _close(box_2d.area(ta), j_box_2d.area(ja))
    _close(box_2d.clip_to_window(ta, window), j_box_2d.clip_to_window(ja, window))
    _close(box_2d.scale(ta, 0.5, 2.0), j_box_2d.scale(ja, 0.5, 2.0))
    _close(box_2d.height_width(ta), j_box_2d.height_width(ja))
    _close(box_2d.change_coordinate_frame(ta, window), j_box_2d.change_coordinate_frame(ja, window))
    np.testing.assert_array_equal(box_2d.prune_small_boxes_mask(ta, 10.0).numpy(),
                                  np.asarray(j_box_2d.prune_small_boxes_mask(ja, 10.0)))
    b = _boxes_2d(rng, 4)
    for overlap in (0.0, 0.1, 0.5):
        np.testing.assert_array_equal(
            box_2d.prune_non_overlapping_mask(ta[0], torch.from_numpy(b), overlap).numpy(),
            np.asarray(j_box_2d.prune_non_overlapping_mask(ja[0], jnp.asarray(b), overlap)))


def _assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_box_8c_codecs():
    rng = np.random.default_rng(8)
    boxes = _boxes_3d(rng, 6).astype(np.float64)
    for box in boxes:
        _assert_bit_equal(box_8c.np_box_3d_to_box_8c(box), j_box_8c.np_box_3d_to_box_8c(box))
    skewed = np.stack([j_box_8c.np_box_3d_to_box_8c(b) for b in boxes]) + rng.normal(0, 0.1, (6, 3, 8))
    _assert_bit_equal(box_8c.align_boxes_8c(skewed), j_box_8c.align_boxes_8c(skewed))
    _assert_bit_equal(box_8c.align_boxes_8c(skewed[0]), j_box_8c.align_boxes_8c(skewed[0]))
    corners = np_box_ops.box_3d_to_corners(boxes)
    _assert_bit_equal(box_8c.box_8co_to_facet(corners), j_box_8c.box_8co_to_facet(corners))
    _assert_bit_equal(box_8c.box_8co_to_facet(corners[0]), j_box_8c.box_8co_to_facet(corners[0]))
    pts = rng.uniform([-20, -3, 5], [20, 3, 60], (300, 3))
    facets = j_box_8c.box_8co_to_facet(corners)
    _assert_bit_equal(box_8c.point_inside_facet(pts, facets), j_box_8c.point_inside_facet(pts, facets))


@pytest.mark.parametrize("n_boxes", [0, 1, 5])
def test_label_point_cloud_v2(n_boxes):
    """Overlapping boxes (the first wins) and points around them."""
    rng = np.random.default_rng(9 + n_boxes)
    boxes = _boxes_3d(rng, n_boxes)
    if n_boxes > 1:
        boxes[1, :3] = boxes[0, :3] + 0.5  # overlaps box 0
    centers = boxes[rng.integers(0, max(n_boxes, 1), 400), :3] if n_boxes else np.zeros((400, 3))
    pts = centers + rng.normal(0, 1.5, (400, 3))
    klasses = rng.integers(1, 4, n_boxes)
    got = box_8c.label_point_cloud_v2(pts, boxes, klasses)
    _assert_bit_equal(got, j_box_8c.label_point_cloud_v2(pts, boxes, klasses))
    if n_boxes:
        assert (got[:, 0] > 0).any()


FORMAT_CASES = [
    ("check_box_3d_format", np.zeros((4, 7)), np.zeros((4, 6))),
    ("check_box_8c_format", np.zeros((2, 8, 3)), np.zeros((2, 3, 8))),
    ("check_bev_box_format", np.zeros((3, 5)), np.zeros((3, 4))),
    ("check_anchor_format", np.zeros((6,)), np.zeros((7,))),
    ("check_point_cloud_format", np.zeros((2, 100, 4)), np.zeros((100, 3))),
    ("check_proposal_file_format", np.zeros((0, 8)), np.zeros((8,))),
    ("check_final_prediction_file_format", np.zeros((5, 9)), np.zeros((5, 8))),
]


@pytest.mark.parametrize("name,good,bad", FORMAT_CASES, ids=[c[0] for c in FORMAT_CASES])
def test_format_checker(name, good, bad):
    assert getattr(format_checker, name)(good) is None
    with pytest.raises(ValueError) as got:
        getattr(format_checker, name)(bad)
    with pytest.raises(ValueError) as want:
        getattr(j_fc, name)(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{}, dict(indices_value=3.5, default_value=-1.0),
                                dict(dtype=np.int32), dict(dtype=np.float64)])
def test_indices_to_dense_vector(kw):
    idx = np.random.default_rng(10).choice(50, 12, replace=False)
    _assert_bit_equal(np_box_ops.indices_to_dense_vector(idx, 50, **kw),
                      j_np_box_ops.indices_to_dense_vector(idx, 50, **kw))
    with pytest.raises(IndexError):
        np_box_ops.indices_to_dense_vector([60], 50)
    with pytest.raises(IndexError):
        j_np_box_ops.indices_to_dense_vector([60], 50)


def test_native_eval_async(tmp_path):
    """The fixture's labels as detections, evaluated by the spawned child
    and by the JAX evaluator: the same AP files, and the JAX AP dict equal
    to the port's."""
    gt_dir = os.path.join(FIXTURE, "training", "label_2")
    det_dir = tmp_path / "det"
    det_dir.mkdir()
    rng = np.random.default_rng(11)
    for name in sorted(os.listdir(gt_dir)):
        rows = [line.split()[:15] + [f"{rng.uniform(0.1, 1.0):.3f}"]
                for line in open(os.path.join(gt_dir, name))
                if line.split() and line.split()[0] in ("Car", "Pedestrian", "Cyclist")]
        (det_dir / name).write_text("".join(" ".join(r) + "\n" for r in rows))
    proc = native_eval.run_kitti_native_eval_async(gt_dir, str(det_dir), str(tmp_path / "child"))
    proc.join(120)
    assert proc.exitcode == 0
    want = j_native_eval.run_kitti_native_eval(gt_dir, str(det_dir), str(tmp_path / "jax"))
    assert native_eval.run_kitti_native_eval(gt_dir, str(det_dir), str(tmp_path / "port")) == want
    assert want["car_detection_3d"][1] > 0
    stats = sorted(n for n in os.listdir(tmp_path / "jax") if n.startswith("stats_"))
    assert len(stats) == 9
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "child", tmp_path / "jax", stats,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
