"""The port's four kernel ops against the JAX package's kernels.

On the CPU each op runs its plain PyTorch version (the wrapper dispatches
by device); the JAX side runs the Pallas kernel interpreted
(`farthest_point_sample_pallas`, `oriented_nms_pallas`, `fused_xconv(...,
interpret=True)`) or, for KNN, the kernel's jnp mirror
`_knn_reference_jnp`. Inputs come from numpy with a fixed seed.

Tolerances: indices exact (FPS picks, KNN neighbours, NMS keep lists);
squared distances 1e-5 relative (f32 rounding of the same three-term sum);
fused XConv features atol/rtol 1e-4 (f32 reassociation of the matmuls).

The same kernels on the card against their plain versions:
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heterofusionrcnn_tpu.ops.pallas_fps import farthest_point_sample_pallas
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp
from heterofusionrcnn_tpu.ops.pallas_nms import oriented_nms_pallas
from heterofusionrcnn_tpu.ops.pallas_xconv import fused_xconv as jax_fused_xconv

from heterofusionrcnn_torch.ops.grouping import knn_point
from heterofusionrcnn_torch.ops.nms import oriented_nms
from heterofusionrcnn_torch.ops.sampling import farthest_point_sample
from heterofusionrcnn_torch.ops.xconv import fused_xconv

from tests.test_torch_cuda import _bev_boxes, _points, _torch_weights, _xconv_params


# ------------------------------------------------------------------ FPS --


@pytest.mark.parametrize("grid", [False, True])
def test_fps_matches_pallas(grid):
    rng = np.random.default_rng(0)
    xyz = _points(rng, 2, 256, grid)
    want = np.asarray(farthest_point_sample_pallas(jnp.asarray(xyz), 48))
    got = farthest_point_sample(torch.from_numpy(xyz), 48)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,n,npoint,grid", [
    (3, 203, 37, False),   # N not a multiple of 8
    (2, 333, 100, True),   # N not a multiple of 128, ties
    (5, 17, 17, False),    # every point taken
])
def test_fps_matches_pallas_at_ragged_sizes(b, n, npoint, grid):
    """Sizes the cluster kernel splits unevenly over its CTAs and threads;
    on the CPU the wrapper runs the plain version that the card tests hold
    the kernel to at every cluster size."""
    rng = np.random.default_rng(n)
    xyz = _points(rng, b, n, grid)
    want = np.asarray(farthest_point_sample_pallas(jnp.asarray(xyz), npoint))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ KNN --


@pytest.mark.parametrize("grid,k,same_set", [
    (False, 8, True), (False, 12, False), (True, 8, True), (True, 4, False),
])
def test_knn_matches_pallas_reference(grid, k, same_set):
    rng = np.random.default_rng(1)
    xyz = _points(rng, 2, 300, grid)
    qrs = xyz if same_set else _points(rng, 2, 70, grid)
    want_d, want_i = _knn_reference_jnp(k, jnp.asarray(xyz), jnp.asarray(qrs))
    got_d, got_i = knn_point(k, torch.from_numpy(xyz), torch.from_numpy(qrs))
    assert got_i.dtype == torch.int32 and got_i.shape == (2, qrs.shape[1], k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)


def test_knn_rejects_k_above_n():
    with pytest.raises(ValueError):
        knn_point(9, torch.zeros(1, 8, 3), torch.zeros(1, 2, 3))


# ------------------------------------------------------------------ NMS --


@pytest.mark.parametrize("thresh,masked,tied", [
    (0.1, False, False), (0.5, True, False), (0.3, False, True),
])
def test_nms_matches_pallas(thresh, masked, tied):
    rng = np.random.default_rng(2)
    b, n, keep = 3, 60, 20
    boxes = _bev_boxes(rng, b, n)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if tied:  # few distinct scores: the lowest index must win each tie
        scores = np.round(scores * 4) / 4
    valid = rng.uniform(size=(b, n)) > 0.3 if masked else None
    got_idx, got_valid = oriented_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), thresh, keep,
        None if valid is None else torch.from_numpy(valid),
    )
    for f in range(b):
        want_idx, want_valid = oriented_nms_pallas(
            jnp.asarray(boxes[f]), jnp.asarray(scores[f]), thresh, keep,
            None if valid is None else jnp.asarray(valid[f]),
        )
        np.testing.assert_array_equal(got_idx[f].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_valid[f].numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("n,keep,thresh", [(77, 30, 0.3), (131, 131, 0.0), (1, 4, 0.5)])
def test_nms_matches_pallas_with_masked_frames(n, keep, thresh):
    """N not a multiple of 8 or 128, a mask per frame with one frame where
    no box is valid (all -1) and one where every box is, and keep lists
    longer than what survives (-1 padding)."""
    rng = np.random.default_rng(n + 7)
    b = 3
    boxes = _bev_boxes(rng, b, n)
    scores = (np.round(rng.uniform(0, 1, (b, n)) * 8) / 8).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.4
    valid[1] = False
    valid[2] = True
    got_idx, got_valid = oriented_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                                      keep, torch.from_numpy(valid))
    assert (got_idx[1] == -1).all()
    for f in range(b):
        want_idx, want_valid = oriented_nms_pallas(
            jnp.asarray(boxes[f]), jnp.asarray(scores[f]), thresh, keep, jnp.asarray(valid[f]))
        np.testing.assert_array_equal(got_idx[f].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_valid[f].numpy(), np.asarray(want_valid))


# --------------------------------------------------------- fused XConv --


@pytest.mark.parametrize("with_x", [True, False])
def test_fused_xconv_matches_pallas(with_x):
    rng = np.random.default_rng(3)
    b, n, p, k, cf, cp, dm, d = 2, 40, 16, 4, 8, 6, 2, 16
    params = _xconv_params(rng, k, cf, cf + cp, dm, d)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    qrs = rng.standard_normal((b, p, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    nn_local = np.take_along_axis(pts[:, None], idx[..., None], axis=2) - qrs[:, :, None]

    jp = {kk: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
          for kk, v in params.items()}
    want = jax_fused_xconv(
        jnp.asarray(nn_local), None, jp, fts_src=jnp.asarray(fts), nn_idx=jnp.asarray(idx),
        compute_dtype=jnp.float32, with_x_transformation=with_x, interpret=True,
    )
    got = fused_xconv(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs),
                      torch.from_numpy(idx), _torch_weights(params, with_x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
