"""The port's crop gather (`ops/cropping.crop_gather`) against the JAX
package's Pallas `crop_gather` in interpret mode, and the point crop with
the switch on against the crop with it off. A gather is a copy: both
exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heterofusionrcnn_tpu.ops.pallas_crop import crop_gather as jax_crop_gather

from heterofusionrcnn_torch.core.geometry import box_3d_to_corners
from heterofusionrcnn_torch.ops.cropping import crop_gather, pc_crop_and_sample


@pytest.mark.parametrize("b,n,c,nb,r", [(2, 64, 12, 5, 16), (3, 40, 37, 6, 24), (1, 16, 4, 2, 8)])
def test_crop_gather_plain_matches_pallas(b, n, c, nb, r):
    rng = np.random.default_rng(20)
    src = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (nb, r)).astype(np.int32)
    box_ind = np.sort(rng.integers(0, b, nb)).astype(np.int32)
    want = jax_crop_gather(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(box_ind), interpret=True)
    got = crop_gather(torch.from_numpy(src), torch.from_numpy(idx), torch.from_numpy(box_ind))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pc_crop_switch_changes_nothing():
    rng = np.random.default_rng(21)
    b, n, c, nb, r = 2, 300, 9, 6, 32
    pts = torch.from_numpy(rng.uniform(-3, 3, (b, n, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    inten = torch.from_numpy(rng.uniform(0, 1, (b, n, 1)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(b, n)) > 0.5).astype(np.float32))
    boxes = np.zeros((nb, 7), np.float32)
    boxes[:, :3] = rng.uniform(-2, 2, (nb, 3))
    boxes[:, 3:6] = rng.uniform(0.5, 3, (nb, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, nb)
    corners = box_3d_to_corners(torch.from_numpy(boxes))
    box_ind = torch.arange(b).repeat_interleave(nb // b)
    off = pc_crop_and_sample(pts, fts, inten, mask, corners, box_ind, r)
    on = pc_crop_and_sample(pts, fts, inten, mask, corners, box_ind, r, crop_kernel=True)
    assert bool(off[-1].any())
    for a, w in zip(on, off):
        assert torch.equal(a, w)
