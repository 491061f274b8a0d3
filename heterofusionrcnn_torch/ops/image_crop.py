"""Image RoI crop-and-resize (port of heterofusionrcnn_tpu/ops/image_crop.py).

tf.image.crop_and_resize semantics: bilinear samples on a corner-aligned
grid from y1*(H-1) to y2*(H-1) (x likewise), normalised [y1, x1, y2, x2]
boxes, samples outside the image read 0. Not `roi_align`, whose grid is
cell-centred and averages bins.
"""

from __future__ import annotations

import torch


def crop_and_resize(image, boxes_yxyx_norm, box_ind, crop_size: int):
    """(B, H, W, C) image, (N, 4) boxes, (N,) batch indices ->
    (N, crop_size, crop_size, C) crops."""
    b, h, w, c = image.shape
    y1, x1, y2, x2 = (boxes_yxyx_norm[:, i] for i in range(4))
    if crop_size > 1:
        frac = torch.arange(crop_size, dtype=torch.float32, device=image.device) / (crop_size - 1)
    else:
        frac = torch.full((1,), 0.5, dtype=torch.float32, device=image.device)
    ys = (y1[:, None] + (y2 - y1)[:, None] * frac[None, :]) * (h - 1)
    xs = (x1[:, None] + (x2 - x1)[:, None] * frac[None, :]) * (w - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    bi = box_ind.long()[:, None, None]

    def gather(yi, xi):
        valid = (
            (yi[:, :, None] >= 0) & (yi[:, :, None] <= h - 1)
            & (xi[:, None, :] >= 0) & (xi[:, None, :] <= w - 1)
        )
        yc = yi.clamp(0, h - 1).long()[:, :, None]
        xc = xi.clamp(0, w - 1).long()[:, None, :]
        return image[bi, yc, xc] * valid[..., None]

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy
