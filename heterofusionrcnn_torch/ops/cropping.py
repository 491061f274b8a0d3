"""Point-cloud RoI crop-and-sample (port of
heterofusionrcnn_tpu/ops/cropping.py `pc_crop_and_sample`).

Per box: the points of its batch element inside the oriented box (three
dot-product interval tests), the first R of them in index order, and for
boxes with fewer members slot j repeats member j % cnt. An empty box gives
index 0 everywhere and non_empty_box_mask False. Plain PyTorch: the TPU
package's crop kernel (`pallas_crop.crop_gather`) is off by default there.
"""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.core.geometry import points_in_box_3d


def first_k_true(mask: torch.Tensor, k: int):
    """Indices of the first k True entries of each row in index order, and
    the count (capped at k). Slots past the count hold the first hit; rows
    without a hit give 0."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device, dtype=torch.int32)
    key = torch.where(mask, ar, torch.full_like(ar, n))
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    cnt = torch.clamp(mask.sum(dim=-1), max=k).to(torch.int32)
    slot = torch.arange(k, device=mask.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(idx >= n, torch.zeros_like(idx), idx), cnt


def pc_crop_and_sample(pts, fts, intensities, mask, boxes_corners, box_ind, resize):
    """Crop `resize` points per oriented 3D box.

    Args:
      pts (B, N, 3), fts (B, N, C), intensities (B, N, 1), mask (B, N);
      boxes_corners (Nb, 8, 3); box_ind (Nb,) batch element of each box.
    Returns:
      crop_pts (Nb, R, 3), crop_fts (Nb, R, C), crop_intensities (Nb, R, 1),
      crop_mask (Nb, R), crop_ind (Nb, R) int32, non_empty_box_mask (Nb,).
    """
    b, n, _ = pts.shape
    nb = boxes_corners.shape[0]
    box_ind = box_ind.long()
    inside = points_in_box_3d(pts[box_ind], boxes_corners)  # (Nb, N)
    idx, cnt = first_k_true(inside, resize)
    slot = torch.arange(resize, device=pts.device)[None, :]
    wrapped = torch.where(
        cnt[:, None] > 0, slot % torch.clamp(cnt[:, None], min=1), torch.zeros_like(slot)
    )
    idx = torch.gather(idx, 1, wrapped.long())
    rows = (box_ind[:, None] * n + idx.long()).reshape(-1)
    crop_pts = pts.reshape(b * n, 3)[rows].reshape(nb, resize, 3)
    crop_int = intensities.reshape(b * n, 1)[rows].reshape(nb, resize, 1)
    crop_mask = mask.reshape(b * n)[rows].reshape(nb, resize)
    crop_fts = fts.reshape(b * n, -1)[rows].reshape(nb, resize, -1)
    return crop_pts, crop_fts, crop_int, crop_mask, idx, cnt > 0
