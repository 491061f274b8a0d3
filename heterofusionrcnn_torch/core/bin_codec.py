"""Bin-based 3D box decoding (PyTorch port of
heterofusionrcnn_tpu/core/bin_codec.py `decode`).

A box is regressed relative to a reference point (an RPN point, or an RCNN
proposal centre with its heading): x/z offsets as a bin over [-S, S] of
width DELTA plus a residual in units of DELTA, the heading as a bin of
width DELTA_THETA over [-R, R] plus a residual in units of DELTA_THETA/2,
y as a direct residual and the size relative to the class mean size.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode(
    ref_pts: torch.Tensor,
    ref_theta: Optional[torch.Tensor],
    bin_x: torch.Tensor,
    res_x_norm: torch.Tensor,
    bin_z: torch.Tensor,
    res_z_norm: torch.Tensor,
    bin_theta: torch.Tensor,
    res_theta_norm: torch.Tensor,
    res_y: torch.Tensor,
    res_size_norm: torch.Tensor,
    mean_sizes: torch.Tensor,
    S,
    DELTA,
    R: float,
    DELTA_THETA: float,
) -> torch.Tensor:
    """Bin representation -> (..., K, 7) box_3d.

    Args:
      ref_pts: (..., 3); ref_theta: (...,) reference headings, or None for
        the RPN (no rotation into a reference frame).
      bin_*: (..., K) integer bins; res_*: (..., K); res_size_norm and
        mean_sizes: (..., K, 3).
      S, DELTA: scalars or (K,) per-class search range and bin length.
    """
    S = torch.as_tensor(S, dtype=torch.float32, device=ref_pts.device)
    DELTA = torch.as_tensor(DELTA, dtype=torch.float32, device=ref_pts.device)
    dx = (bin_x.float() + 0.5) * DELTA - S + res_x_norm * DELTA
    dz = (bin_z.float() + 0.5) * DELTA - S + res_z_norm * DELTA

    if ref_theta is not None:
        t = ref_theta[..., None]
        c, s = torch.cos(t), torch.sin(t)
        dx, dz = c * dx + s * dz, -s * dx + c * dz
    else:
        t = 0.0

    x = dx + ref_pts[..., None, 0]
    z = dz + ref_pts[..., None, 2]
    y = res_y + ref_pts[..., None, 1]
    theta = (
        t
        + (bin_theta.float() + 0.5) * DELTA_THETA
        - R
        + res_theta_norm * 0.5 * DELTA_THETA
    )
    if ref_theta is None:
        theta = theta.expand(x.shape)
    size = mean_sizes + res_size_norm * mean_sizes
    return torch.stack(
        [x, y, z, size[..., 0], size[..., 1], size[..., 2], theta], dim=-1
    )
