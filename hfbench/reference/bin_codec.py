"""Bin-based 3D box codec of the port (`core/bin_codec.py`): `decode` and
the RPN's `encode_rpn`.

A box is regressed relative to a reference point (an RPN point, or an RCNN
proposal centre with its heading): x/z offsets as a bin over [-S, S] of
width DELTA plus a residual in units of DELTA, the heading as a bin of
width DELTA_THETA over [-R, R] plus a residual in units of DELTA_THETA/2,
y as a direct residual and the size relative to the class mean size.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS_BIN = 1e-3


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


def _encode_common(dx, dz, dtheta_shift, dy, dsize, mean_sizes, S, DELTA, DELTA_THETA, K):
    """The binning shared by the encoders: x/z offsets repeated over the K
    classes (each class has its own S and DELTA), clipped into [0, 2S) and
    binned; the shifted heading binned over [0, 2R)."""
    S = torch.as_tensor(S, dtype=torch.float32, device=dx.device)
    DELTA = torch.as_tensor(DELTA, dtype=torch.float32, device=dx.device)
    dx = dx[..., None].expand(*dx.shape, K)
    dz = dz[..., None].expand(*dz.shape, K)

    dx_shift = torch.minimum((dx + S).clamp(min=0.0), 2.0 * S - _EPS_BIN)
    bin_x = torch.floor(dx_shift / DELTA)
    res_x_norm = (dx_shift - (bin_x + 0.5) * DELTA) / DELTA

    dz_shift = torch.minimum((dz + S).clamp(min=0.0), 2.0 * S - _EPS_BIN)
    bin_z = torch.floor(dz_shift / DELTA)
    res_z_norm = (dz_shift - (bin_z + 0.5) * DELTA) / DELTA

    bin_theta = torch.floor(dtheta_shift / DELTA_THETA)
    res_theta_norm = (dtheta_shift - (bin_theta + 0.5) * DELTA_THETA) / (0.5 * DELTA_THETA)
    return (bin_x.long(), res_x_norm, bin_z.long(), res_z_norm, bin_theta.long(),
            res_theta_norm, dy, dsize / mean_sizes)


def encode_rpn(ref_pts: torch.Tensor, boxes_3d: torch.Tensor, mean_sizes: torch.Tensor,
               S, DELTA, R: float, DELTA_THETA: float, K: int):
    """box_3d -> bin representation around RPN points (no reference heading).

    Args:
      ref_pts: (..., 3); boxes_3d: (..., 7); mean_sizes: (..., 3), the mean
        size of each point's GT class.
    Returns:
      (bin_x, res_x_norm, bin_z, res_z_norm) each (..., K) (bins int64),
      then bin_theta, res_theta_norm, res_y (...,) and res_size_norm (..., 3).
    """
    dx = boxes_3d[..., 0] - ref_pts[..., 0]
    dy = boxes_3d[..., 1] - ref_pts[..., 1]
    dz = boxes_3d[..., 2] - ref_pts[..., 2]
    dsize = boxes_3d[..., 3:6] - mean_sizes
    dtheta_shift = torch.clamp(boxes_3d[..., 6] + R, 0.0, 2.0 * R - _EPS_BIN)
    return _encode_common(dx, dz, dtheta_shift, dy, dsize, mean_sizes, S, DELTA, DELTA_THETA, K)
