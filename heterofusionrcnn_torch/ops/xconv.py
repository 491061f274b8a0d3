"""Fused inference XConv.

Port of heterofusionrcnn_tpu/ops/pallas_xconv.py (`fused_xconv`): the whole
XConv block after the KNN (neighbour gather, the two lift DenseBNs, the
K x K X-transform, X applied to [lifted coords | neighbour features], the
composed separable conv, ELU and the folded output BatchNorm). On CUDA
tensors it launches the kernel of `csrc/xconv.cu`, which gathers the
neighbours itself and keeps every (P, K, C) intermediate on chip; on CPU
tensors `fused_xconv_plain` runs the same algebra with PyTorch ops.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch
import torch.nn.functional as F_

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, pointers, use_kernel
from heterofusionrcnn_torch.ops.grouping import group_point

XCONV_KERNEL = CudaKernel(
    "xconv.cu", {"hfr_xconv": [P] * 23 + [I] * 8}, exact=False
)

_KERNEL_K = (4, 8, 12)


@dataclass
class XConvWeights:
    """Inference weights of one XConv, BatchNorms folded to y = x * s + t.

    w1 (3, Cf), w2 (Cf, Cf): lift Dense kernels; wx0 (3K, K*K): X_0 Dense
    kernel; wx1, wx2 (K, K, K): X_1/X_2 depthwise kernels (None without the
    X-transform); wc (K, Cin, D): depthwise x pointwise composition of the
    separable conv, Cin = Cf + Cp with the lifted channels first."""

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    wc: torch.Tensor
    sc: torch.Tensor
    bc: torch.Tensor
    wx0: Optional[torch.Tensor] = None
    sx0: Optional[torch.Tensor] = None
    bx0: Optional[torch.Tensor] = None
    wx1: Optional[torch.Tensor] = None
    sx1: Optional[torch.Tensor] = None
    bx1: Optional[torch.Tensor] = None
    wx2: Optional[torch.Tensor] = None
    sx2: Optional[torch.Tensor] = None
    bx2: Optional[torch.Tensor] = None

    @property
    def with_x(self) -> bool:
        return self.wx0 is not None


def fused_xconv(
    pts: torch.Tensor,
    fts: Optional[torch.Tensor],
    qrs: torch.Tensor,
    idx: torch.Tensor,
    w: XConvWeights,
) -> torch.Tensor:
    """XConv forward at inference.

    Args:
      pts: (B, N, 3) source points; fts: (B, N, Cp) source features or None.
      qrs: (B, P, 3) query points; idx: (B, P, K) int32 neighbour indices.
    Returns:
      (B, P, D) float32.
    """
    if not use_kernel(pts, qrs, idx):
        return fused_xconv_plain(pts, fts, qrs, idx, w)
    b, n, _ = pts.shape
    _, p, k = idx.shape
    cf = w.w1.shape[1]
    cp = 0 if fts is None else fts.shape[-1]
    d = w.wc.shape[2]
    if k not in _KERNEL_K or d % 4:
        raise ValueError(f"xconv kernel takes K in {_KERNEL_K} and D % 4 == 0, got K={k} D={d}")
    if w.wc.shape[1] != cf + cp:
        raise ValueError(f"weights for Cin={w.wc.shape[1]}, inputs give {cf + cp}")
    for t in [pts, fts, qrs] + [getattr(w, f.name) for f in fields(w)]:
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"xconv kernel takes float32, got {t.dtype}")
    pts, qrs, idx = pts.contiguous(), qrs.contiguous(), idx.to(torch.int32).contiguous()
    fts = None if fts is None else fts.contiguous()
    out = torch.empty((b, p, d), dtype=torch.float32, device=pts.device)
    ws = [w.w1, w.s1, w.b1, w.w2, w.s2, w.b2, w.wx0, w.sx0, w.bx0,
          w.wx1, w.sx1, w.bx1, w.wx2, w.sx2, w.bx2, w.wc, w.sc, w.bc]
    ws = [None if t is None else t.contiguous() for t in ws]
    XCONV_KERNEL.launch(
        "hfr_xconv", *pointers(pts, fts, qrs, idx, *ws, out),
        I(b), I(n), I(p), I(k), I(cf), I(cp), I(d), I(int(w.with_x)),
    )
    return out


def fused_xconv_plain(pts, fts, qrs, idx, w: XConvWeights) -> torch.Tensor:
    """Plain PyTorch version of the fused XConv (same algebra as the kernel
    and as `pallas_xconv.fused_xconv`)."""
    b, p, k = idx.shape
    local = group_point(pts, idx) - qrs[:, :, None, :]  # (B, P, K, 3)
    h = F_.elu(local @ w.w1) * w.s1 + w.b1
    f2 = F_.elu(h @ w.w2) * w.s2 + w.b2
    fin = f2 if fts is None else torch.cat([f2, group_point(fts, idx)], dim=-1)
    if w.with_x:
        x0 = F_.elu(local.reshape(b, p, 3 * k) @ w.wx0) * w.sx0 + w.bx0
        x1 = torch.einsum("bpkc,kcj->bpcj", x0.reshape(b, p, k, k), w.wx1)
        x1 = F_.elu(x1.reshape(b, p, k * k)) * w.sx1 + w.bx1
        x2 = torch.einsum("bpkc,kcj->bpcj", x1.reshape(b, p, k, k), w.wx2)
        x2 = x2.reshape(b, p, k * k) * w.sx2 + w.bx2
        fin = torch.einsum("bpkj,bpjc->bpkc", x2.reshape(b, p, k, k), fin)
    cin = fin.shape[-1]
    out = fin.reshape(b, p, k * cin) @ w.wc.reshape(k * cin, -1)
    return F_.elu(out) * w.sc + w.bc
