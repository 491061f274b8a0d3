"""PointCNN in float32 plain PyTorch: an XConv encoder pyramid and an
XDConv decoder back to the input points, every XConv layer by layer
(KNN neighbourhood, the two lift DenseBNs, the X-transform, the separable
conv over the neighbours), query points by FPS. Layer names and channel
arithmetic are the port's (`models/extractors/pointcnn.py`)."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from hfbench.reference.config import PointCNNConfig
from hfbench.reference.layers import ConvOverK, DenseBN, DepthwiseConvOverK, SeparableConvOverK, dropout
from hfbench.reference.ops import farthest_point_sample, gather_point, group_point, knn_point


class XConv(nn.Module):
    """One XConv block: lift -> X-transform -> separable conv over the K
    neighbours (+ the optional global branch)."""

    def __init__(self, K: int, D: int, C: int, C_pts_fts: int, c_in_fts: int,
                 depth_multiplier: int, with_X_transformation: bool = True,
                 with_global: bool = False):
        super().__init__()
        self.K, self.D, self.C = K, D, C
        self.with_X_transformation = with_X_transformation
        self.with_global = with_global
        self.nn_fts_from_pts_0 = DenseBN(3, C_pts_fts)
        self.nn_fts_from_pts = DenseBN(C_pts_fts, C_pts_fts)
        if with_X_transformation:
            self.X_0 = ConvOverK(K, 3, K * K)
            self.X_1 = DepthwiseConvOverK(K, K, K)
            self.X_2 = DepthwiseConvOverK(K, K, K, activation=False)
        self.fts_conv = SeparableConvOverK(K, C_pts_fts + c_in_fts, C, depth_multiplier)
        if with_global:
            self.fts_global_0 = DenseBN(3, C // 4)
            self.fts_global = DenseBN(C // 4, C // 4)

    @property
    def out_channels(self) -> int:
        return self.C + (self.C // 4 if self.with_global else 0)

    def forward(self, pts, fts, qrs, nn_idx):
        b, p, _ = qrs.shape
        idx = nn_idx[:, :, :: self.D] if self.D > 1 else nn_idx
        k = idx.shape[-1]
        local = group_point(pts, idx) - qrs[:, :, None, :]
        fin = self.nn_fts_from_pts(self.nn_fts_from_pts_0(local))
        if fts is not None:
            fin = torch.cat([fin, group_point(fts, idx)], dim=-1)
        if self.with_X_transformation:
            x0 = self.X_0(local).reshape(b, p, k, k)
            x1 = self.X_1(x0).reshape(b, p, k, k)
            x2 = self.X_2(x1).reshape(b, p, k, k)
            fin = torch.einsum("bpkj,bpjc->bpkc", x2, fin)
        out = self.fts_conv(fin)
        if self.with_global:
            return torch.cat([self.fts_global(self.fts_global_0(qrs)), out], dim=-1)
        return out


class PointCNN(nn.Module):
    """forward(points (B, N, 3), features (B, N, Cf) or None) ->
    (points (B, P_out, 3), features (B, P_out, C_out))."""

    def __init__(self, config: PointCNNConfig, in_channels: int):
        super().__init__()
        if config.sampling != "fps" or config.sorting_method:
            raise NotImplementedError("the reference runs FPS sampling, unsorted neighbourhoods")
        self.config = config
        xconvs, xdconvs = config.xconv_layers, config.xdconv_layers
        out_ch: List[int] = [in_channels]
        for i, lp in enumerate(xconvs):
            if i == 0:
                c_pts_fts = lp.C // 2 if in_channels == 0 else lp.C // 4
                dm = 4
            else:
                c_pts_fts = xconvs[i - 1].C // 4
                dm = math.ceil(lp.C / xconvs[i - 1].C)
            layer = XConv(lp.K, lp.D, lp.C, c_pts_fts, out_ch[-1], dm,
                          config.with_X_transformation,
                          config.with_global and i == len(xconvs) - 1)
            self.add_module(f"xconv_{i + 1}", layer)
            out_ch.append(layer.out_channels)
        for i, lp in enumerate(xdconvs):
            tag = f"xdconv_{i + 1}"
            c_fts = out_ch[lp.pts_layer_idx + 1] if i == 0 else out_ch[-1]
            c = xconvs[lp.qrs_layer_idx].C
            c_prev = xconvs[lp.pts_layer_idx].C
            self.add_module(tag, XConv(lp.K, lp.D, c, c_prev // 4, c_fts, 1,
                                       config.with_X_transformation, False))
            self.add_module(tag + "_fuse", DenseBN(c + out_ch[lp.qrs_layer_idx + 1], c))
            out_ch.append(c)
        for i, fc in enumerate(config.fc_layers):
            self.add_module(f"fc{i}", DenseBN(out_ch[-1], fc.C))
            out_ch.append(fc.C)
        self.out_channels = out_ch[-1]

    def forward(self, points: torch.Tensor, features: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        xconvs = cfg.xconv_layers
        layer_pts = [points]
        layer_fts = [features]
        # A query set drawn from a candidate set by FPS takes its rows of
        # that set's same-set KNN (the same candidates and tie rule).
        knn_cache, subset_of = {}, {}

        def cached_knn(pts, qrs, k):
            key = (id(pts), id(qrs), k)
            if key not in knn_cache:
                parent = subset_of.get(id(qrs))
                same = (knn_cache.get((id(pts), id(pts), k))
                        if parent is not None and parent[0] == id(pts) else None)
                if same is not None:
                    sidx = parent[1].long()[:, :, None].expand(-1, -1, k)
                    knn_cache[key] = torch.gather(same, 1, sidx)
                else:
                    knn_cache[key] = knn_point(k, pts, qrs)[1]
            return knn_cache[key]

        for i, lp in enumerate(xconvs):
            pts, fts = layer_pts[-1], layer_fts[-1]
            if lp.P == -1 or (i > 0 and lp.P == xconvs[i - 1].P):
                qrs = pts
            else:
                sidx = farthest_point_sample(pts, lp.P)
                qrs = gather_point(pts, sidx)
                subset_of[id(qrs)] = (id(pts), sidx)
            layer_pts.append(qrs)
            nn_idx = cached_knn(pts, qrs, lp.K * lp.D)
            layer_fts.append(getattr(self, f"xconv_{i + 1}")(pts, fts, qrs, nn_idx))

        for i, lp in enumerate(cfg.xdconv_layers):
            tag = f"xdconv_{i + 1}"
            pts = layer_pts[lp.pts_layer_idx + 1]
            fts = layer_fts[lp.pts_layer_idx + 1] if i == 0 else layer_fts[-1]
            qrs = layer_pts[lp.qrs_layer_idx + 1]
            fts_qrs = layer_fts[lp.qrs_layer_idx + 1]
            nn_idx = cached_knn(pts, qrs, lp.K * lp.D)
            out = getattr(self, tag)(pts, fts, qrs, nn_idx)
            layer_pts.append(qrs)
            layer_fts.append(getattr(self, tag + "_fuse")(torch.cat([out, fts_qrs], dim=-1)))

        output_fts = layer_fts[-1]
        for i, fc in enumerate(cfg.fc_layers):
            output_fts = getattr(self, f"fc{i}")(output_fts)
            if self.training:
                output_fts = dropout(output_fts, fc.dropout_rate, generator)
        return layer_pts[-1], output_fts
