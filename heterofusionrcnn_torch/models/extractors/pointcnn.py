"""PointCNN feature extractor (PyTorch port of
heterofusionrcnn_tpu/models/extractors/pointcnn.py): an XConv encoder
pyramid and an XDConv decoder back to the input points.

At inference every XConv runs through the fused XConv op
(`ops.xconv.fused_xconv`, the CUDA kernel on the card), as the JAX package
routes inference through its fused Pallas kernel (`_fused_xconv_mode`).
The modules hold the same parameters as the flax tree; `XConv.weights()`
folds them for the fused op, and `XConv.kernel_weights()` keeps that fold
(with the kernel's arranged Wc on the card) until a parameter or buffer
it reads changes; a traced graph (`runtime/export.py`) folds from the
parameters instead. The fused op has no backward: in training, and wherever
autograd is on, an XConv runs its layers one by one (the JAX package's
XLA path), with BatchNorm on batch statistics in training. In eval mode
with autograd on, the CPU takes the same layer-by-layer path (the JAX
package's CPU path); on the card that call raises instead of leaving the
kernel.

With a `sorting_method` ("l2" or "c<permutation of xyz>") an XConv sorts
each neighbourhood after the dilation (`grouping.sort_neighbor_indices`)
and both paths, fused and unfused, take the sorted indices. The query
points of a level come from FPS, from inverse-density sampling ("ids", its
uniforms from the `sampling` generator: no entry point supplies one, as no
JAX entry point supplies the flax "sampling" rng) or are the first P
points ("random").

`dtype` (None: float32; `torch.bfloat16`) is the flax modules' compute
dtype: every layer computes in it (`layers.py`), the fused op runs its bf16
form on features cast to bf16 (the JAX `_fused` path's `fts.astype(cd)`),
and the outputs are bf16. Coordinates, FPS and KNN stay float32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from heterofusionrcnn_torch.configs.config import PointCNNConfig
from heterofusionrcnn_torch.models.extractors.layers import (
    ConvOverK,
    DenseBN,
    DepthwiseConvOverK,
    SeparableConvOverK,
    dropout,
)
from heterofusionrcnn_torch.ops.grouping import group_point, knn_point, sort_neighbor_indices
from heterofusionrcnn_torch.ops.sampling import (
    farthest_point_sample,
    gather_point,
    inverse_density_sampling,
)
from heterofusionrcnn_torch.ops.xconv import (
    XConvWeights,
    fused_xconv,
    xconv_weight_operand,
    xconv_weight_operand_bf16,
)


class XConv(nn.Module):
    """One XConv block: KNN neighbourhood -> lift -> X-transform ->
    separable conv over the neighbours (+ the optional global branch)."""

    def __init__(self, K: int, D: int, C: int, C_pts_fts: int, c_in_fts: int,
                 depth_multiplier: int, with_X_transformation: bool = True,
                 with_global: bool = False, sorting_method: str = "",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.K, self.D, self.C = K, D, C
        self.sorting_method = sorting_method
        self.with_X_transformation = with_X_transformation
        self.with_global = with_global
        self.dtype = dtype
        dt = dict(dtype=dtype)
        self.nn_fts_from_pts_0 = DenseBN(3, C_pts_fts, **dt)
        self.nn_fts_from_pts = DenseBN(C_pts_fts, C_pts_fts, **dt)
        if with_X_transformation:
            self.X_0 = ConvOverK(K, 3, K * K, **dt)
            self.X_1 = DepthwiseConvOverK(K, K, K, **dt)
            self.X_2 = DepthwiseConvOverK(K, K, K, activation=False, **dt)
        self.fts_conv = SeparableConvOverK(K, C_pts_fts + c_in_fts, C, depth_multiplier, **dt)
        if with_global:
            self.fts_global_0 = DenseBN(3, C // 4, **dt)
            self.fts_global = DenseBN(C // 4, C // 4, **dt)
        self._folded = None  # (key, XConvWeights) of kernel_weights()
        self.weight_folds = 0  # folds made by kernel_weights()

    @property
    def out_channels(self) -> int:
        return self.C + (self.C // 4 if self.with_global else 0)

    def weights(self) -> XConvWeights:
        """Inference weights with the BatchNorms folded."""
        def lin(dense_bn):
            s, t = dense_bn.BatchNorm_0.folded()
            return dense_bn.Dense_0.weight.t(), s, t

        w1, s1, b1 = lin(self.nn_fts_from_pts_0)
        w2, s2, b2 = lin(self.nn_fts_from_pts)
        sc, bc = self.fts_conv.BatchNorm_0.folded()
        w = XConvWeights(w1, s1, b1, w2, s2, b2, self.fts_conv.composed_weight(), sc, bc)
        if self.with_X_transformation:
            w.wx0, w.sx0, w.bx0 = lin(self.X_0.DenseBN_0)
            w.wx1 = self.X_1.depthwise
            w.sx1, w.bx1 = self.X_1.BatchNorm_0.folded()
            w.wx2 = self.X_2.depthwise
            w.sx2, w.bx2 = self.X_2.BatchNorm_0.folded()
        return w

    def _folded_tensors(self):
        """Every parameter and buffer `weights()` reads."""
        mods = [self.nn_fts_from_pts_0, self.nn_fts_from_pts, self.fts_conv]
        if self.with_X_transformation:
            mods += [self.X_0, self.X_1, self.X_2]
        return [t for m in mods for t in (*m.parameters(), *m.buffers())]

    def kernel_weights(self) -> XConvWeights:
        """`weights()` with Wc arranged for the kernel of the module's
        dtype where the module lives on the card, kept until the `_version`
        or `data_ptr` of a tensor it reads changes (an in-place update,
        `load_state_dict`, a move to another device). Under `torch.export` or `torch.compile`
        (fake tensors: no data pointer) the fold is computed in the graph
        from the parameters on every call, nothing kept, and the op
        arranges Wc per call."""
        if torch.compiler.is_compiling():
            return self.weights()
        key = tuple((t._version, t.data_ptr()) for t in self._folded_tensors())
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                w = self.weights()
                # Keep no views of the parameters: once a parameter changed
                # in place, a kept view would make the module uncopyable.
                for name, t in vars(w).items():
                    if t is not None and t._base is not None:
                        setattr(w, name, t.clone())
                if w.wc.is_cuda and self.dtype == torch.bfloat16:
                    w.wc_operand_bf16 = xconv_weight_operand_bf16(w.wc, w.w1.shape[1])
                elif w.wc.is_cuda:
                    w.wc_operand = xconv_weight_operand(w.wc, w.w1.shape[1])
            self._folded = (key, w)
            self.weight_folds += 1
        return self._folded[1]

    def unfused(self, pts, fts, qrs, idx):
        """The XConv layer by layer (JAX `XConv.__call__` :91-200):
        neighbour gather and local coordinates, the two lift DenseBNs, the
        X-transform X_0/X_1/X_2 applied to [lifted | neighbour features],
        then the separable conv over the neighbours."""
        b, p, k = idx.shape
        local = group_point(pts, idx) - qrs[:, :, None, :]  # (B, P, K, 3)
        fin = self.nn_fts_from_pts(self.nn_fts_from_pts_0(local))
        if fts is not None:
            fin = torch.cat([fin, group_point(fts, idx)], dim=-1)
        if self.with_X_transformation:
            x0 = self.X_0(local).reshape(b, p, k, k)
            x1 = self.X_1(x0).reshape(b, p, k, k)
            x2 = self.X_2(x1).reshape(b, p, k, k)
            # jnp.einsum promotes mixed operands (bf16 X with float32
            # features) to the wider type.
            dt = torch.promote_types(x2.dtype, fin.dtype)
            fin = torch.einsum("bpkj,bpjc->bpkc", x2.to(dt), fin.to(dt))
        return self.fts_conv(fin)

    def forward(self, pts, fts, qrs, nn_idx=None):
        """pts (B, N, 3), fts (B, N, Cp) or None, qrs (B, P, 3), optional
        precomputed (B, P, K*D) KNN indices -> (B, P, out_channels). Runs
        `unfused` in training and the fused op in eval mode. An eval call
        that autograd would differentiate runs `unfused` on the CPU and
        raises on the card, where the fused kernel has no backward."""
        if nn_idx is None:
            _, nn_idx = knn_point(self.K * self.D, pts, qrs)
        idx = nn_idx[:, :, :: self.D] if self.D > 1 else nn_idx
        if self.sorting_method:
            idx = sort_neighbor_indices(pts, idx, self.sorting_method)
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (pts, fts, qrs, *self._folded_tensors()) if t is not None)
        if self.training or (wants_grad and not pts.is_cuda):
            out = self.unfused(pts, fts, qrs, idx)
        elif wants_grad:
            raise RuntimeError(
                "the fused XConv kernel has no backward: call an eval-mode "
                "forward on the card under torch.no_grad(), or train() the module")
        elif self.dtype is None:
            out = fused_xconv(pts, fts, qrs, idx.contiguous(), self.kernel_weights())
        else:
            out = fused_xconv(pts, None if fts is None else fts.to(self.dtype), qrs,
                              idx.contiguous(), self.kernel_weights(), self.dtype)
        if self.with_global:
            g = self.fts_global(self.fts_global_0(qrs))
            return torch.cat([g, out], dim=-1)
        return out


class PointCNN(nn.Module):
    """Config-driven XConv encoder + XDConv decoder.

    forward(points (B, N, 3), features (B, N, Cf) or None) ->
    (points (B, P_out, 3), features (B, P_out, C_out))."""

    def __init__(self, config: PointCNNConfig, in_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if config.sampling not in ("fps", "ids", "random"):
            raise ValueError(f"unknown sampling {config.sampling}")
        self.config = config
        self.dp_group = None  # the data-parallel group of the fc dropout draws
        dt = dict(dtype=dtype)
        xconvs, xdconvs = config.xconv_layers, config.xdconv_layers
        out_ch: List[int] = [in_channels]
        for i, lp in enumerate(xconvs):
            if i == 0:
                c_pts_fts = lp.C // 2 if in_channels == 0 else lp.C // 4
                dm = 4
            else:
                c_pts_fts = xconvs[i - 1].C // 4
                dm = math.ceil(lp.C / xconvs[i - 1].C)
            layer = XConv(
                lp.K, lp.D, lp.C, c_pts_fts, out_ch[-1], dm,
                config.with_X_transformation,
                config.with_global and i == len(xconvs) - 1,
                config.sorting_method, **dt,
            )
            self.add_module(f"xconv_{i + 1}", layer)
            out_ch.append(layer.out_channels)
        for i, lp in enumerate(xdconvs):
            tag = f"xdconv_{i + 1}"
            c_fts = out_ch[lp.pts_layer_idx + 1] if i == 0 else out_ch[-1]
            c = xconvs[lp.qrs_layer_idx].C
            c_prev = xconvs[lp.pts_layer_idx].C
            self.add_module(tag, XConv(
                lp.K, lp.D, c, c_prev // 4, c_fts, 1,
                config.with_X_transformation, False, config.sorting_method, **dt,
            ))
            self.add_module(tag + "_fuse", DenseBN(c + out_ch[lp.qrs_layer_idx + 1], c, **dt))
            out_ch.append(c)
        for i, fc in enumerate(config.fc_layers):
            self.add_module(f"fc{i}", DenseBN(out_ch[-1], fc.C, **dt))
            out_ch.append(fc.C)
        self.out_channels = out_ch[-1]

    def forward(self, points: torch.Tensor, features: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                sampling: Optional[torch.Generator] = None):
        """`generator`: the dropout draws of the fc layers in training;
        `sampling`: the uniforms of "ids" sampling (the flax "sampling"
        rng), which it needs in every mode."""
        cfg = self.config
        xconvs = cfg.xconv_layers
        layer_pts = [points]
        layer_fts = [features]

        # KNN cache keyed by tensor identity: the first XConv and the last
        # XDConv query the same full point set. A query set drawn from a
        # candidate set (by FPS, ids or the first P points) takes its rows of
        # that set's same-set KNN (same candidates, same tie rule) instead of
        # a fresh scan.
        knn_cache = {}
        subset_of = {}

        def cached_knn(pts, qrs, k):
            key = (id(pts), id(qrs), k)
            if key not in knn_cache:
                parent = subset_of.get(id(qrs))
                same = (
                    knn_cache.get((id(pts), id(pts), k))
                    if parent is not None and parent[0] == id(pts)
                    else None
                )
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
                if cfg.sampling == "fps":
                    sidx = farthest_point_sample(pts, lp.P)
                elif cfg.sampling == "ids":
                    if sampling is None:
                        raise ValueError("ids sampling needs a 'sampling' generator")
                    sidx = inverse_density_sampling(pts, lp.K, lp.P, sampling)
                else:  # "random": the first P points
                    sidx = torch.arange(lp.P, dtype=torch.int32, device=pts.device).expand(
                        pts.shape[0], lp.P)
                qrs = pts[:, :lp.P] if cfg.sampling == "random" else gather_point(pts, sidx)
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
            fused = getattr(self, tag + "_fuse")(torch.cat([out, fts_qrs], dim=-1))
            layer_pts.append(qrs)
            layer_fts.append(fused)

        output_fts = layer_fts[-1]
        for i, fc in enumerate(cfg.fc_layers):
            output_fts = getattr(self, f"fc{i}")(output_fts)
            if self.training:
                output_fts = dropout(output_fts, fc.dropout_rate, generator, self.dp_group)
        return layer_pts[-1], output_fts
