"""Stage-1 RPN, test mode (PyTorch port of
heterofusionrcnn_tpu/models/rpn.py `RpnModel` with mode='test').

PointCNN point features and VGG-pyramid image features, the per-point
image-feature gather, the segmentation head, concat fusion, the bin-based
proposal head and its decode, then per frame: top-k by foreground score and
oriented NMS (all frames in one kernel launch on the card).

Train and val modes (losses, GT encodings, IoU metrics) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from heterofusionrcnn_torch.configs.config import ModelConfig
from heterofusionrcnn_torch.core import bin_codec
from heterofusionrcnn_torch.core.projection import rect_to_image
from heterofusionrcnn_torch.models.extractors.img_vgg_pyr import (
    ImgVgg,
    ImgVggPyr,
    preprocess_image,
)
from heterofusionrcnn_torch.models.extractors.layers import DenseBN
from heterofusionrcnn_torch.models.extractors.pointcnn import PointCNN
from heterofusionrcnn_torch.ops.nms import oriented_nms_boxes_3d


def bin_params(xz_search_range, xz_bin_len, theta_search_range, theta_bin_num):
    S = np.asarray(xz_search_range, np.float32)
    DELTA = np.asarray(xz_bin_len, np.float32)
    num_bin_x = int(2 * S[0] / DELTA[0])
    R = theta_search_range * np.pi
    delta_theta = 2 * R / theta_bin_num
    return S, DELTA, num_bin_x, num_bin_x, R, delta_theta, theta_bin_num


def parse_bin_head(out: torch.Tensor, nbx: int, nbz: int, nbt: int):
    """Split (..., K, C) head outputs into the bin fields (same channel
    order as the JAX parse)."""
    fields = {}
    o = 0
    for name, width in (("bin_x", nbx), ("res_x", nbx), ("bin_z", nbz),
                        ("res_z", nbz), ("bin_t", nbt), ("res_t", nbt)):
        fields[name] = out[..., o:o + width]
        o += width
    fields["res_y"] = out[..., o]
    fields["res_size"] = out[..., o + 1:o + 4]
    return fields


def decode_bins(fields, ref_pts, ref_theta, mean_sizes, S, DELTA, R, DELTA_THETA):
    """Argmax bins, pick their residuals, decode -> (..., K, 7) boxes."""
    bin_x = fields["bin_x"].argmax(-1)
    bin_z = fields["bin_z"].argmax(-1)
    bin_t = fields["bin_t"].argmax(-1)

    def pick(res, bins):
        return res.gather(-1, bins[..., None]).squeeze(-1)

    return bin_codec.decode(
        ref_pts, ref_theta,
        bin_x, pick(fields["res_x"], bin_x),
        bin_z, pick(fields["res_z"], bin_z),
        bin_t, pick(fields["res_t"], bin_t),
        fields["res_y"], fields["res_size"], mean_sizes, S, DELTA, R, DELTA_THETA,
    )


def take_class(x: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """x (..., K, F) by cls (...) -> (..., F)."""
    idx = cls[..., None, None].expand(*cls.shape, 1, x.shape[-1])
    return x.gather(-2, idx).squeeze(-2)


def descending_order(scores: torch.Tensor) -> torch.Tensor:
    """Indices sorting each row by descending score, the lower index first
    on ties (`jax.lax.top_k`'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


class RpnModel(nn.Module):
    """Stage-1 proposal network, test mode."""

    def __init__(self, config: ModelConfig, num_classes: int,
                 cluster_sizes: Sequence[Tuple[float, float, float]],
                 save_rpn_feature: bool = True, conv_kernels: bool = False):
        """`conv_kernels`: run the image branch's 3x3 convs through the fused
        kernels of `ops/conv.py` (eval mode)."""
        super().__init__()
        lc = config.layers_config
        rpn = config.rpn_config
        if lc.pc_extractor_type != "pointcnn":
            raise NotImplementedError("only the PointCNN point extractor is ported")
        if not rpn.rpn_fixed_num_proposal_nms:
            raise NotImplementedError("the non-fixed NMS path is not ported")
        if config.compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype {config.compute_dtype!r} is not ported")
        self.config = config
        self.num_classes = num_classes
        self.save_rpn_feature = save_rpn_feature
        self.register_buffer(
            "cluster_sizes",
            torch.tensor(cluster_sizes, dtype=torch.float32).reshape(-1, 3),
            persistent=False,
        )
        self.bins = bin_params(rpn.rpn_xz_search_range, rpn.rpn_xz_bin_len,
                               rpn.rpn_theta_search_range, rpn.rpn_theta_bin_num)
        _, _, nbx, nbz, _, _, nbt = self.bins
        k = num_classes
        c_in = 1 if rpn.rpn_use_intensity_feature else 0
        self.pc_pointcnn = PointCNN(lc.pc_pointcnn, c_in)
        img_cls = ImgVgg if lc.img_extractor_type == "vgg" else ImgVggPyr
        self.img_vgg_pyr = img_cls(lc.img_vgg_pyr, conv_kernels=conv_kernels)
        c_pc = self.pc_pointcnn.out_channels
        c_img = lc.img_vgg_pyr.vgg_conv1[1] if img_cls is ImgVggPyr else lc.img_vgg_pyr.vgg_conv4[1]
        self.seg_logits = DenseBN(c_pc, k + 1, use_bn=False, activation=False)
        c = c_pc + c_img if rpn.rpn_fusion_method == "concat" else c_pc
        for i, fc in enumerate(lc.rpn_fc_layers):
            self.add_module(f"fc{i}", DenseBN(c, fc.C))
            c = fc.C
        out_dim = (nbx * 2 + nbz * 2 + nbt * 2 + 4) * k
        self.fc_output = DenseBN(c, out_dim, use_bn=False, activation=False)

    def forward(self, pc_input, img_input, calib_p2) -> Dict[str, torch.Tensor]:
        """pc_input (B, P, 4), img_input (B, H, W, 3) NHWC, calib_p2 (B, 3, 4)."""
        cfg = self.config
        rpn_cfg = cfg.rpn_config
        b, p = pc_input.shape[:2]
        k = self.num_classes
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins

        pc_pts = pc_input[..., :3]
        pc_intensity = pc_input[..., 3:4]
        pc_pts_out, pc_fts = self.pc_pointcnn(
            pc_pts, pc_intensity if rpn_cfg.rpn_use_intensity_feature else None
        )
        img_fts = self.img_vgg_pyr(preprocess_image(img_input))

        proj = rect_to_image(pc_pts_out, calib_p2)
        h, w = img_fts.shape[1], img_fts.shape[2]
        ds = cfg.layers_config.img_vgg_pyr.downsample
        if ds > 1:
            proj = proj / ds
        u = proj[..., 0].to(torch.int32).clamp(0, w - 1).long()
        v = proj[..., 1].to(torch.int32).clamp(0, h - 1).long()
        bi = torch.arange(b, device=u.device)[:, None]
        proj_img_fts = img_fts[bi, v, u]  # (B, P, C1)

        seg_logits = self.seg_logits(pc_fts)
        seg_softmax = torch.softmax(seg_logits, dim=-1)
        seg_preds = seg_softmax.argmax(-1)
        fg_softmax = seg_softmax[..., 1:]
        seg_scores = fg_softmax.amax(-1)
        seg_fg_preds = fg_softmax.argmax(-1)
        foreground_mask = seg_preds > 0

        if rpn_cfg.rpn_fusion_method == "mean":
            fused = (pc_fts + proj_img_fts) / 2.0
        elif rpn_cfg.rpn_fusion_method == "concat":
            fused = torch.cat([pc_fts, proj_img_fts], dim=-1)
        else:
            raise ValueError(rpn_cfg.rpn_fusion_method)
        x = fused
        for i in range(len(cfg.layers_config.rpn_fc_layers)):
            x = getattr(self, f"fc{i}")(x)
        out = self.fc_output(x).reshape(b, p, k, -1)

        mean_sizes = self.cluster_sizes.expand(b, p, k, 3)
        fields = parse_bin_head(out, nbx, nbz, nbt)
        proposals_all = decode_bins(fields, pc_pts_out, None, mean_sizes,
                                    S, DELTA, R, DELTA_THETA)  # (B, P, K, 7)
        proposals = take_class(proposals_all, seg_fg_preds)  # (B, P, 7)

        pre = min(rpn_cfg.rpn_test_pre_nms_size, p)
        post = rpn_cfg.rpn_test_post_nms_size
        top_idx = descending_order(seg_scores)[:, :pre]
        top_conf = seg_scores.gather(1, top_idx)
        top_props = proposals.gather(1, top_idx[..., None].expand(-1, -1, 7))
        keep, keep_valid = oriented_nms_boxes_3d(
            top_props, top_conf, rpn_cfg.rpn_test_nms_iou_thresh, post
        )
        safe = keep.clamp(min=0).long()
        predictions = {
            "seg_softmax": seg_softmax,
            "seg_preds": seg_preds,
            "foreground_mask": foreground_mask,
            "proposals": top_props.gather(1, safe[..., None].expand(-1, -1, 7)),
            "proposal_scores": top_conf.gather(1, safe) * keep_valid,
            "proposal_valid": keep_valid,
            "num_proposals_before_padding": keep_valid.sum(-1),
        }
        if self.save_rpn_feature:
            predictions.update(
                rpn_pts=pc_pts_out,
                rpn_fts=pc_fts,
                rpn_intensity=pc_intensity,
                rpn_img_fts=proj_img_fts,
                seg_logits=seg_logits,
                img_feature_map=img_fts,
            )
        return predictions
