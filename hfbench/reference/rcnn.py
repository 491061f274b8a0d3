"""The stage-2 RCNN in float32 plain PyTorch, test mode, with the port's
module and parameter names (`models/rcnn.py`).

Per proposal: a 7x7 image RoI crop (from stage-1's image feature map when
one is passed, the shared-VGG fused mode), a `resize`-point crop of the
stage-1 points in the context-expanded box, the canonical transform and
local MLP, the stage-2 PointCNN, the classification and bin refinement
heads; then per proposal the refined box of its predicted class, and a
final oriented NMS per frame over the non-empty boxes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from hfbench.reference.config import ModelConfig
from hfbench.reference.geometry import box_3d_to_corners, canonical_transform, expand_box_3d
from hfbench.reference.img_vgg_pyr import ImgVgg, ImgVggPyr, preprocess_image
from hfbench.reference.layers import DenseBN
from hfbench.reference.ops import crop_and_resize, oriented_nms_boxes_3d, pc_crop_and_sample
from hfbench.reference.pointcnn import PointCNN
from hfbench.reference.projection import boxes_2d_to_yxyx, project_boxes_to_image_space
from hfbench.reference.rpn import bin_params, decode_bins, parse_bin_head, take_class


class RcnnModel(nn.Module):
    """Stage-2 box refinement network, test mode."""

    def __init__(self, config: ModelConfig, num_classes: int,
                 cluster_sizes: Sequence[Tuple[float, float, float]],
                 rpn_fts_channels: int, bev_z_max: float = 70.0):
        """`rpn_fts_channels`: width of the stage-1 per-point features the
        RCNN crops (point features + gathered image features)."""
        super().__init__()
        lc = config.layers_config
        rc = config.rcnn_config
        self.config = config
        self.num_classes = num_classes
        self.bev_z_max = bev_z_max
        self.register_buffer(
            "cluster_sizes",
            torch.tensor(cluster_sizes, dtype=torch.float32).reshape(-1, 3),
            persistent=False,
        )
        self.bins = bin_params(rc.rcnn_xz_search_range, rc.rcnn_xz_bin_len,
                               rc.rcnn_theta_search_range, rc.rcnn_theta_bin_num)
        _, _, nbx, nbz, _, _, nbt = self.bins
        k = num_classes
        img_cls = ImgVgg if lc.img_extractor_type == "vgg" else ImgVggPyr
        self.img_vgg_pyr = img_cls(lc.img_vgg_pyr)
        c_img = lc.img_vgg_pyr.vgg_conv1[1] if img_cls is ImgVggPyr else lc.img_vgg_pyr.vgg_conv4[1]

        c = 6 if rc.rcnn_use_intensity_feature else 5
        for i, fc in enumerate(lc.rcnn_mlp_layers):
            self.add_module(f"mlp{i}", DenseBN(c, fc.C))
            c = fc.C
        self.pc_pointcnn = PointCNN(lc.rcnn_pc_pointcnn, rpn_fts_channels + c)

        # Stage-2 PointCNN output points per RoI: the last XConv's P.
        n_out = rc.rcnn_proposal_roi_crop_size
        for lp in lc.rcnn_pc_pointcnn.xconv_layers:
            n_out = n_out if lp.P == -1 else lp.P
        r1 = rc.rcnn_proposal_roi_img_crop_size
        c_pc = self.pc_pointcnn.out_channels
        if rc.rcnn_fusion_method == "mean_concat":
            c_fuse = c_pc + c_img
        elif rc.rcnn_fusion_method == "flat_concat":
            c_fuse = n_out * c_pc + r1 * r1 * c_img
        else:
            raise ValueError(rc.rcnn_fusion_method)
        for prefix in ("cls_fc", "reg_fc"):
            c = c_fuse
            for i, fc in enumerate(lc.rcnn_fc_layers):
                self.add_module(f"{prefix}{i}", DenseBN(c, fc.C))
                c = fc.C
        self.cls_logits = DenseBN(c, k + 1, use_bn=False, activation=False)
        out_dim = (nbx * 2 + nbz * 2 + nbt * 2 + 4) * k
        self.reg_output = DenseBN(c, out_dim, use_bn=False, activation=False)

    def forward(self, proposals, rpn_pts, rpn_intensity, rpn_fg_mask, rpn_fts,
                img_input, calib_p2,
                img_feature_map: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """proposals (B, n, 7); rpn_pts (B, P, 3); rpn_intensity (B, P);
        rpn_fg_mask (B, P); rpn_fts (B, P, C); img_input (B, H, W, 3) NHWC;
        calib_p2 (B, 3, 4); img_feature_map (B, H, W, C1) or None."""
        cfg = self.config
        rc = cfg.rcnn_config
        lc = cfg.layers_config
        b, n = proposals.shape[:2]
        nb = b * n
        k = self.num_classes
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins
        if img_feature_map is not None:
            img_fts = img_feature_map
        else:
            img_fts = self.img_vgg_pyr(preprocess_image(img_input))

        box_ind = torch.arange(b, device=proposals.device).repeat_interleave(n)
        _, boxes2d_norm = project_boxes_to_image_space(
            proposals, calib_p2, img_input.shape[2], img_input.shape[1]
        )
        img_rois = crop_and_resize(
            img_fts, boxes_2d_to_yxyx(boxes2d_norm.reshape(nb, 4)), box_ind,
            rc.rcnn_proposal_roi_img_crop_size,
        )  # (Nb, r1, r1, C1)

        flat_proposals = proposals.reshape(nb, 7)
        expanded = expand_box_3d(flat_proposals, rc.rcnn_pooling_context_length)
        crop_pts, crop_fts, crop_int, crop_mask, _, non_empty = pc_crop_and_sample(
            rpn_pts, rpn_fts, rpn_intensity[..., None], rpn_fg_mask,
            box_3d_to_corners(expanded), box_ind, rc.rcnn_proposal_roi_crop_size,
        )

        crop_pts_ct = canonical_transform(crop_pts, flat_proposals)
        crop_distance = torch.sqrt(torch.sum(crop_pts * crop_pts, dim=-1)) / self.bev_z_max - 0.5
        parts = [crop_pts_ct]
        if rc.rcnn_use_intensity_feature:
            parts.append(crop_int)
        parts += [crop_mask[..., None], crop_distance[..., None]]
        x = self._stack("mlp", lc.rcnn_mlp_layers, torch.cat(parts, dim=-1))

        merged = torch.cat([crop_fts, x], dim=-1)
        _, pc_rois = self.pc_pointcnn(crop_pts_ct, merged)  # (Nb, r, C')

        if rc.rcnn_fusion_method == "mean_concat":
            fuse = torch.cat([pc_rois.mean(1), img_rois.mean((1, 2))], dim=-1)
        else:
            fuse = torch.cat([pc_rois.reshape(nb, -1), img_rois.reshape(nb, -1)], dim=-1)

        cls_logits = self.cls_logits(self._stack("cls_fc", lc.rcnn_fc_layers, fuse))
        cls_softmax = torch.softmax(cls_logits, dim=-1)  # (Nb, K+1)
        out = self.reg_output(self._stack("reg_fc", lc.rcnn_fc_layers, fuse))
        out = out.reshape(nb, k, -1)
        fields = parse_bin_head(out, nbx, nbz, nbt)

        predictions = {
            "cls_softmax": cls_softmax.reshape(b, n, k + 1),
            "non_empty_box_mask": non_empty.reshape(b, n),
        }
        predictions.update(self._final_boxes(fields, flat_proposals, cls_softmax, non_empty, b))
        return predictions

    def _stack(self, prefix, layers, x):
        """The DenseBN layers `<prefix>0..`."""
        for i, _ in enumerate(layers):
            x = getattr(self, f"{prefix}{i}")(x)
        return x

    def _final_boxes(self, fields, flat_proposals, cls_softmax, non_empty, b):
        """Decode each proposal's box of its predicted class, run oriented
        NMS per frame over the non-empty ones and pick the kept boxes with
        their class and score."""
        rc = self.config.rcnn_config
        S, DELTA, _, _, R, DELTA_THETA, _ = self.bins
        nb, k = flat_proposals.shape[0], self.num_classes
        n = nb // b
        cls_fg_preds = cls_softmax[:, 1:].argmax(-1)
        cls_scores = cls_softmax[:, 1:].amax(-1)
        mean_sizes = self.cluster_sizes.expand(nb, k, 3)
        reg_boxes = decode_bins(fields, flat_proposals[:, :3], flat_proposals[:, 6],
                                mean_sizes, S, DELTA, R, DELTA_THETA)  # (Nb, K, 7)
        candidates = reg_boxes
        reg_boxes = take_class(reg_boxes, cls_fg_preds)

        batch_boxes = reg_boxes.reshape(b, n, 7)
        nms_idx, nms_valid = oriented_nms_boxes_3d(
            batch_boxes, cls_scores.reshape(b, n), rc.rcnn_nms_iou_thresh,
            rc.rcnn_nms_size, valid_mask=non_empty.reshape(b, n),
        )
        safe = nms_idx.clamp(min=0).long()
        final_boxes = batch_boxes.gather(1, safe[..., None].expand(-1, -1, 7))
        final_softmax = cls_softmax.reshape(b, n, k + 1).gather(
            1, safe[..., None].expand(-1, -1, k + 1)
        )
        not_bkg = final_softmax[..., 1:]
        final_types = not_bkg.argmax(-1)
        final_scores = not_bkg.gather(-1, final_types[..., None]).squeeze(-1)
        return {
            "boxes": batch_boxes,
            "nms_indices": nms_idx,
            "nms_valid": nms_valid,
            "num_boxes_before_padding": nms_valid.sum(-1),
            "final_boxes": final_boxes,
            "final_classes": final_types,
            "final_scores": final_scores * nms_valid,
            "final_valid": nms_valid,
            "candidate_boxes": candidates.reshape(b, n, k, 7),
        }
