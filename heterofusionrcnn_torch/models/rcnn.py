"""Stage-2 RCNN (PyTorch port of heterofusionrcnn_tpu/models/rcnn.py
`RcnnModel` and `rcnn_loss`), in the JAX model's three modes:

  - train: the heads and the targets for `rcnn_loss` (no decode, no NMS),
    dropout and path drop in training;
  - val: the same targets, plus the test mode's decode and NMS;
  - test: per proposal the refined box of its predicted class, and a final
    oriented NMS per frame over the non-empty boxes.

Per proposal: a 7x7 image RoI crop (from stage-1's image feature map when
one is passed, the shared-VGG fused mode), a `resize`-point crop of the
stage-1 points in the context-expanded box, the canonical transform and
local MLP, the stage-2 PointCNN, the classification and bin refinement
heads. No gradient reaches the stage-1 features: they are detached, as the
JAX model stops their gradient. BatchNorm, dropout and path drop follow the
module's `training` flag; every random draw comes from a generator the
caller passes ("dropout" and "path_drop", the flax rng streams).

`config.compute_dtype` "bfloat16" serves and trains in bf16 as the RPN
does (`models/rpn.py`): the layers compute in bf16, the heads are cast to
float32 (JAX rcnn.py:221, :234) before the losses; mixed-dtype operands
promote as in JAX (the bilinear image crop of a bf16 map is float32, and
so is the fused vector of bf16 point and float32 image RoI features); the
canonical transform and the crop stay float32, and the handoff's float32
`rpn_fts` are cast at the layers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from heterofusionrcnn_torch.configs.config import ModelConfig
from heterofusionrcnn_torch.core import bin_codec
from heterofusionrcnn_torch.core.geometry import (
    box_3d_to_corners,
    canonical_transform,
    expand_box_3d,
)
from heterofusionrcnn_torch.core.losses import bin_losses, one_hot, weighted_softmax_ce
from heterofusionrcnn_torch.core.projection import (
    boxes_2d_to_yxyx,
    project_boxes_to_image_space,
)
from heterofusionrcnn_torch.models.extractors.img_vgg_pyr import (
    ImgVgg,
    ImgVggPyr,
    preprocess_image,
)
from heterofusionrcnn_torch.models.extractors.layers import DenseBN, dropout
from heterofusionrcnn_torch.models.extractors.pointcnn import PointCNN
from heterofusionrcnn_torch.models.rpn import (
    bin_params,
    compute_dtype,
    create_path_drop_masks,
    decode_bins,
    parse_bin_head,
    take_bin,
    take_class,
)
from heterofusionrcnn_torch.ops.cropping import pc_crop_and_sample
from heterofusionrcnn_torch.ops.image_crop import crop_and_resize
from heterofusionrcnn_torch.ops.nms import oriented_nms_boxes_3d
from heterofusionrcnn_torch.parallel.mesh import all_reduce_sum
from heterofusionrcnn_torch.runtime import tracing


class RcnnModel(nn.Module):
    """Stage-2 box refinement network. `mode`: "train", "val" or "test"."""

    def __init__(self, config: ModelConfig, num_classes: int,
                 cluster_sizes: Sequence[Tuple[float, float, float]],
                 rpn_fts_channels: int, bev_z_max: float = 70.0,
                 conv_kernels: bool = False, crop_kernel: bool = False,
                 mode: str = "test", cls_neg_iou_hi: float = 0.45,
                 cls_pos_iou_lo: float = 0.60, reg_pos_iou_lo: float = 0.55):
        """`rpn_fts_channels`: width of the stage-1 per-point features the
        RCNN crops (point features + gathered image features).
        `conv_kernels`: the image branch's 3x3 convs through the fused
        kernels of `ops/conv.py` (eval mode); `crop_kernel`: the point crop's
        feature rows through `ops/cropping.crop_gather`. The IoU thresholds
        of the targets come from the dataset's mini-batch config: a
        proposal below `cls_neg_iou_hi` is background, above
        `cls_pos_iou_lo` its GT's class, and above `reg_pos_iou_lo` it
        regresses its GT box."""
        super().__init__()
        lc = config.layers_config
        rc = config.rcnn_config
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown mode {mode!r}")
        self.dtype = compute_dtype(config)
        dt = dict(dtype=self.dtype)
        self.config = config
        self.num_classes = num_classes
        self.bev_z_max = bev_z_max
        self.mode = mode
        self.cls_neg_iou_hi = cls_neg_iou_hi
        self.cls_pos_iou_lo = cls_pos_iou_lo
        self.reg_pos_iou_lo = reg_pos_iou_lo
        # The data-parallel group of the dropout draws and `cls_accuracy`
        # (`parallel.mesh.set_data_parallel_group`); None: one process.
        self.dp_group = None
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
        self.img_vgg_pyr = img_cls(lc.img_vgg_pyr, conv_kernels=conv_kernels, **dt)
        self.crop_kernel = crop_kernel
        c_img = lc.img_vgg_pyr.vgg_conv1[1] if img_cls is ImgVggPyr else lc.img_vgg_pyr.vgg_conv4[1]

        c = 6 if rc.rcnn_use_intensity_feature else 5
        for i, fc in enumerate(lc.rcnn_mlp_layers):
            self.add_module(f"mlp{i}", DenseBN(c, fc.C, **dt))
            c = fc.C
        self.pc_pointcnn = PointCNN(lc.rcnn_pc_pointcnn, rpn_fts_channels + c, **dt)

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
                self.add_module(f"{prefix}{i}", DenseBN(c, fc.C, **dt))
                c = fc.C
        self.cls_logits = DenseBN(c, k + 1, use_bn=False, activation=False, **dt)
        out_dim = (nbx * 2 + nbz * 2 + nbt * 2 + 4) * k
        self.reg_output = DenseBN(c, out_dim, use_bn=False, activation=False, **dt)

    @tracing.spanned("rcnn")
    def forward(self, proposals, rpn_pts, rpn_intensity, rpn_fg_mask, rpn_fts,
                img_input, calib_p2,
                img_feature_map: Optional[torch.Tensor] = None,
                proposals_iou: Optional[torch.Tensor] = None,
                proposals_gt: Optional[torch.Tensor] = None,
                generators: Optional[Dict[str, torch.Generator]] = None) -> Dict[str, torch.Tensor]:
        """proposals (B, n, 7); rpn_pts (B, P, 3); rpn_intensity (B, P);
        rpn_fg_mask (B, P); rpn_fts (B, P, C); img_input (B, H, W, 3) NHWC;
        calib_p2 (B, 3, 4); img_feature_map (B, H, W, C1) or None; in train
        and val mode proposals_iou (B, n), each proposal's 3D IoU with its
        GT box, and proposals_gt (B, n, 8), that box and its class (0
        background, 1..K). `generators`: {"dropout", "path_drop"} in
        training."""
        cfg = self.config
        rc = cfg.rcnn_config
        lc = cfg.layers_config
        gens = generators or {}
        b, n = proposals.shape[:2]
        nb = b * n
        k = self.num_classes
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins
        if self.mode in ("train", "val") and (proposals_iou is None or proposals_gt is None):
            raise ValueError(f"{self.mode} mode needs proposals_iou and proposals_gt")

        # No gradient into the stage-1 features (the reference's crop op has
        # no gradient registered).
        rpn_fts = rpn_fts.detach()
        if img_feature_map is not None:
            img_fts = img_feature_map.detach()
        else:
            with tracing.span("rcnn.img_vgg"):
                img_fts = self.img_vgg_pyr(preprocess_image(img_input))

        with tracing.span("rcnn.img_crop"):
            box_ind = torch.arange(b, device=proposals.device).repeat_interleave(n)
            _, boxes2d_norm = project_boxes_to_image_space(
                proposals, calib_p2, img_input.shape[2], img_input.shape[1]
            )
            img_rois = crop_and_resize(
                img_fts, boxes_2d_to_yxyx(boxes2d_norm.reshape(nb, 4)), box_ind,
                rc.rcnn_proposal_roi_img_crop_size,
            )  # (Nb, r1, r1, C1)

        with tracing.span("rcnn.pc_crop"):
            flat_proposals = proposals.reshape(nb, 7)
            expanded = expand_box_3d(flat_proposals, rc.rcnn_pooling_context_length)
            crop_pts, crop_fts, crop_int, crop_mask, _, non_empty = pc_crop_and_sample(
                rpn_pts, rpn_fts, rpn_intensity[..., None], rpn_fg_mask,
                box_3d_to_corners(expanded), box_ind, rc.rcnn_proposal_roi_crop_size,
                crop_kernel=self.crop_kernel,
            )

            crop_pts_ct = canonical_transform(crop_pts, flat_proposals)
            crop_distance = (torch.sqrt(torch.sum(crop_pts * crop_pts, dim=-1)) / self.bev_z_max
                             - 0.5)
        with tracing.span("rcnn.pc_encoder"):
            parts = [crop_pts_ct]
            if rc.rcnn_use_intensity_feature:
                parts.append(crop_int)
            parts += [crop_mask[..., None], crop_distance[..., None]]
            x = self._stack("mlp", lc.rcnn_mlp_layers, torch.cat(parts, dim=-1), gens)

            merged = torch.cat([crop_fts, x], dim=-1)
            _, pc_rois = self.pc_pointcnn(crop_pts_ct, merged, gens.get("dropout"))  # (Nb, r, C')

        with tracing.span("rcnn.head"):
            p_img, p_pc = cfg.path_drop_probabilities
            if self.training and not (p_img == p_pc == 1.0):
                if "path_drop" not in gens:
                    raise ValueError("path drop in training needs a 'path_drop' generator")
                uniforms = torch.rand(3, generator=gens["path_drop"], device=proposals.device)
                img_mask, pc_mask = create_path_drop_masks(p_img, p_pc, uniforms)
                pc_rois = pc_rois * pc_mask
                img_rois = img_rois * img_mask

            if rc.rcnn_fusion_method == "mean_concat":
                fuse = torch.cat([pc_rois.mean(1), img_rois.mean((1, 2))], dim=-1)
            else:
                fuse = torch.cat([pc_rois.reshape(nb, -1), img_rois.reshape(nb, -1)], dim=-1)

            cls_logits = self.cls_logits(
                self._stack("cls_fc", lc.rcnn_fc_layers, fuse, gens)).float()
            cls_softmax = torch.softmax(cls_logits, dim=-1)  # (Nb, K+1)
            out = self.reg_output(self._stack("reg_fc", lc.rcnn_fc_layers, fuse, gens)).float()
            out = out.reshape(nb, k, -1)
            fields = parse_bin_head(out, nbx, nbz, nbt)

        predictions = {
            "cls_softmax": cls_softmax.reshape(b, n, k + 1),
            "non_empty_box_mask": non_empty.reshape(b, n),
        }
        if self.mode in ("val", "test"):
            with tracing.span("rcnn.final_boxes"):
                predictions.update(self._final_boxes(fields, flat_proposals, cls_softmax,
                                                     non_empty, b))
        if self.mode in ("train", "val"):
            with tracing.span("rcnn.targets"):
                predictions.update(self._targets(fields, flat_proposals, cls_logits, non_empty,
                                                 proposals_iou.reshape(nb),
                                                 proposals_gt.reshape(nb, 8)))
        return predictions

    def _stack(self, prefix, layers, x, gens):
        """The DenseBN layers `<prefix>0..`, each followed in training by
        its dropout (a draw from gens["dropout"])."""
        for i, fc in enumerate(layers):
            x = getattr(self, f"{prefix}{i}")(x)
            if self.training:
                x = dropout(x, fc.dropout_rate, gens.get("dropout"), self.dp_group)
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
        reg_boxes = take_class(reg_boxes, cls_fg_preds)

        batch_boxes = reg_boxes.reshape(b, n, 7)
        with tracing.span("rcnn.nms"):
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
        }

    def _targets(self, fields, flat_proposals, cls_logits, non_empty, iou, gt):
        """Targets for `rcnn_loss`: the classification target from each
        proposal's IoU, the bin targets of its GT box relative to it under
        the GT class, and the head's outputs gathered at that class and at
        the GT bins (the reference's mini-batch heads)."""
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins
        k = self.num_classes
        gt_cls = gt[:, 7].long()
        neg_cls_mask = iou < self.cls_neg_iou_hi
        pos_cls_mask = iou > self.cls_pos_iou_lo
        pos_neg_cls_mask = (neg_cls_mask | pos_cls_mask) & non_empty
        cls_gt = torch.where(neg_cls_mask, torch.zeros_like(gt_cls), gt_cls)
        pos_reg_mask = (iou > self.reg_pos_iou_lo) & non_empty

        # Mean size for each proposal's GT class; background takes the mean
        # of the class means.
        size_table = torch.cat([self.cluster_sizes.mean(0, keepdim=True), self.cluster_sizes])
        (bin_x_gt, res_x_gt, bin_z_gt, res_z_gt, bin_theta_gt, res_theta_gt, res_y_gt,
         res_size_gt) = bin_codec.encode_rcnn(
            flat_proposals[:, :3], flat_proposals[:, 6], gt[:, :7],
            size_table[gt_cls.clamp(0, k)], S, DELTA, R, DELTA_THETA, k)
        cls0 = (gt_cls - 1).clamp(0, k - 1)  # 0-based foreground class

        def at_class(t):  # (Nb, K) -> (Nb,); (Nb, K, F) -> (Nb, F)
            return take_class(t[..., None], cls0)[..., 0] if t.dim() == 2 else take_class(t, cls0)

        bin_x_gt, res_x_gt = at_class(bin_x_gt), at_class(res_x_gt)
        bin_z_gt, res_z_gt = at_class(bin_z_gt), at_class(res_z_gt)
        hits = (cls_logits.argmax(-1) == cls_gt) & pos_neg_cls_mask
        if self.dp_group is None:
            accuracy = hits.sum() / pos_neg_cls_mask.sum().clamp(min=1)
        else:  # the global batch's
            n = all_reduce_sum(torch.stack([hits.sum(), pos_neg_cls_mask.sum()]), self.dp_group)
            accuracy = n[0] / n[1].clamp(min=1)
        return {
            "cls_logits": cls_logits,
            "cls_gt_one_hot": one_hot(cls_gt, k + 1),
            "pos_neg_cls_mask": pos_neg_cls_mask,
            "pos_reg_mask": pos_reg_mask,
            "mb_cls_preds": (at_class(fields["bin_x"]), at_class(fields["bin_z"]),
                             at_class(fields["bin_t"])),
            "mb_cls_gts": (one_hot(bin_x_gt, nbx), one_hot(bin_z_gt, nbz),
                           one_hot(bin_theta_gt, nbt)),
            "mb_reg_preds": (take_bin(at_class(fields["res_x"]), bin_x_gt),
                             take_bin(at_class(fields["res_z"]), bin_z_gt),
                             take_bin(at_class(fields["res_t"]), bin_theta_gt),
                             at_class(fields["res_y"]),
                             at_class(fields["res_size"])),
            "mb_reg_gts": (res_x_gt, res_z_gt, res_theta_gt, res_y_gt, res_size_gt),
            "cls_accuracy": accuracy,
        }


def rcnn_loss(predictions: Dict[str, torch.Tensor], config: ModelConfig, group=None):
    """RCNN loss: the softmax classification loss over the proposals of
    the pos | neg mask, normalised by their count, plus the bins'
    cross-entropy and the residuals' smooth L1 over the regression mask,
    normalised by its count (each 0 when its count is 0). With a
    data-parallel `group`, this rank's share: its sums over the global
    batch's counts (`core/losses.py`).

    Returns:
      (loss_dict, total_loss).
    """
    lw = config.loss_config
    cls_mask = predictions["pos_neg_cls_mask"].float()
    num_cls = all_reduce_sum(cls_mask.sum(), group)
    zero = torch.zeros((), device=cls_mask.device)
    cls_loss = (weighted_softmax_ce(predictions["cls_logits"], predictions["cls_gt_one_hot"],
                                    weight=lw.cls_loss_weight) * cls_mask).sum()
    cls_loss = torch.where(num_cls > 0, cls_loss / num_cls.clamp(min=1.0), zero)

    bin_loss, reg_loss = bin_losses(predictions["mb_cls_preds"], predictions["mb_cls_gts"],
                                    predictions["mb_reg_preds"], predictions["mb_reg_gts"],
                                    predictions["pos_reg_mask"].float(), lw, group)
    total = cls_loss + bin_loss + reg_loss
    return {"rcnn_cls_loss": cls_loss, "rcnn_bin_cls_loss": bin_loss,
            "rcnn_reg_loss": reg_loss}, total
