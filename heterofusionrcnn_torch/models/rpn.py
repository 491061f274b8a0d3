"""Stage-1 RPN (PyTorch port of heterofusionrcnn_tpu/models/rpn.py
`RpnModel` and `rpn_loss`), in the JAX model's three modes:

  - train: the heads and the GT encodings for `rpn_loss` (no decode, no
    NMS), path drop and dropout in training;
  - val: the same GT encodings, plus decode, top-k and oriented NMS with
    the *train* pre/post-NMS sizes and threshold, and the proposals' IoU
    against the GT boxes;
  - test: the foreground mask from the predicted segmentation, proposals
    with the test sizes.

PointCNN (or PointNet++, `pc_extractor_type` "pointnet", always float32
as the JAX `PointNet` has no dtype) point features and VGG-pyramid image
features, the per-point image-feature gather, the segmentation head,
concat (or mean) fusion, the bin-based proposal head and its decode, then
per frame: top-k by foreground score and oriented NMS (all frames in one
kernel launch on the card).
BatchNorm, dropout and path drop follow the module's `training` flag, as
the JAX model's `training` argument (whose default is mode == "train").
Every random draw comes from a generator the caller passes: "dropout" and
"path_drop", the names of the flax rng streams.

`config.compute_dtype` "bfloat16" runs the extractors and the dense layers
in bf16 (mixed precision as flax has it: float32 parameters, gradients and
BatchNorm normalisation, see `extractors/layers.py`) in every mode, the
JAX model's `dtype`; the heads are cast to float32 (JAX rpn.py:218, :294),
so the losses, the bin decode, proposals, NMS, KNN and FPS stay float32,
and the saved stage-1 features (`rpn_fts`, `rpn_img_fts`,
`img_feature_map`) are bf16. Path drop's masks are float32 0-d tensors,
which keep a bf16 feature bf16 under torch's promotion, as JAX's weakly
typed masks do.

With `rpn_fixed_num_proposal_nms` False (JAX rpn.py:236-266, :348-352),
val and test mode resample NUM_FG_POINT foreground points
(`foreground_resample_indices`) before the fusion: every row the bin head
and its targets read follows the resample, the segmentation outputs and
`seg_logits` keep every point, and NMS takes all resampled points' boxes
with no pre-NMS cut.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from heterofusionrcnn_torch.configs.config import ModelConfig
from heterofusionrcnn_torch.core import bin_codec
from heterofusionrcnn_torch.core.losses import bin_losses, one_hot, weighted_focal
from heterofusionrcnn_torch.core.projection import rect_to_image
from heterofusionrcnn_torch.core.rotated_iou import box_3d_iou
from heterofusionrcnn_torch.models.extractors.img_vgg_pyr import (
    ImgVgg,
    ImgVggPyr,
    preprocess_image,
)
from heterofusionrcnn_torch.models.extractors.layers import DenseBN, dropout
from heterofusionrcnn_torch.models.extractors.pointcnn import PointCNN
from heterofusionrcnn_torch.models.extractors.pointnet import PointNet
from heterofusionrcnn_torch.ops.nms import oriented_nms_boxes_3d
from heterofusionrcnn_torch.parallel.mesh import all_reduce_sum, rank_and_size
from heterofusionrcnn_torch.runtime import tracing


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


def take_bin(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """x (..., C) by bins (...) -> (...)."""
    return x.gather(-1, bins[..., None]).squeeze(-1)


def create_path_drop_masks(p_img: float, p_pc: float, random_values: torch.Tensor):
    """Path-drop coin flips from three uniforms: keep each branch with its
    probability; where both die, the third flip revives exactly one.
    Returns (image mask, point mask), float 0-d tensors."""
    img = (random_values[0] < p_img).float()
    pc = (random_values[1] < p_pc).float()
    both_dead = (img + pc) < 0.5
    img_second = (random_values[2] > 0.5).float()
    pc_second = (random_values[2] <= 0.5).float()
    return torch.where(both_dead, img_second, img), torch.where(both_dead, pc_second, pc)


def descending_order(scores: torch.Tensor) -> torch.Tensor:
    """Indices sorting each row by descending score, the lower index first
    on ties (`jax.lax.top_k`'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


# The foreground resample's size on the non-fixed NMS path (JAX rpn.py:70).
NUM_FG_POINT = 2048


def foreground_resample_indices(mask: torch.Tensor, scores: torch.Tensor,
                                npoint: int) -> torch.Tensor:
    """`npoint` indices of each row's True positions (JAX
    `foreground_resample_indices`): the masked points by descending score,
    ties to the lower index (a stable order: wrap-filled duplicates tie
    exactly), a short row wrap-filled by repeating its picks in order, an
    all-False row index 0 throughout. mask (B, P) bool, scores (B, P) ->
    (B, npoint) int32."""
    key = torch.where(mask, scores.float(), torch.full_like(scores, float("-inf"),
                                                            dtype=torch.float32))
    idx = descending_order(key)[:, :npoint]
    count = mask.sum(1, keepdim=True)
    j = torch.arange(npoint, device=mask.device)[None, :]
    wrap = torch.where(count > 0, j % count.clamp(min=1), torch.zeros_like(j))
    return torch.where(j < count, idx, idx.gather(1, wrap)).to(torch.int32)


def point_extractor(config: ModelConfig) -> nn.Module:
    """The RPN's point extractor of `config`: PointCNN (in the config's
    compute dtype) or PointNet++ (float32)."""
    lc = config.layers_config
    if lc.pc_extractor_type == "pointcnn":
        return PointCNN(lc.pc_pointcnn, _pc_in_channels(config), dtype=compute_dtype(config))
    if lc.pc_extractor_type == "pointnet":
        return PointNet(lc.pc_pointnet, _pc_in_channels(config))
    raise ValueError(f"unknown pc_extractor_type {lc.pc_extractor_type!r}")


def rpn_fts_channels(config: ModelConfig) -> int:
    """Width of the per-point features the RPN of `config` hands the RCNN
    (`save_rpn_feature`): its point extractor's output channels plus the
    image features gathered at each point (`vgg_conv1`'s width)."""
    with torch.device("meta"):
        c_pc = point_extractor(config).out_channels
    return c_pc + config.layers_config.img_vgg_pyr.vgg_conv1[1]


def _pc_in_channels(config: ModelConfig) -> int:
    return 1 if config.rpn_config.rpn_use_intensity_feature else 0


def compute_dtype(config: ModelConfig) -> Optional[torch.dtype]:
    """The layers' dtype for `config.compute_dtype`: None (float32) or
    `torch.bfloat16`, in every mode."""
    if config.compute_dtype == "float32":
        return None
    if config.compute_dtype != "bfloat16":
        raise NotImplementedError(f"compute_dtype {config.compute_dtype!r} is not ported")
    return torch.bfloat16


class RpnModel(nn.Module):
    """Stage-1 proposal network. `mode`: "train", "val" or "test"."""

    def __init__(self, config: ModelConfig, num_classes: int,
                 cluster_sizes: Sequence[Tuple[float, float, float]],
                 save_rpn_feature: bool = True, conv_kernels: bool = False,
                 mode: str = "test"):
        """`conv_kernels`: run the image branch's 3x3 convs through the fused
        kernels of `ops/conv.py` (eval mode)."""
        super().__init__()
        lc = config.layers_config
        rpn = config.rpn_config
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown mode {mode!r}")
        self.dtype = compute_dtype(config)
        dt = dict(dtype=self.dtype)
        self.config = config
        self.num_classes = num_classes
        self.save_rpn_feature = save_rpn_feature
        # The data-parallel group of the dropout draws and `seg_accuracy`
        # (`parallel.mesh.set_data_parallel_group`); None: one process.
        self.dp_group = None
        self.mode = mode
        self.register_buffer(
            "cluster_sizes",
            torch.tensor(cluster_sizes, dtype=torch.float32).reshape(-1, 3),
            persistent=False,
        )
        self.bins = bin_params(rpn.rpn_xz_search_range, rpn.rpn_xz_bin_len,
                               rpn.rpn_theta_search_range, rpn.rpn_theta_bin_num)
        _, _, nbx, nbz, _, _, nbt = self.bins
        k = num_classes
        # The flax attribute name: pc_pointcnn or pc_pointnet.
        self.pc_extractor_name = f"pc_{lc.pc_extractor_type}"
        self.add_module(self.pc_extractor_name, point_extractor(config))
        img_cls = ImgVgg if lc.img_extractor_type == "vgg" else ImgVggPyr
        self.img_vgg_pyr = img_cls(lc.img_vgg_pyr, conv_kernels=conv_kernels, **dt)
        c_pc = getattr(self, self.pc_extractor_name).out_channels
        c_img = lc.img_vgg_pyr.vgg_conv1[1] if img_cls is ImgVggPyr else lc.img_vgg_pyr.vgg_conv4[1]
        self.seg_logits = DenseBN(c_pc, k + 1, use_bn=False, activation=False, **dt)
        c = c_pc + c_img if rpn.rpn_fusion_method == "concat" else c_pc
        for i, fc in enumerate(lc.rpn_fc_layers):
            self.add_module(f"fc{i}", DenseBN(c, fc.C, **dt))
            c = fc.C
        out_dim = (nbx * 2 + nbz * 2 + nbt * 2 + 4) * k
        self.fc_output = DenseBN(c, out_dim, use_bn=False, activation=False, **dt)

    @tracing.spanned("rpn")
    def forward(self, pc_input, img_input, calib_p2, label_segs=None, label_regs=None,
                label_boxes=None,
                generators: Optional[Dict[str, torch.Generator]] = None) -> Dict[str, torch.Tensor]:
        """pc_input (B, P, 4), img_input (B, H, W, 3) NHWC, calib_p2 (B, 3, 4);
        in train and val mode label_segs (B, P) (-1 ignore, 0 background,
        1..K), label_regs (B, P, 7) and, for val's IoUs, label_boxes
        (B, m, 7). `generators`: {"dropout", "path_drop"} in training, and
        "sampling" for a PointCNN of "ids" sampling in every mode."""
        cfg = self.config
        rpn_cfg = cfg.rpn_config
        training = self.training
        gens = generators or {}
        b, p = pc_input.shape[:2]
        k = self.num_classes
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins
        if self.mode in ("train", "val") and (label_segs is None or label_regs is None):
            raise ValueError(f"{self.mode} mode needs label_segs and label_regs")

        pc_pts = pc_input[..., :3]
        pc_intensity = pc_input[..., 3:4]
        pc_in = pc_intensity if rpn_cfg.rpn_use_intensity_feature else None
        with tracing.span("rpn.pc_extractor"):
            if self.pc_extractor_name == "pc_pointcnn":
                pc_pts_out, pc_fts = self.pc_pointcnn(pc_pts, pc_in, gens.get("dropout"),
                                                      gens.get("sampling"))
            else:
                pc_pts_out, pc_fts = self.pc_pointnet(pc_pts, pc_in, gens.get("dropout"))
        with tracing.span("rpn.img_vgg"):
            img_fts = self.img_vgg_pyr(preprocess_image(img_input))

        with tracing.span("rpn.head"):
            proj = rect_to_image(pc_pts_out, calib_p2)
            h, w = img_fts.shape[1], img_fts.shape[2]
            ds = cfg.layers_config.img_vgg_pyr.downsample
            if ds > 1:
                proj = proj / ds
            u = proj[..., 0].to(torch.int32).clamp(0, w - 1).long()
            v = proj[..., 1].to(torch.int32).clamp(0, h - 1).long()
            bi = torch.arange(b, device=u.device)[:, None]
            proj_img_fts = img_fts[bi, v, u]  # (B, P, C1)

            seg_logits = self.seg_logits(pc_fts).float()
            seg_softmax = torch.softmax(seg_logits, dim=-1)
            seg_preds = seg_softmax.argmax(-1)
            fg_softmax = seg_softmax[..., 1:]
            seg_scores = fg_softmax.amax(-1)
            seg_fg_preds = fg_softmax.argmax(-1)
            if self.mode in ("train", "val"):
                foreground_mask = label_segs > 0
            else:
                foreground_mask = seg_preds > 0

            # The bin head's GT rows; the segmentation's stay full-resolution.
            enc_label_segs, enc_label_regs = label_segs, label_regs
            if self.mode in ("val", "test") and not rpn_cfg.rpn_fixed_num_proposal_nms:
                fg_idx = foreground_resample_indices(foreground_mask, seg_scores,
                                                     min(NUM_FG_POINT, p)).long()

                def rows(a):
                    if a is None:
                        return None
                    idx = fg_idx if a.dim() == 2 else fg_idx[..., None].expand(-1, -1, a.shape[-1])
                    return a.gather(1, idx)

                (pc_pts_out, pc_fts, proj_img_fts, pc_intensity, seg_fg_preds, seg_scores,
                 foreground_mask, enc_label_segs, enc_label_regs) = map(rows, (
                     pc_pts_out, pc_fts, proj_img_fts, pc_intensity, seg_fg_preds, seg_scores,
                     foreground_mask, enc_label_segs, enc_label_regs))
                p = fg_idx.shape[1]

            proposal_fts, proposal_img_fts, fusion_mean_div = pc_fts, proj_img_fts, 2.0
            p_img, p_pc = cfg.path_drop_probabilities
            if training and not (p_img == p_pc == 1.0):
                if "path_drop" not in gens:
                    raise ValueError("path drop in training needs a 'path_drop' generator")
                uniforms = torch.rand(3, generator=gens["path_drop"], device=pc_input.device)
                img_mask, pc_mask = create_path_drop_masks(p_img, p_pc, uniforms)
                proposal_fts = proposal_fts * pc_mask
                proposal_img_fts = proposal_img_fts * img_mask
                fusion_mean_div = img_mask + pc_mask
            if rpn_cfg.rpn_fusion_method == "mean":
                fused = (proposal_fts + proposal_img_fts) / fusion_mean_div
            elif rpn_cfg.rpn_fusion_method == "concat":
                fused = torch.cat([proposal_fts, proposal_img_fts], dim=-1)
            else:
                raise ValueError(rpn_cfg.rpn_fusion_method)
            x = fused
            for i, fc in enumerate(cfg.layers_config.rpn_fc_layers):
                x = getattr(self, f"fc{i}")(x)
                if training:
                    x = dropout(x, fc.dropout_rate, gens.get("dropout"), self.dp_group)
            out = self.fc_output(x).float().reshape(b, p, k, -1)
            fields = parse_bin_head(out, nbx, nbz, nbt)

        predictions = {
            "seg_softmax": seg_softmax,
            "seg_preds": seg_preds,
            "foreground_mask": foreground_mask,
        }
        if self.mode in ("val", "test"):
            with tracing.span("rpn.proposals"):
                predictions.update(self._proposals(fields, pc_pts_out, seg_scores, seg_fg_preds))
            if self.mode == "val" and label_boxes is not None:
                iou3d, iou2d = box_3d_iou(predictions["proposals"], label_boxes)
                predictions["proposal_iou3d"] = iou3d  # (B, post, m)
                predictions["proposal_iou2d"] = iou2d
        if self.mode in ("train", "val"):
            with tracing.span("rpn.targets"):
                predictions.update(self._targets(fields, pc_pts_out, label_segs, enc_label_segs,
                                                 enc_label_regs))
            hits = (seg_preds == label_segs.long()).float()
            if self.dp_group is None:
                predictions["seg_accuracy"] = hits.mean()
            else:  # the global batch's
                predictions["seg_accuracy"] = (all_reduce_sum(hits.sum(), self.dp_group)
                                               / (hits.numel() * rank_and_size(self.dp_group)[1]))
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

    def _proposals(self, fields, pc_pts_out, seg_scores, seg_fg_preds):
        """Decode every point's box of its predicted class, keep the top
        `pre` by foreground score (every point on the non-fixed path) and
        run oriented NMS per frame (val mode with the train sizes and
        threshold, test mode with the test ones)."""
        rpn_cfg = self.config.rpn_config
        S, DELTA, _, _, R, DELTA_THETA, _ = self.bins
        b, p = seg_scores.shape
        mean_sizes = self.cluster_sizes.expand(b, p, self.num_classes, 3)
        proposals_all = decode_bins(fields, pc_pts_out, None, mean_sizes,
                                    S, DELTA, R, DELTA_THETA)  # (B, P, K, 7)
        proposals = take_class(proposals_all, seg_fg_preds)  # (B, P, 7)
        if self.mode == "val":
            pre, post = rpn_cfg.rpn_train_pre_nms_size, rpn_cfg.rpn_train_post_nms_size
            thresh = rpn_cfg.rpn_train_nms_iou_thresh
        else:
            pre, post = rpn_cfg.rpn_test_pre_nms_size, rpn_cfg.rpn_test_post_nms_size
            thresh = rpn_cfg.rpn_test_nms_iou_thresh
        if not rpn_cfg.rpn_fixed_num_proposal_nms:
            pre = p
        top_idx = descending_order(seg_scores)[:, :min(pre, p)]
        top_conf = seg_scores.gather(1, top_idx)
        top_props = proposals.gather(1, top_idx[..., None].expand(-1, -1, 7))
        with tracing.span("rpn.nms"):
            keep, keep_valid = oriented_nms_boxes_3d(top_props, top_conf, thresh, post)
        safe = keep.clamp(min=0).long()
        return {
            "proposals": top_props.gather(1, safe[..., None].expand(-1, -1, 7)),
            "proposal_scores": top_conf.gather(1, safe) * keep_valid,
            "proposal_valid": keep_valid,
            "num_proposals_before_padding": keep_valid.sum(-1),
        }

    def _targets(self, fields, pc_pts_out, label_segs, enc_label_segs, label_regs):
        """GT encodings for `rpn_loss`: the segmentation's one-hot targets
        of every point (`label_segs`), the bin targets of each bin-head
        row's GT box under its GT class (`enc_label_segs`, `label_regs`:
        the resampled rows on the non-fixed path), and the head's outputs
        gathered at that class and at the GT bins."""
        S, DELTA, nbx, nbz, R, DELTA_THETA, nbt = self.bins
        k = self.num_classes
        label_cls = enc_label_segs.long()  # -1 ignore, 0 background, 1..K
        # Mean size per point for its GT class; background takes the mean of
        # the class means.
        size_table = torch.cat([self.cluster_sizes.mean(0, keepdim=True), self.cluster_sizes])
        mean_sizes_pt = size_table[label_cls.clamp(0, k)]  # (B, P, 3)
        (bin_x_gt, res_x_gt, bin_z_gt, res_z_gt, bin_theta_gt, res_theta_gt, res_y_gt,
         res_size_gt) = bin_codec.encode_rpn(pc_pts_out, label_regs, mean_sizes_pt,
                                             S, DELTA, R, DELTA_THETA, k)
        cls0 = (label_cls - 1).clamp(0, k - 1)  # 0-based foreground class

        def at_class(t):  # (B, P, K) -> (B, P); (B, P, K, F) -> (B, P, F)
            return take_class(t[..., None], cls0)[..., 0] if t.dim() == 3 else take_class(t, cls0)

        bin_x_gt, res_x_gt = at_class(bin_x_gt), at_class(res_x_gt)
        bin_z_gt, res_z_gt = at_class(bin_z_gt), at_class(res_z_gt)
        return {
            "seg_gt_one_hot": one_hot(label_segs.long(), k + 1),
            "cls_preds": (at_class(fields["bin_x"]), at_class(fields["bin_z"]),
                          at_class(fields["bin_t"])),
            "cls_gts": (one_hot(bin_x_gt, nbx), one_hot(bin_z_gt, nbz),
                        one_hot(bin_theta_gt, nbt)),
            "reg_preds": (take_bin(at_class(fields["res_x"]), bin_x_gt),
                          take_bin(at_class(fields["res_z"]), bin_z_gt),
                          take_bin(at_class(fields["res_t"]), bin_theta_gt),
                          at_class(fields["res_y"]),
                          at_class(fields["res_size"])),
            "reg_gts": (res_x_gt, res_z_gt, res_theta_gt, res_y_gt, res_size_gt),
        }


def rpn_loss(predictions: Dict[str, torch.Tensor], config: ModelConfig, group=None):
    """RPN loss: the focal segmentation loss over all points, normalised by
    their count, plus the bins' cross-entropy and the residuals' smooth L1,
    both normalised by the foreground count (0 without foreground). With a
    data-parallel `group`, this rank's share: its sums over the global
    batch's counts (`core/losses.py`).

    Returns:
      (loss_dict, total_loss).
    """
    lw = config.loss_config
    seg_softmax = predictions["seg_softmax"]
    # Ignore-label points (-1) have a zero one-hot row, hence no loss.
    num_total = seg_softmax.shape[0] * seg_softmax.shape[1] * rank_and_size(group)[1]
    seg_loss = weighted_focal(seg_softmax, predictions["seg_gt_one_hot"],
                              weight=lw.seg_loss_weight).sum() / num_total

    cls_loss, reg_loss = bin_losses(predictions["cls_preds"], predictions["cls_gts"],
                                    predictions["reg_preds"], predictions["reg_gts"],
                                    predictions["foreground_mask"].float(), lw, group)
    total = seg_loss + cls_loss + reg_loss
    return {"rpn_seg_loss": seg_loss, "rpn_bin_cls_loss": cls_loss, "rpn_reg_loss": reg_loss}, total
