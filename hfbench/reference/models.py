"""The reference's entry points: the two-stage detector in test mode, the
RPN alone, and the RPN's train step (loss, gradients, clipping, Adam),
each in float32 plain PyTorch."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from hfbench.reference.optimizer import Optimizer
from hfbench.reference.rcnn import RcnnModel
from hfbench.reference.rpn import RpnModel, rpn_fts_channels, rpn_loss

RPN_BATCH_KEYS = ("point_cloud", "image_input", "stereo_calib_p2",
                  "label_seg", "label_reg", "label_boxes_3d")


class TwoStage(nn.Module):
    """RPN + RCNN in test mode, the RCNN on stage 1's image feature map
    when the RCNN's config shares it."""

    def __init__(self, rpn_cfg, rcnn_cfg, cluster_sizes: Sequence[Tuple[float, float, float]],
                 bev_z_max: float):
        super().__init__()
        k = len(cluster_sizes)
        self.rpn = RpnModel(rpn_cfg.model_config, k, cluster_sizes)
        self.rcnn = RcnnModel(rcnn_cfg.model_config, k, cluster_sizes,
                              rpn_fts_channels(rpn_cfg.model_config), bev_z_max=bev_z_max)
        self.shared_vgg = rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map

    @torch.no_grad()
    def stage2(self, rpn_out: Dict[str, torch.Tensor], img: torch.Tensor,
               p2: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The RCNN over stage 1's proposals (B, n, 7), with its features."""
        fts = torch.cat([rpn_out["rpn_fts"], rpn_out["rpn_img_fts"]], dim=-1)
        return self.rcnn(rpn_out["proposals"], rpn_out["rpn_pts"], rpn_out["rpn_intensity"][..., 0],
                         rpn_out["foreground_mask"].float(), fts, img, p2,
                         img_feature_map=rpn_out["img_feature_map"] if self.shared_vgg else None)


def train_steps(model: RpnModel, optimizer: Optimizer, batches: List[Dict[str, torch.Tensor]],
                generators: Dict[str, torch.Generator]):
    """One step a batch in turn: the loss terms of each step, and the
    clipped gradient of the first by parameter name."""
    losses, first_grads = [], None
    for batch in batches:
        model.train()
        with torch.enable_grad():
            preds = model(*(batch[k] for k in RPN_BATCH_KEYS), generators=generators)
            loss_dict, total = rpn_loss(preds, model.config)
            grads = torch.autograd.grad(total, optimizer.params)
        if first_grads is None:
            first_grads = dict(zip(optimizer.names, optimizer.clip(list(grads))))
        optimizer.step(grads)
        step = {k: float(v.detach()) for k, v in loss_dict.items()}
        step["total_loss"] = float(total.detach())
        losses.append(step)
    return losses, first_grads


def build_rpn(cfg, cluster_sizes, mode: str, save_rpn_feature: bool = False,
              device: Optional[torch.device] = None) -> RpnModel:
    with torch.device(device or "cpu"):
        return RpnModel(cfg.model_config, len(cluster_sizes), cluster_sizes,
                        save_rpn_feature=save_rpn_feature, mode=mode)
