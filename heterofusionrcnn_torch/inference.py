"""Fused two-stage inference: RPN -> proposals -> RCNN -> final boxes.

Mirrors the fused function that `bench.py` builds (`build_stages` ->
`fused`): the RPN in test mode with its stage-1 features saved, then the
RCNN on the 100 proposals per frame, reusing the stage-1 image feature map
(one VGG pass per frame) when the RCNN config asks for it
(`rcnn_use_rpn_img_feature_map`). Runs on the card unless the caller
passes `device="cpu"`. Two switches, both off by default as their JAX
counterparts are: `conv_kernels` (the VGG convs through the fused kernels
of `ops/conv.py`, JAX's `HFR_PALLAS_CONV=1`) and `crop_kernel` (the RCNN
point crop's feature gather through `ops/cropping.crop_gather`, JAX's
`HFR_PALLAS_CROP=1`). Each stage computes in its config's
`model_config.compute_dtype` ("float32" or "bfloat16", the bf16 serving
path; `build_two_stage(compute_dtype=...)` sets both, as the JAX bench's
`build_stages(dtype=...)` does). `sharded_forward` runs it over a batch
split across the ranks of a process group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from heterofusionrcnn_torch.configs.config import PipelineConfig
from heterofusionrcnn_torch.configs.presets import rcnn_multiclass, rpn_multiclass
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.models.rcnn import RcnnModel
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_fts_channels
from heterofusionrcnn_torch.parallel.mesh import gather_rows, shard_batch

# KITTI class mean sizes [l, w, h] of Car, Pedestrian, Cyclist.
CLUSTER_SIZES = ((3.9, 1.6, 1.56), (0.8, 0.66, 1.74), (1.76, 0.6, 1.73))


def exact_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card
    (TF32 would drop to ~3 decimal digits, the role the JAX package's
    `Precision.HIGHEST` pins play against the TPU's bf16 default), and
    bf16 matmuls' sums in float32 (`preferred_element_type=f32`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class TwoStageDetector(nn.Module):
    """RPN + RCNN in test mode. `cluster_sizes` are the dataset's class mean
    sizes (`experiments.common.cluster_sizes_tuple`), `bev_z_max` its far
    BEV extent."""

    def __init__(self, rpn_cfg: PipelineConfig, rcnn_cfg: PipelineConfig,
                 cluster_sizes: Sequence[Tuple[float, float, float]] = CLUSTER_SIZES,
                 conv_kernels: bool = False, crop_kernel: bool = False,
                 bev_z_max: float = 70.0):
        super().__init__()
        self.rpn = RpnModel(rpn_cfg.model_config, len(cluster_sizes), cluster_sizes,
                            conv_kernels=conv_kernels)
        self.rcnn = RcnnModel(rcnn_cfg.model_config, len(cluster_sizes), cluster_sizes,
                              rpn_fts_channels(rpn_cfg.model_config), bev_z_max=bev_z_max,
                              conv_kernels=conv_kernels, crop_kernel=crop_kernel)
        self.shared_vgg = rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map

    @torch.no_grad()
    def forward(self, pc: torch.Tensor, img: torch.Tensor, p2: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pc (B, P, 4), img (B, H, W, 3), p2 (B, 3, 4) -> the dict of the JAX
        package's fused function (`experiments/run_inference.py`):
        proposals (B, n, 7), proposal_scores (B, n), final_boxes (B, m, 7),
        final_scores (B, m), final_classes (B, m) (0-based class index),
        final_valid (B, m), num_final (B,)."""
        rpn_out = self.rpn(pc, img, p2)
        fts = torch.cat([rpn_out["rpn_fts"], rpn_out["rpn_img_fts"]], dim=-1)
        rcnn_out = self.rcnn(
            rpn_out["proposals"],
            rpn_out["rpn_pts"],
            rpn_out["rpn_intensity"][..., 0],
            rpn_out["foreground_mask"].float(),
            fts,
            img,
            p2,
            img_feature_map=rpn_out["img_feature_map"] if self.shared_vgg else None,
        )
        return {
            "proposals": rpn_out["proposals"],
            "proposal_scores": rpn_out["proposal_scores"],
            "final_boxes": rcnn_out["final_boxes"],
            "final_scores": rcnn_out["final_scores"],
            "final_classes": rcnn_out["final_classes"],
            "final_valid": rcnn_out["final_valid"],
            "num_final": rcnn_out["num_boxes_before_padding"],
        }


def sharded_forward(det: TwoStageDetector, pc: torch.Tensor, img: torch.Tensor, p2: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> Dict[str, torch.Tensor]:
    """The detector's forward on a global batch split over the ranks of
    `group` (the JAX fused function jitted with the batch axis sharded over
    a data mesh, the weights replicated): this rank runs its rows
    (`shard_batch`; a world size that does not divide the batch raises
    ValueError on every rank before any collective) and every rank gets the
    whole dict (`gather_rows`, the call's only collective: in test mode the
    BatchNorms run on their running statistics). The weights must be the
    same on every rank (`parallel.mesh.replicate_module`). Without a group,
    `det(pc, img, p2)`."""
    local = shard_batch({"pc": pc, "img": img, "p2": p2}, group)
    return gather_rows(det(local["pc"], local["img"], local["p2"]), group)


def random_batch(cfg: PipelineConfig, batch_size: int, seed: int) -> Dict[str, np.ndarray]:
    """Synthetic inputs with the dataset's shapes (the JAX package's
    `__graft_entry__._random_rpn_batch`): points in front of the camera,
    a uniform image and a fixed P2."""
    rng = np.random.default_rng(seed)
    ic = cfg.model_config.input_config
    p = ic.pc_sample_pts
    pc = rng.uniform(-40, 40, (batch_size, p, 4)).astype(np.float32)
    pc[..., 2] = np.abs(pc[..., 2]) + 1.0
    pc[..., 3] = rng.uniform(-0.5, 0.5, (batch_size, p))
    img = rng.uniform(0, 255, (batch_size, ic.img_dims_h, ic.img_dims_w, 3)).astype(np.float32)
    p2 = np.tile(
        np.array(
            [[700.0, 0.0, ic.img_dims_w / 2, 40.0],
             [0.0, 700.0, ic.img_dims_h / 2, 2.0],
             [0.0, 0.0, 1.0, 0.0]],
            np.float32,
        ),
        (batch_size, 1, 1),
    )
    return {"point_cloud": pc, "image_input": img, "stereo_calib_p2": p2}


def build_two_stage(
    batch_size: int = 4,
    seed: int = 0,
    device: str = "cuda",
    rpn_cfg: Optional[PipelineConfig] = None,
    rcnn_cfg: Optional[PipelineConfig] = None,
    conv_kernels: bool = False,
    crop_kernel: bool = False,
    compute_dtype: str = "float32",
):
    """The full-width `rpn_multiclass` / `rcnn_multiclass` detector with
    random weights from `seed`, in eval mode on `device`, and a synthetic
    batch from the same seed. `compute_dtype` ("float32" or "bfloat16")
    goes into both stages' model configs, as `bench.build_stages(dtype=)`
    does; the weights stay float32. Returns (detector, (pc, img, p2))."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    exact_float32()
    rpn_cfg = rpn_cfg or rpn_multiclass()
    rcnn_cfg = rcnn_cfg or rcnn_multiclass()
    rpn_cfg.model_config.compute_dtype = compute_dtype
    rcnn_cfg.model_config.compute_dtype = compute_dtype
    rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = True
    det = TwoStageDetector(rpn_cfg, rcnn_cfg, conv_kernels=conv_kernels, crop_kernel=crop_kernel)
    det = init_weights(det, seed).to(device).eval()
    batch = random_batch(rpn_cfg, batch_size, seed)
    inputs = tuple(
        torch.from_numpy(batch[k]).to(device)
        for k in ("point_cloud", "image_input", "stereo_calib_p2")
    )
    return det, inputs
