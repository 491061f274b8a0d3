"""The configuration schema of the port (`configs/config.py`): the
dataclasses of the reference's protobuf schema (hf/protos/*.proto), one
PipelineConfig = model + train + eval + dataset, built from a frozen dict
by `_from_dict`.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class InputConfig:
    """model.proto InputConfig."""

    pc_sample_pts: int = 16384
    pc_data_dim: int = 4
    pc_sample_pts_variance: float = 0.125
    pc_sample_pts_clip: float = 0.25
    img_dims_h: int = 360
    img_dims_w: int = 1200
    img_depth: int = 3


@dataclass
class RpnConfig:
    """model.proto RpnConfig."""

    rpn_use_intensity_feature: bool = True
    rpn_fusion_method: str = "concat"  # 'mean' | 'concat'
    rpn_fixed_num_proposal_nms: bool = True
    rpn_train_pre_nms_size: int = 9000
    rpn_train_post_nms_size: int = 512
    rpn_train_nms_iou_thresh: float = 0.85
    rpn_test_pre_nms_size: int = 9000
    rpn_test_post_nms_size: int = 100
    rpn_test_nms_iou_thresh: float = 0.8
    rpn_xz_search_range: List[float] = field(default_factory=lambda: [3.0, 1.5, 1.5])
    rpn_xz_bin_len: List[float] = field(default_factory=lambda: [0.5, 0.25, 0.25])
    rpn_theta_search_range: float = 1.0  # fraction of pi
    rpn_theta_bin_num: int = 12
    # TPU addition: cap on foreground points fed to the proposal head
    # (replaces the reference's tf.py_func resampling, model_util.py:11-40).
    rpn_fg_points: int = 2048


@dataclass
class RcnnConfig:
    """model.proto RcnnConfig."""

    rcnn_use_intensity_feature: bool = True
    rcnn_proposal_roi_crop_size: int = 512
    rcnn_proposal_roi_img_crop_size: int = 7
    rcnn_nms_size: int = 100
    rcnn_nms_iou_thresh: float = 0.01
    rcnn_xz_search_range: List[float] = field(default_factory=lambda: [1.5, 0.75, 0.75])
    rcnn_xz_bin_len: List[float] = field(default_factory=lambda: [0.5, 0.25, 0.25])
    rcnn_theta_search_range: float = 0.25  # fraction of pi
    rcnn_theta_bin_num: int = 12
    rcnn_pooling_context_length: float = 1.0
    rcnn_fusion_method: str = "flat_concat"  # 'mean_concat' | 'flat_concat'
    # Fused-inference option (TPU addition): crop image RoIs from stage-1's
    # full-res feature map instead of running the RCNN's own image extractor
    # again — one VGG pass per frame in the fused graph. Default off =
    # reference behavior (each stage computes its own image features).
    rcnn_use_rpn_img_feature_map: bool = False


@dataclass
class XConvParam:
    """layers.proto xconv_param: [K, D, P, C] (+ optional links)."""

    K: int = 8
    D: int = 1
    P: int = -1
    C: int = 256
    links: List[int] = field(default_factory=list)


@dataclass
class XDConvParam:
    """layers.proto xdconv_param: [K, D, pts_layer_idx, qrs_layer_idx]."""

    K: int = 8
    D: int = 1
    pts_layer_idx: int = 0
    qrs_layer_idx: int = 0


@dataclass
class FCLayer:
    C: int = 256
    dropout_rate: float = 0.5


@dataclass
class PointCNNConfig:
    """layers.proto pc_pointcnn."""

    sampling: str = "fps"  # 'fps' | 'ids' | 'random'
    with_X_transformation: bool = True
    with_global: bool = True
    sorting_method: str = ""
    xconv_layers: List[XConvParam] = field(default_factory=list)
    xdconv_layers: List[XDConvParam] = field(default_factory=list)
    fc_layers: List[FCLayer] = field(default_factory=list)


@dataclass
class SAModuleConfig:
    """layers.proto pc_pointnet SA module: one set-abstraction level.

    With `use_msg`, the multi-scale-grouping variant runs one branch per
    (radii[i], nsamples[i], mlps[i]) and concatenates."""

    npoint: int = 1024
    radius: float = 1.0
    nsample: int = 32
    mlp: List[int] = field(default_factory=lambda: [64, 64, 128])
    use_knn: bool = False
    use_msg: bool = False
    radii: List[float] = field(default_factory=list)
    nsamples: List[int] = field(default_factory=list)
    mlps: List[List[int]] = field(default_factory=list)


@dataclass
class FPModuleConfig:
    """PointNet++ feature-propagation module."""

    mlp: List[int] = field(default_factory=lambda: [128, 128])


@dataclass
class PointNetConfig:
    """layers.proto pc_pointnet."""

    sa_modules: List[SAModuleConfig] = field(default_factory=list)
    fp_modules: List[FPModuleConfig] = field(default_factory=list)
    fc_layers: List[FCLayer] = field(default_factory=list)


@dataclass
class ImgVggPyrConfig:
    """layers.proto img_vgg_pyr: [repeats, filters] per block."""

    vgg_conv1: Tuple[int, int] = (2, 32)
    vgg_conv2: Tuple[int, int] = (2, 64)
    vgg_conv3: Tuple[int, int] = (3, 128)
    vgg_conv4: Tuple[int, int] = (3, 256)
    l2_weight_decay: float = 0.0005
    # TPU addition: run the whole image extractor at input-res / downsample
    # (avg-pooled input, feature map at reduced res). XLA's image-conv cost
    # on v5e scales with pixels and is invariant to channel width (measured,
    # STATUS.md), so downsample=2 cuts the VGG budget ~4x. Consumers scale
    # lookup coords (RPN) — RoI crops use normalized boxes and need no
    # change. 1 = reference behavior (full resolution).
    downsample: int = 1


@dataclass
class LayersConfig:
    """layers.proto top level: which extractors + head stacks."""

    pc_extractor_type: str = "pointcnn"  # 'pointcnn' | 'pointnet'
    pc_pointcnn: Optional[PointCNNConfig] = None
    pc_pointnet: Optional[PointNetConfig] = None
    img_extractor_type: str = "vgg_pyr"
    img_vgg_pyr: ImgVggPyrConfig = field(default_factory=ImgVggPyrConfig)
    rpn_fc_layers: List[FCLayer] = field(
        default_factory=lambda: [FCLayer(512, 0.5), FCLayer(512, 0.5)]
    )
    rcnn_mlp_layers: List[FCLayer] = field(
        default_factory=lambda: [FCLayer(256, 0.5), FCLayer(256, 0.5)]
    )
    rcnn_pc_pointcnn: Optional[PointCNNConfig] = None
    rcnn_fc_layers: List[FCLayer] = field(
        default_factory=lambda: [FCLayer(256, 0.5), FCLayer(256, 0.5)]
    )


@dataclass
class LossConfig:
    """model.proto LossConfig."""

    seg_loss_weight: float = 100.0
    cls_loss_weight: float = 1.0
    reg_loss_weight: float = 1.0
    ang_loss_weight: float = 1.0


@dataclass
class ModelConfig:
    model_name: str = "rpn_model"
    checkpoint_name: str = "rpn_multiclass"
    input_config: InputConfig = field(default_factory=InputConfig)
    rpn_config: RpnConfig = field(default_factory=RpnConfig)
    rcnn_config: RcnnConfig = field(default_factory=RcnnConfig)
    label_smoothing_epsilon: float = 0.001
    path_drop_probabilities: List[float] = field(default_factory=lambda: [0.9, 0.9])
    train_on_all_samples: bool = False
    eval_all_samples: bool = False
    layers_config: LayersConfig = field(default_factory=LayersConfig)
    loss_config: LossConfig = field(default_factory=LossConfig)
    # Computation dtype for extractor/head matmuls and convs ("float32" |
    # "bfloat16"); parameters and losses stay float32 (mixed precision).
    compute_dtype: str = "float32"


@dataclass
class OptimizerConfig:
    """optimizer.proto (adam + exponential decay, the production setting)."""

    optimizer_type: str = "adam"  # 'adam' | 'momentum' | 'sgd' | 'rmsprop'
    initial_learning_rate: float = 0.001
    decay_steps: int = 20000
    decay_factor: float = 0.8
    staircase: bool = True
    momentum: float = 0.9
    use_moving_average: bool = False
    moving_average_decay: float = 0.9999


@dataclass
class TrainConfig:
    """train.proto."""

    batch_size: int = 2
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    overwrite_checkpoints: bool = False
    max_checkpoints_to_keep: int = 1000
    max_iterations: int = 240000
    checkpoint_interval: int = 2000
    summary_interval: int = 10
    summary_histograms: bool = True
    summary_img_images: bool = False
    summary_pc_images: bool = False
    grad_clip_norm: float = 1.0


@dataclass
class EvalConfig:
    """eval.proto."""

    batch_size: int = 1
    eval_interval: int = 2000
    eval_mode: str = "val"  # 'val' | 'test'
    ckpt_indices: List[int] = field(default_factory=lambda: [-1])
    evaluate_repeatedly: bool = False
    kitti_score_threshold: float = 0.1
    save_rpn_feature: bool = False
    for_rcnn_train: bool = False


@dataclass
class IouThresholds:
    """mini_batch.proto cls/reg IoU thresholds."""

    neg_iou_lo: float = 0.05
    neg_iou_hi: float = 0.45
    pos_iou_lo: float = 0.60
    pos_iou_hi: float = 1.0


@dataclass
class MiniBatchConfig:
    """mini_batch.proto (RCNN RoI sampling)."""

    cls_iou_3d_thresholds: IouThresholds = field(
        default_factory=lambda: IouThresholds(0.05, 0.45, 0.60, 1.0)
    )
    reg_iou_3d_thresholds: IouThresholds = field(
        default_factory=lambda: IouThresholds(0.0, 0.55, 0.55, 1.0)
    )
    roi_per_sample: int = 64
    fg_ratio: float = 0.5
    hard_bg_ratio: float = 0.8


@dataclass
class DatasetConfig:
    """kitti_dataset.proto + kitti_utils.proto."""

    name: str = "kitti"
    dataset_dir: str = ""
    data_split: str = "train"
    data_split_dir: str = "training"
    has_labels: bool = True
    cluster_split: str = "train"
    classes: List[str] = field(
        default_factory=lambda: ["Car", "Pedestrian", "Cyclist"]
    )
    num_clusters: List[int] = field(default_factory=lambda: [1, 1, 1])
    aug_list: List[str] = field(default_factory=list)
    aug_roi_method: str = "multiple"
    area_extents: List[float] = field(
        default_factory=lambda: [-40, 40, -5, 3, 0, 70]
    )
    expand_gt_size: float = 0.2
    mini_batch_config: MiniBatchConfig = field(default_factory=MiniBatchConfig)
    # TPU addition: static max GT boxes per sample (collate pads to this).
    max_gt_boxes: int = 32
    cluster_cache_dir: Optional[str] = None


@dataclass
class PipelineConfig:
    """pipeline.proto NetworkPipelineConfig."""

    model_config: ModelConfig = field(default_factory=ModelConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    eval_config: EvalConfig = field(default_factory=EvalConfig)
    dataset_config: DatasetConfig = field(default_factory=DatasetConfig)


def _from_value(hint, val):
    """A JSON value as the field type `hint` says: dataclasses (also inside
    Optional and List) rebuilt, lists made tuples for Tuple fields."""
    origin, args = typing.get_origin(hint), typing.get_args(hint)
    if dataclasses.is_dataclass(hint):
        return _from_dict(hint, val)
    if origin is typing.Union and val is not None:
        inner = [a for a in args if a is not type(None)]
        return _from_value(inner[0], val) if len(inner) == 1 else val
    if origin is list and args and isinstance(val, list):
        return [_from_value(args[0], v) for v in val]
    if origin is tuple and isinstance(val, list):
        return tuple(val)
    return val


def _from_dict(cls, data):
    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {f.name: _from_value(hints[f.name], data[f.name])
              for f in dataclasses.fields(cls) if f.name in data}
    return cls(**kwargs)
