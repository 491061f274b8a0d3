"""Canned pipeline configs (parity with hf/configs/*.config).

Each function mirrors one of the reference textproto configs; small-scale
`*_unittest` variants point at the vendored mini-KITTI for hermetic tests
(the reference's DatasetBuilder.KITTI_UNITTEST pattern,
hf/builders/dataset_builder.py:16-25).
"""

from __future__ import annotations

import os

from heterofusionrcnn_torch.configs.config import (
    DatasetConfig,
    EvalConfig,
    FCLayer,
    LayersConfig,
    ModelConfig,
    PipelineConfig,
    PointCNNConfig,
    PointNetConfig,
    RpnConfig,
    SAModuleConfig,
    FPModuleConfig,
    TrainConfig,
    XConvParam,
    XDConvParam,
)


def rpn_pointcnn_layers() -> PointCNNConfig:
    """The flagship RPN PointCNN stack (rpn_multiclass.config:61-123)."""
    return PointCNNConfig(
        sampling="fps",
        with_X_transformation=True,
        with_global=True,
        xconv_layers=[
            XConvParam(K=8, D=1, P=-1, C=256),
            XConvParam(K=8, D=1, P=4096, C=256),
            XConvParam(K=8, D=1, P=1024, C=512),
            XConvParam(K=8, D=1, P=256, C=1024),
            XConvParam(K=8, D=1, P=64, C=1024),
        ],
        xdconv_layers=[
            XDConvParam(K=8, D=1, pts_layer_idx=4, qrs_layer_idx=4),
            XDConvParam(K=8, D=1, pts_layer_idx=4, qrs_layer_idx=3),
            XDConvParam(K=8, D=1, pts_layer_idx=3, qrs_layer_idx=2),
            XDConvParam(K=8, D=1, pts_layer_idx=2, qrs_layer_idx=1),
            XDConvParam(K=8, D=1, pts_layer_idx=1, qrs_layer_idx=0),
            XDConvParam(K=8, D=1, pts_layer_idx=0, qrs_layer_idx=0),
        ],
        fc_layers=[FCLayer(256, 0.5), FCLayer(256, 0.5)],
    )


def rcnn_pointcnn_layers() -> PointCNNConfig:
    """Stage-2 PointCNN over 512-point RoI crops (rpn_multiclass.config
    rcnn_config:155-183)."""
    return PointCNNConfig(
        sampling="fps",
        with_X_transformation=True,
        with_global=True,
        xconv_layers=[
            XConvParam(K=4, D=1, P=-1, C=512),
            XConvParam(K=8, D=1, P=128, C=512),
            XConvParam(K=12, D=1, P=32, C=1024),
            XConvParam(K=12, D=1, P=8, C=1024),
        ],
        xdconv_layers=[],
        fc_layers=[],
    )


def rpn_pointnet_layers() -> PointNetConfig:
    """PointNet++ alternative (rpn_cars_pointnet.config shape)."""
    return PointNetConfig(
        sa_modules=[
            SAModuleConfig(npoint=4096, radius=0.5, nsample=32, mlp=[32, 32, 64]),
            SAModuleConfig(npoint=1024, radius=1.0, nsample=32, mlp=[64, 64, 128]),
            SAModuleConfig(npoint=256, radius=2.0, nsample=32, mlp=[128, 128, 256]),
            SAModuleConfig(npoint=64, radius=4.0, nsample=32, mlp=[256, 256, 512]),
        ],
        fp_modules=[
            FPModuleConfig(mlp=[256, 256]),
            FPModuleConfig(mlp=[256, 256]),
            FPModuleConfig(mlp=[256, 128]),
            FPModuleConfig(mlp=[128, 128, 128]),
        ],
        fc_layers=[FCLayer(256, 0.5), FCLayer(256, 0.5)],
    )


def rpn_multiclass(dataset_dir: str = "") -> PipelineConfig:
    """hf/configs/rpn_multiclass.config."""
    cfg = PipelineConfig()
    cfg.model_config = ModelConfig(
        model_name="rpn_model",
        checkpoint_name="rpn_multiclass",
        layers_config=LayersConfig(
            pc_extractor_type="pointcnn",
            pc_pointcnn=rpn_pointcnn_layers(),
            rpn_fc_layers=[FCLayer(512, 0.5), FCLayer(512, 0.5)],
            rcnn_mlp_layers=[FCLayer(256, 0.5), FCLayer(256, 0.5)],
            rcnn_pc_pointcnn=rcnn_pointcnn_layers(),
            rcnn_fc_layers=[FCLayer(256, 0.5), FCLayer(256, 0.5)],
        ),
    )
    cfg.dataset_config.dataset_dir = dataset_dir
    cfg.dataset_config.aug_list = ["flipping", "pca_jitter"]
    return cfg


def rcnn_multiclass(dataset_dir: str = "") -> PipelineConfig:
    """hf/configs/rcnn_multiclass.config (same net params, RCNN model)."""
    cfg = rpn_multiclass(dataset_dir)
    cfg.model_config.model_name = "rcnn_model"
    cfg.model_config.checkpoint_name = "rcnn_multiclass"
    cfg.train_config.batch_size = 1
    return cfg


def _fixture_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "tests",
        "fixtures",
        "kitti",
    )


def rpn_unittest() -> PipelineConfig:
    """Small-scale RPN on the vendored mini-KITTI: 2048 points, 120x384
    images, a shrunken PointCNN — shapes chosen so every pyramid level and
    both branches still exercise, but a CPU test finishes in seconds."""
    cfg = rpn_multiclass(_fixture_dir())
    cfg.model_config.checkpoint_name = "rpn_unittest"
    mc = cfg.model_config
    mc.input_config.pc_sample_pts = 2048
    mc.input_config.img_dims_h = 120
    mc.input_config.img_dims_w = 384
    mc.rpn_config.rpn_train_pre_nms_size = 512
    mc.rpn_config.rpn_train_post_nms_size = 64
    mc.rpn_config.rpn_test_pre_nms_size = 512
    mc.rpn_config.rpn_test_post_nms_size = 32
    mc.rpn_config.rpn_fg_points = 256
    mc.layers_config.pc_pointcnn = PointCNNConfig(
        sampling="fps",
        with_X_transformation=True,
        with_global=True,
        xconv_layers=[
            XConvParam(K=8, D=1, P=-1, C=32),
            XConvParam(K=8, D=1, P=512, C=32),
            XConvParam(K=8, D=1, P=128, C=64),
            XConvParam(K=8, D=1, P=32, C=64),
        ],
        xdconv_layers=[
            XDConvParam(K=8, D=1, pts_layer_idx=3, qrs_layer_idx=2),
            XDConvParam(K=8, D=1, pts_layer_idx=2, qrs_layer_idx=1),
            XDConvParam(K=8, D=1, pts_layer_idx=1, qrs_layer_idx=0),
            XDConvParam(K=8, D=1, pts_layer_idx=0, qrs_layer_idx=0),
        ],
        fc_layers=[FCLayer(64, 0.5), FCLayer(64, 0.5)],
    )
    mc.layers_config.img_vgg_pyr.vgg_conv1 = (1, 8)
    mc.layers_config.img_vgg_pyr.vgg_conv2 = (1, 16)
    mc.layers_config.img_vgg_pyr.vgg_conv3 = (1, 32)
    mc.layers_config.img_vgg_pyr.vgg_conv4 = (1, 64)
    mc.layers_config.rpn_fc_layers = [FCLayer(64, 0.5), FCLayer(64, 0.5)]
    cfg.dataset_config.aug_list = []
    cfg.train_config.batch_size = 1
    cfg.train_config.max_iterations = 3
    cfg.train_config.checkpoint_interval = 2
    cfg.train_config.summary_interval = 1
    # Keep CPU test runs lean; the toggle wiring has its own test.
    cfg.train_config.summary_histograms = False
    return cfg


def rcnn_unittest() -> PipelineConfig:
    """Small-scale RCNN twin of rpn_unittest."""
    cfg = rpn_unittest()
    mc = cfg.model_config
    mc.model_name = "rcnn_model"
    mc.checkpoint_name = "rcnn_unittest"
    mc.rcnn_config.rcnn_proposal_roi_crop_size = 64
    mc.rcnn_config.rcnn_nms_size = 16
    mc.layers_config.rcnn_pc_pointcnn = PointCNNConfig(
        sampling="fps",
        with_X_transformation=True,
        with_global=True,
        xconv_layers=[
            XConvParam(K=4, D=1, P=-1, C=64),
            XConvParam(K=8, D=1, P=16, C=64),
            XConvParam(K=8, D=1, P=4, C=128),
        ],
        xdconv_layers=[],
        fc_layers=[],
    )
    mc.layers_config.rcnn_mlp_layers = [FCLayer(64, 0.5), FCLayer(64, 0.5)]
    mc.layers_config.rcnn_fc_layers = [FCLayer(64, 0.5), FCLayer(64, 0.5)]
    cfg.dataset_config.mini_batch_config.roi_per_sample = 16
    return cfg
