"""The VGG image feature extractors in float32 plain PyTorch (cuDNN
convolutions), with the port's module names.

`ImgVggPyr`: four VGG conv blocks with three 2x2 max-pools, then a
transposed-conv decoder with skip concatenations back to full resolution
(vgg_conv1 filters). `ImgVgg`: the encoder plus bilinear upsampling. Both
take and return NHWC and run NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hfbench.reference.config import ImgVggPyrConfig
from hfbench.reference.layers import ConvBNRelu, ConvTransposeBNRelu

KITTI_RGB_MEANS = (92.8403, 97.7996, 93.5843)


def preprocess_image(image: torch.Tensor) -> torch.Tensor:
    """Subtract the KITTI per-channel means (NHWC)."""
    return image - image.new_tensor(KITTI_RGB_MEANS)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool keeping a trailing odd row/column (NCHW)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _crop_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x[:, :, : like.shape[2], : like.shape[3]]


def _maybe_downsample(x: torch.Tensor, ds: int) -> torch.Tensor:
    return x if ds <= 1 else F.avg_pool2d(x, ds, ds)


class _Blocks(nn.Module):
    def __init__(self, config: ImgVggPyrConfig, in_channels: int = 3):
        super().__init__()
        self.config = config
        c = in_channels
        for name, (repeats, filters) in self._specs():
            for i in range(repeats):
                self.add_module(f"{name}_{i + 1}",
                                ConvBNRelu(c, filters))
                c = filters

    def _specs(self):
        cfg = self.config
        return [("conv1", cfg.vgg_conv1), ("conv2", cfg.vgg_conv2),
                ("conv3", cfg.vgg_conv3), ("conv4", cfg.vgg_conv4)]

    def block(self, x, name):
        repeats = dict(self._specs())[name][0]
        for i in range(repeats):
            x = getattr(self, f"{name}_{i + 1}")(x)
        return x


class ImgVgg(_Blocks):
    """VGG encoder + bilinear upsampling to the input resolution."""

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = _maybe_downsample(image.permute(0, 3, 1, 2), self.config.downsample)
        h, w = x.shape[2], x.shape[3]
        x = _pool2(self.block(x, "conv1"))
        x = _pool2(self.block(x, "conv2"))
        x = _pool2(self.block(x, "conv3"))
        x = self.block(x, "conv4")
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


class ImgVggPyr(_Blocks):
    """U-Net-shaped VGG: (B, H, W, 3) -> (B, H, W, vgg_conv1 filters)."""

    def __init__(self, config: ImgVggPyrConfig, in_channels: int = 3):
        super().__init__(config, in_channels)
        c1, c2, c3, c4 = (config.vgg_conv1[1], config.vgg_conv2[1],
                          config.vgg_conv3[1], config.vgg_conv4[1])
        self.upconv3 = ConvTransposeBNRelu(c4, c3)
        self.pyramid_fusion3 = ConvBNRelu(c3 + c3, c2)
        self.upconv2 = ConvTransposeBNRelu(c2, c2)
        self.pyramid_fusion2 = ConvBNRelu(c2 + c2, c1)
        self.upconv1 = ConvTransposeBNRelu(c1, c1)
        self.pyramid_fusion1 = ConvBNRelu(c1 + c1, c1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = _maybe_downsample(image.permute(0, 3, 1, 2), self.config.downsample)
        conv1 = self.block(x, "conv1")
        conv2 = self.block(_pool2(conv1), "conv2")
        conv3 = self.block(_pool2(conv2), "conv3")
        conv4 = self.block(_pool2(conv3), "conv4")
        up3 = self.upconv3(conv4)
        fuse3 = self.pyramid_fusion3(torch.cat([conv3, _crop_to(up3, conv3)], dim=1))
        up2 = self.upconv2(fuse3)
        fuse2 = self.pyramid_fusion2(torch.cat([conv2, _crop_to(up2, conv2)], dim=1))
        up1 = self.upconv1(fuse2)
        fuse1 = self.pyramid_fusion1(torch.cat([conv1, _crop_to(up1, conv1)], dim=1))
        return fuse1.permute(0, 2, 3, 1)
