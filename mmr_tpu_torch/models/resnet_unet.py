"""ResNet-UNet, the Path-A ``resnet18`` / ``resnet34`` (counterpart of
``mmr_tpu/models/resnet_unet.py``): the ResNet encoder's five features
through 1×1 conv + ReLU adapters, a decoder of ×2 bilinear upsamples
(align_corners=True) → concat → 3×3 conv + ReLU, and a full-resolution
side path (``conv_original_size0/1/2``) fused before the 1×1 head. Its
convs are ``nn.Conv`` in JAX, not ``Conv3x3``, so every one stays a library
conv here too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.encoders.resnet import ResNetEncoder
from mmr_tpu_torch.models.layers import Conv2d, nchw, nhwc
from mmr_tpu_torch.ops.resize import upsample2x


class ConvRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, 1, kernel // 2)

    def forward(self, x):
        return F.relu(self.conv(x))


class ResNetUNet(nn.Module):
    """Takes an NHWC image batch, returns NHWC f32 logits."""

    def __init__(self, num_classes: int, in_channels: int = 3, depth: int = 18,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if depth not in (18, 34):
            raise ValueError(f"depth {depth}: 18 or 34")
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv_original_size0 = ConvRelu(in_channels, 64)
        self.conv_original_size1 = ConvRelu(64, 64)
        self.encoder = ResNetEncoder((2, 2, 2, 2) if depth == 18 else (3, 4, 6, 3))
        for i, c in enumerate((64, 64, 128, 256, 512)):
            self.add_module(f"layer{i}_1x1", ConvRelu(c, c, 1))
        self.conv_up3 = ConvRelu(512 + 256, 512)
        self.conv_up2 = ConvRelu(512 + 128, 256)
        self.conv_up1 = ConvRelu(256 + 64, 256)
        self.conv_up0 = ConvRelu(256 + 64, 128)
        self.conv_original_size2 = ConvRelu(128 + 64, 64)
        self.conv_last = Conv2d(64, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x.to(self.dtype).contiguous())
        x_orig = self.conv_original_size1(self.conv_original_size0(x))
        feats = self.encoder(x)
        up = lambda y: nchw(upsample2x(nhwc(y), "bilinear", align_corners=True))
        y = up(self.layer4_1x1(feats[4]))
        for i, conv in ((3, self.conv_up3), (2, self.conv_up2),
                        (1, self.conv_up1), (0, self.conv_up0)):
            skip = getattr(self, f"layer{i}_1x1")(feats[i])
            y = up(conv(torch.cat([y, skip], 1)))
        y = self.conv_original_size2(torch.cat([y, x_orig], 1))
        return nhwc(self.conv_last(y).float())
