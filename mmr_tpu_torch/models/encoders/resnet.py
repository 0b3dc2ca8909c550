"""ResNet-18/34 feature-pyramid encoder, counterpart of
``mmr_tpu/models/encoders/resnet.py`` (torchvision ``resnet18/34`` as smp's
resnet encoders use it, ``ModelTraining.py:247-278``): 7×7/2 stem → BN →
ReLU (f1, s2) → 3×3/2 max-pool (−∞ padding) → four BasicBlock stages (f2 ..
f5, s4 .. s32), channels (64, 64, 128, 256, 512).

Its convs are plain convs in JAX too (``nn.Conv``, not ``Conv3x3``), so
they stay on the library conv; its BNs are flax ``nn.BatchNorm`` (centred:
:class:`~mmr_tpu_torch.models.layers.BatchNorm`). Module names mirror the
flax tree (``conv1``, ``bn1``, ``layer{i}_{b}`` with ``conv1``, ``bn1``,
``conv2``, ``bn2``, ``downsample_conv``, ``downsample_bn``), so JAX
variables convert mechanically (:mod:`mmr_tpu_torch.models.convert`).
Output stride 32 only: smp's dilated last stage (output stride 16,
DeepLabV3+) is not ported.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.layers import BatchNorm, Conv2d


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv2d(cin, cout, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class ResNetEncoder(nn.Module):
    def __init__(self, stage_sizes: tuple[int, ...] = (2, 2, 2, 2),
                 fused_frontend: bool = False):
        super().__init__()
        if fused_frontend:
            raise NotImplementedError(
                "the fused front-end exists for the MobileNetV3 stem only")
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, (n_blocks, ch) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                self.add_module(f"layer{i + 1}_{b}", BasicBlock(cin, ch, stride))
                cin = ch
        self.stage_sizes = tuple(stage_sizes)

    def forward(self, x):
        """NCHW (channels_last) image -> [f1 (s2), f2, f3, f4, f5 (s32)]."""
        f1 = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(f1, 3, 2, 1)
        feats = [f1]
        for i, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
            feats.append(x)
        return feats
