"""MobileNetV3-Small encoder (timm ``mobilenetv3_small_100`` topology),
counterpart of ``mmr_tpu/models/encoders/mobilenetv3.py``.

Feature pyramid channels (16, 16, 24, 48, 576) at strides (2, 4, 8, 16, 32).
Module names mirror the flax tree (``conv_stem``, ``bn1``, ``b0_0`` ...
``b4_2``, ``b5_0_conv``, ``b5_0_bn1``) so JAX variables convert
mechanically (:mod:`mmr_tpu_torch.models.convert`).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.fused_blocks import as_array
from mmr_tpu_torch.models.layers import (Conv2d, FusedBatchNorm,
                                         SqueezeExcite, hard_swish)

_ACT = {"relu": F.relu, "hardswish": hard_swish}


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, exp_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, use_se: bool = False, act: str = "hardswish"):
        super().__init__()
        self.act = act
        self.residual = stride == 1 and in_ch == out_ch
        if exp_ch != in_ch:
            self.conv_pw = Conv2d(in_ch, exp_ch, 1, bias=False)
            self.bn1 = FusedBatchNorm(exp_ch)
        else:
            self.conv_pw = None
        self.conv_dw = Conv2d(exp_ch, exp_ch, kernel, stride, kernel // 2,
                              groups=exp_ch, bias=False)
        self.bn2 = FusedBatchNorm(exp_ch)
        self.se = (SqueezeExcite(exp_ch, _make_divisible(exp_ch / 4))
                   if use_se else None)
        self.conv_pwl = Conv2d(exp_ch, out_ch, 1, bias=False)
        self.bn3 = FusedBatchNorm(out_ch)

    def forward(self, x):
        act = _ACT[self.act]
        y = x
        if self.conv_pw is not None:
            y = act(self.bn1(self.conv_pw(y)))
        y = act(self.bn2(self.conv_dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class DepthwiseSeparable(nn.Module):
    """timm 'ds' block: depthwise k3 -> SE -> pointwise (no expansion)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, use_se: bool = True, act: str = "relu"):
        super().__init__()
        self.act = act
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_dw = Conv2d(in_ch, in_ch, kernel, stride, kernel // 2,
                              groups=in_ch, bias=False)
        self.bn1 = FusedBatchNorm(in_ch)
        self.se = (SqueezeExcite(in_ch, _make_divisible(in_ch / 4))
                   if use_se else None)
        self.conv_pw = Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = FusedBatchNorm(out_ch)

    def forward(self, x):
        y = _ACT[self.act](self.bn1(self.conv_dw(x)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class MobileNetV3SmallEncoder(nn.Module):
    """``fused_frontend=True`` runs the stem and b0_0's depthwise conv as K2
    launches (:mod:`mmr_tpu_torch.models.fused_encoder`) and returns f1/f2
    as :class:`Pending` (raw + pending BN) — valid only when the consumer
    is the fused UNet++ decoder. The parameters are the same either way."""

    def __init__(self, fused_frontend: bool = False):
        super().__init__()
        # fused_encoder builds on this module's blocks: import at use
        from mmr_tpu_torch.models.fused_encoder import FusedDSBlock

        self.fused_frontend = fused_frontend
        self.conv_stem = Conv2d(3, 16, 3, 2, 1, bias=False)
        self.bn1 = FusedBatchNorm(16)
        self.b0_0 = FusedDSBlock(16, 16, 3, 2, True, "relu")
        ir = InvertedResidual
        self.b1_0 = ir(16, 72, 24, 3, 2, False, "relu")
        self.b1_1 = ir(24, 88, 24, 3, 1, False, "relu")
        self.b2_0 = ir(24, 96, 40, 5, 2, True, "hardswish")
        self.b2_1 = ir(40, 240, 40, 5, 1, True, "hardswish")
        self.b2_2 = ir(40, 240, 40, 5, 1, True, "hardswish")
        self.b3_0 = ir(40, 120, 48, 5, 1, True, "hardswish")
        self.b3_1 = ir(48, 144, 48, 5, 1, True, "hardswish")
        self.b4_0 = ir(48, 288, 96, 5, 2, True, "hardswish")
        self.b4_1 = ir(96, 576, 96, 5, 1, True, "hardswish")
        self.b4_2 = ir(96, 576, 96, 5, 1, True, "hardswish")
        # timm blocks[5]: ConvBnAct 1x1 96->576 hardswish (features_only)
        self.b5_0_conv = Conv2d(96, 576, 1, bias=False)
        self.b5_0_bn1 = FusedBatchNorm(576)

    def forward(self, x):
        """NCHW (channels_last) image -> [f1 (s2), f2, f3, f4, f5 (s32)]."""
        if self.fused_frontend:
            from mmr_tpu_torch.models.fused_encoder import fused_stem

            f1 = fused_stem(self, x)            # Pending, hswish pending
            f2 = self.b0_0.fused(f1)            # Pending, linear pending
            x2 = as_array(f2)
        else:
            f1 = hard_swish(self.bn1(self.conv_stem(x)))
            f2 = x2 = self.b0_0(f1)
        f3 = self.b1_1(self.b1_0(x2))
        x = self.b2_2(self.b2_1(self.b2_0(f3)))
        f4 = self.b3_1(self.b3_0(x))
        x = self.b4_2(self.b4_1(self.b4_0(f4)))
        f5 = hard_swish(self.b5_0_bn1(self.b5_0_conv(x)))
        return [f1, f2, f3, f4, f5]
