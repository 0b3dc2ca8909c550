"""ConvNeXt / ConvNeXt-V2 encoder, counterpart of
``mmr_tpu/models/encoders/convnext.py`` (timm ``tu-convnext*``; the
reference's best published result is ``Unet + tu-convnextv2_tiny``).

A 4-stage pyramid at strides 4/8/16/32 with no stride-2 feature: the
pyramid is ``[None, s4, s8, s16, s32]`` and the decoders skip the missing
level. V2 replaces LayerScale by GRN in the MLP. Module names mirror the
flax tree (``stem_conv``, ``stem_norm``, ``downsample_norm{i}``,
``downsample_conv{i}``, ``stage{i}_block{b}`` with ``dwconv``, ``norm``,
``pwconv1``, ``grn``, ``pwconv2``, ``gamma``).

JAX's rounding points are kept: the 7×7 depthwise conv in the compute
dtype (a grouped library conv, as XLA runs it), flax's LayerNorm
(:class:`~mmr_tpu_torch.models.layers.LayerNorm`), exact GELU, GRN's
statistics in f32 with ``nx`` cast to the compute dtype and its result
``gamma·(x·nx) + beta + x`` formed in f32 and rounded once
(``convnext.py:26-29``), LayerScale's ``gamma`` cast before its product.
Convs without padding take flax's SAME padding (none when the size
divides by the stride).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, nchw, nhwc


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``padding="SAME"`` for a k×k stride-s conv of an NCHW view:
    total ``max((⌈n/s⌉ − 1)·s + k − n, 0)``, the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class GRN(nn.Module):
    """Global response normalization (ConvNeXt-V2) over an NHWC tensor."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt(x.float().square().sum((1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta
                + x.float()).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, use_grn: bool = False, ls_init: float = 1e-6):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim) if use_grn else None
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = None if use_grn else nn.Parameter(torch.full((dim,), ls_init))

    def forward(self, x):
        y = F.gelu(self.pwconv1(self.norm(nhwc(self.dwconv(x)))))
        if self.grn is not None:
            y = self.grn(y)
        y = self.pwconv2(y)
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + nchw(y)


class ConvNeXtEncoder(nn.Module):
    """``forward``: NCHW (channels_last) image -> ``[None, s4, s8, s16,
    s32]``. The encoder has no BN and no dropout: train and eval mode
    compute the same. No fused front end and no output stride: the fused
    stem is MobileNetV3's, and DeepLabV3+'s dilation is ResNet's."""

    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 use_grn: bool = False, fused_frontend: bool = False):
        super().__init__()
        if fused_frontend:
            raise NotImplementedError(
                "the fused front-end exists for the MobileNetV3 stem only")
        self.depths = tuple(depths)
        self.stem_conv = Conv2d(3, dims[0], 4, 4)
        self.stem_norm = LayerNorm(dims[0])
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i > 0:
                self.add_module(f"downsample_norm{i}", LayerNorm(dims[i - 1]))
                self.add_module(f"downsample_conv{i}", Conv2d(dims[i - 1], dim, 2, 2))
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", ConvNeXtBlock(dim, use_grn))

    def forward(self, x):
        feats = [None]
        x = self.stem_conv(pad_same(x, 4, 4))
        x = nchw(self.stem_norm(nhwc(x)))
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = nchw(getattr(self, f"downsample_norm{i}")(nhwc(x)))
                x = getattr(self, f"downsample_conv{i}")(pad_same(x, 2, 2))
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x)
            feats.append(x)
        return feats
