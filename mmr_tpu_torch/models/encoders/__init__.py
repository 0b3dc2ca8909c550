"""Encoder registry (counterpart of ``mmr_tpu/models/encoders/__init__.py``).

Every encoder is a module returning a 5-level feature pyramid
``[f1 (s2), f2 (s4), f3 (s8), f4 (s16), f5 (s32)]`` with declared channel
counts and its preprocessing statistics. ConvNeXt(-V2) and MiT have no
stride-2 level: their f1 is ``None`` and its declared channels 0. Every
encoder of the JAX registry is here; an unknown name raises ``ValueError``
as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from mmr_tpu_torch.models.encoders.convnext import ConvNeXtEncoder
from mmr_tpu_torch.models.encoders.mix_transformer import MixVisionTransformerEncoder
from mmr_tpu_torch.models.encoders.mobilenetv3 import MobileNetV3SmallEncoder
from mmr_tpu_torch.models.encoders.resnet import ResNetEncoder

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    build: Callable  # (**kw) -> nn.Module
    channels: tuple[int, ...]  # channels of [f1..f5]; 0: no such level
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


_MBV3 = EncoderSpec(build=lambda **kw: MobileNetV3SmallEncoder(**kw),
                    channels=(16, 16, 24, 48, 576))

_RESNET_CH = (64, 64, 128, 256, 512)


def _convnext(use_grn: bool) -> EncoderSpec:
    return EncoderSpec(
        build=lambda **kw: ConvNeXtEncoder((3, 3, 9, 3), (96, 192, 384, 768),
                                           use_grn=use_grn, **kw),
        channels=(0, 96, 192, 384, 768))


def _mit(dims, depths) -> EncoderSpec:
    return EncoderSpec(
        build=lambda **kw: MixVisionTransformerEncoder(dims, depths, **kw),
        channels=(0,) + tuple(dims))


ENCODERS: dict[str, EncoderSpec] = {
    # timm-universal naming of the reference config
    "tu-mobilenetv3_small_100": _MBV3,
    "mobilenetv3_small_100": _MBV3,
    "resnet18": EncoderSpec(build=lambda **kw: ResNetEncoder((2, 2, 2, 2), **kw),
                            channels=_RESNET_CH),
    "resnet34": EncoderSpec(build=lambda **kw: ResNetEncoder((3, 4, 6, 3), **kw),
                            channels=_RESNET_CH),
    # PKG-INFO Example 3's encoder family
    "tu-convnextv2_tiny": _convnext(use_grn=True),
    "tu-convnext_tiny": _convnext(use_grn=False),
    # PKG-INFO Example 2's encoder family (Segformer)
    "mit_b0": _mit((32, 64, 160, 256), (2, 2, 2, 2)),
    "mit_b2": _mit((64, 128, 320, 512), (3, 4, 6, 3)),
}


def get_encoder(name: str) -> EncoderSpec:
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; available: {sorted(ENCODERS)}")
    return ENCODERS[name]
