"""Encoder registry (counterpart of ``mmr_tpu/models/encoders/__init__.py``).

Every encoder is a module returning a 5-level feature pyramid
``[f1 (s2), f2 (s4), f3 (s8), f4 (s16), f5 (s32)]`` with declared channel
counts and its preprocessing statistics. Ported: the flagship's
MobileNetV3 and the ResNet-18/34 (``output_stride`` 32 or 16); ConvNeXt
and MiT wait (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from mmr_tpu_torch.models.encoders.mobilenetv3 import MobileNetV3SmallEncoder
from mmr_tpu_torch.models.encoders.resnet import ResNetEncoder

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    build: Callable  # (**kw) -> nn.Module
    channels: tuple[int, ...]  # channels of [f1..f5]
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


_MBV3 = EncoderSpec(build=lambda **kw: MobileNetV3SmallEncoder(**kw),
                    channels=(16, 16, 24, 48, 576))

_RESNET_CH = (64, 64, 128, 256, 512)

ENCODERS: dict[str, EncoderSpec] = {
    # timm-universal naming of the reference config
    "tu-mobilenetv3_small_100": _MBV3,
    "mobilenetv3_small_100": _MBV3,
    "resnet18": EncoderSpec(build=lambda **kw: ResNetEncoder((2, 2, 2, 2), **kw),
                            channels=_RESNET_CH),
    "resnet34": EncoderSpec(build=lambda **kw: ResNetEncoder((3, 4, 6, 3), **kw),
                            channels=_RESNET_CH),
}


def get_encoder(name: str) -> EncoderSpec:
    if name not in ENCODERS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported (ported: {sorted(ENCODERS)}; "
            "the others are listed in ROADMAP.md)")
    return ENCODERS[name]
