"""Model factory (counterpart of ``mmr_tpu/models/factory.py``).

``create_model(arch="UnetPlusPlus", encoder_name="tu-mobilenetv3_small_100",
classes=10)`` builds the flagship; other architectures are not ported yet
(ROADMAP). Weights are initialised from an explicit ``torch.Generator``
(lecun-normal convs, as flax initialises them; BN at identity) and the model
is returned in eval mode on ``device`` (default CUDA; never the CPU unless
asked). Pretrained encoder weights and other input channel counts wait for
the CLI slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.models.decoders import UnetPlusPlusModel
from mmr_tpu_torch.models.encoders import IMAGENET_MEAN, IMAGENET_STD, get_encoder

_ARCHES = {"unetplusplus": UnetPlusPlusModel, "unet++": UnetPlusPlusModel}


@dataclasses.dataclass(frozen=True)
class Preprocessing:
    """ImageNet-style normalization of [0, 1] RGB (NHWC, last axis)."""

    mean: tuple[float, float, float]
    std: tuple[float, float, float]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return (x - mean) / std


def get_preprocessing(encoder_name: str | None = None) -> Preprocessing:
    if encoder_name is None:
        return Preprocessing(IMAGENET_MEAN, IMAGENET_STD)
    spec = get_encoder(encoder_name)
    return Preprocessing(spec.mean, spec.std)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Conv kernels ~ N(0, 1/fan_in) (flax lecun-normal scale), conv biases
    0, BN at identity — drawn on the CPU from ``generator`` in module
    order, so a seed gives the same weights on every device."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    return model


def create_model(arch: str = "UnetPlusPlus",
                 encoder_name: str = "tu-mobilenetv3_small_100",
                 classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 **kwargs) -> nn.Module:
    """Build a segmentation model on ``device`` in eval mode. ``kwargs`` go
    to the architecture (for UNet++: ``fused``, ``fused_frontend``,
    ``packed_min_hw``, ``decoder_channels``)."""
    dev = resolve_device(device)
    key = arch.lower().replace("-", "").replace(" ", "").replace("_", "")
    if key not in _ARCHES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: UnetPlusPlus; the "
            "others are listed in ROADMAP.md)")
    model = _ARCHES[key](classes, encoder_name=encoder_name, dtype=dtype,
                         **kwargs)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()
