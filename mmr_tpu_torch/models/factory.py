"""Model factory (counterpart of ``mmr_tpu/models/factory.py``).

Both naming surfaces of the reference: smp-style
``create_model(arch="UnetPlusPlus", encoder_name="tu-mobilenetv3_small_100",
classes=10)`` for the arches ``UnetPlusPlus``, ``Unet``, ``DeepLabV3Plus``
and ``MAnet``; and the eight Path-A zoo strings (``factory.py:54-63``):
``segnet``, ``unet``, ``resnet18`` / ``resnet34``, ``smp_UNet++``,
``smp_unet18``, ``smp_DeepLabV3+``, ``smp_MANet``. ``unet`` is Path A's
hand-written UNet unless an ``encoder_name`` asks for smp's generic Unet
(``factory.py:113-128``). ``Segformer`` and the MiT / ConvNeXt encoders
are not ported and raise (ROADMAP).

Weights are initialised from an explicit ``torch.Generator`` (lecun-normal
convs and transposed convs, as flax initialises them; conv biases 0; BN at
identity) and the model is returned in eval mode on ``device`` (default
CUDA; never the CPU unless asked). Pretrained encoder weights and other
input channel counts wait (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.models.decoders import (DeepLabV3PlusModel, MAnetModel,
                                           UnetDecoderModel, UnetPlusPlusModel)
from mmr_tpu_torch.models.encoders import IMAGENET_MEAN, IMAGENET_STD, get_encoder
from mmr_tpu_torch.models.resnet_unet import ResNetUNet
from mmr_tpu_torch.models.segnet import SegNet
from mmr_tpu_torch.models.unet import UNet

# smp arch (lower case, no "-", " " or "_") -> (class, default encoder)
_ARCHES = {
    "unet": (UnetDecoderModel, "resnet18"),
    "unetplusplus": (UnetPlusPlusModel, "tu-mobilenetv3_small_100"),
    "unet++": (UnetPlusPlusModel, "tu-mobilenetv3_small_100"),
    "deeplabv3plus": (DeepLabV3PlusModel, "resnet18"),
    "deeplabv3+": (DeepLabV3PlusModel, "resnet18"),
    "manet": (MAnetModel, "resnet18"),
}
_NOT_PORTED = ("segformer",)


def _smp(cls, encoder):
    return lambda classes, dtype, encoder_name=encoder, **kw: cls(
        classes, encoder_name=encoder_name, dtype=dtype, **kw)


# Path-A zoo strings (lower case) -> a function (classes, dtype, **kwargs);
# ``ModelTraining.py:238-280``. As in JAX, the fixed-encoder entries drop
# an encoder_name and any other keyword they do not take.
_PATH_A_ZOO = {
    "segnet": lambda classes, dtype, apply_softmax=False, **kw:
        SegNet(classes, apply_softmax=apply_softmax, dtype=dtype),
    "unet": lambda classes, dtype, **kw: UNet(classes, dtype=dtype, **kw),
    "resnet18": lambda classes, dtype, **kw: ResNetUNet(classes, depth=18, dtype=dtype),
    "resnet34": lambda classes, dtype, **kw: ResNetUNet(classes, depth=34, dtype=dtype),
    "smp_unet++": _smp(UnetPlusPlusModel, "resnet18"),
    "smp_unet18": lambda classes, dtype, **kw: UnetDecoderModel(classes, dtype=dtype),
    "smp_deeplabv3+": lambda classes, dtype, **kw: DeepLabV3PlusModel(classes, dtype=dtype),
    "smp_manet": lambda classes, dtype, **kw: MAnetModel(classes, dtype=dtype),
}


@functools.lru_cache(maxsize=None)
def _channel_consts(mean: tuple, std: tuple, device: str):
    """``mean`` and ``std`` as f32 tensors on ``device``, made once: a fresh
    host-to-card copy on every call would wait for the card's queue."""
    return (torch.tensor(mean, dtype=torch.float32).to(device),
            torch.tensor(std, dtype=torch.float32).to(device))


@dataclasses.dataclass(frozen=True)
class Preprocessing:
    """ImageNet-style normalization of [0, 1] RGB (NHWC, last axis)."""

    mean: tuple[float, float, float]
    std: tuple[float, float, float]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = _channel_consts(tuple(self.mean), tuple(self.std), str(x.device))
        return (x - mean) / std


def get_preprocessing(encoder_name: str | None = None) -> Preprocessing:
    if encoder_name is None:
        return Preprocessing(IMAGENET_MEAN, IMAGENET_STD)
    spec = get_encoder(encoder_name)
    return Preprocessing(spec.mean, spec.std)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Conv and transposed-conv kernels ~ N(0, 1/fan_in) (flax lecun-normal
    scale; fan_in = kh·kw·in per group for a conv, kh·kw·in for a
    transposed conv, as flax counts its (kh, kw, in, out) kernel), biases
    0, BN at identity — drawn on the CPU from ``generator`` in module
    order, so a seed gives the same weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    return model


def create_model(arch: str = "UnetPlusPlus", encoder_name: str | None = None,
                 classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 **kwargs) -> nn.Module:
    """Build a segmentation model on ``device`` in eval mode. ``arch`` is an
    smp arch or a Path-A zoo string; ``encoder_name`` defaults to the
    arch's own (``tu-mobilenetv3_small_100`` for UnetPlusPlus, ``resnet18``
    for the others and the ``smp_*`` strings). ``kwargs`` go to the
    architecture (for UNet++: ``fused``, ``fused_frontend``,
    ``packed_min_hw``, ``decoder_channels``; for ``unet``: ``bilinear``,
    ``upsample_mode``; for ``segnet``: ``apply_softmax``)."""
    dev = resolve_device(device)
    key = arch.lower().replace("-", "").replace(" ", "")
    smp_key = key.replace("_", "")
    if smp_key in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} (with its MiT / ConvNeXt encoders) is not ported "
            "yet (ROADMAP.md)")
    # "unet" is ambiguous: Path A's hand-written UNet vs smp's generic Unet;
    # an explicit encoder_name selects the generic one
    if key in _PATH_A_ZOO and not (smp_key in _ARCHES and encoder_name):
        build = _PATH_A_ZOO[key]
    elif smp_key in _ARCHES:
        build = _smp(*_ARCHES[smp_key])
    else:
        raise ValueError(f"unknown arch {arch!r}; known: "
                         f"{sorted(_ARCHES) + sorted(_PATH_A_ZOO)}")
    if encoder_name:
        kwargs["encoder_name"] = encoder_name
    model = build(classes, dtype, **kwargs)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()
