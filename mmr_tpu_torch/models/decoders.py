"""UNet++ over a pyramid encoder (counterpart of the UNet++ part of
``mmr_tpu/models/decoders.py``).

Topology, concat order and module names replicate the JAX
``UnetPlusPlusModel`` (smp ``UnetPlusPlusDecoder``, see
:func:`smp_unetpp_plan`). ``fused=True`` runs every node whose output
H·W ≥ ``packed_min_hw`` as two K1 launches (:mod:`fused_blocks`) and the
head as a third; smaller nodes stay on cuDNN. The plain and fused paths
share one ``state_dict``. In train mode with ``labels`` the fused model
runs the head as the fused head + loss kernel (:mod:`..ops.head_loss`) and
returns the loss partials instead of logits.
"""

from __future__ import annotations

import torch
from torch import nn

from mmr_tpu_torch.models.encoders import get_encoder
from mmr_tpu_torch.models.fused_blocks import (FusedConvBN, Pending, as_array,
                                               as_pending, up_lazy)
from mmr_tpu_torch.models.fused_blocks import hwio
from mmr_tpu_torch.models.layers import nchw, nhwc
from mmr_tpu_torch.ops.head_loss import fused_head_loss
from mmr_tpu_torch.ops.resize import upsample2x


class DecoderBlock(nn.Module):
    """×2 nearest upsample -> concat skips -> (Conv3×3-BN-ReLU) ×2."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = FusedConvBN(in_ch + skip_ch, out_ch)
        self.conv2 = FusedConvBN(out_ch, out_ch)

    def forward(self, x, skips=None):
        x = nchw(upsample2x(nhwc(x)))
        cat = [x] + [s for s in (skips or []) if s is not None]
        if len(cat) > 1:
            x = torch.cat(cat, dim=1)
        return self.conv2(self.conv1(x))

    def fused(self, inputs: list[Pending]) -> Pending:
        """``inputs`` in concat order: [up(x), skips...]."""
        return self.conv2.fused([self.conv1.fused(inputs)])


class SegmentationHead(FusedConvBN):
    """3×3 conv + bias to classes (smp SegmentationHead, upsampling 1)."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__(in_ch, num_classes, act="identity", use_bn=False,
                         use_bias=True)

    def forward(self, x):
        return super().forward(x).float()

    def fused_loss(self, top: Pending, labels: torch.Tensor,
                   with_conf: bool = True):
        """Head conv + DiceCE statistics in one K5a launch (K5b backward):
        ``(logp, stats, conf)`` (``packed_blocks.py::PackedHeadLoss``)."""
        return fused_head_loss(top, hwio(self.conv.weight), self.conv.bias,
                               labels, with_conf)


def smp_unetpp_plan(enc_ch: tuple[int, ...], dec_ch: tuple[int, ...]):
    """smp ``UnetPlusPlusDecoder``'s exact block plan: ``{(d, l): (in_ch,
    skip_ch, out_ch)}`` keyed like smp's ``blocks["x_{d}_{l}"]`` for encoder
    channels ``enc_ch`` (fine -> coarse)."""
    rev = list(enc_ch[::-1])
    in_ch = [rev[0]] + list(dec_ch[: len(rev) - 1])
    skip_ch = rev[1:] + [0]
    out_ch = list(dec_ch)
    blocks: dict[tuple[int, int], tuple[int, int, int]] = {}
    for layer in range(len(in_ch) - 1):
        for d in range(layer + 1):
            if d == 0:
                blocks[(0, layer)] = (in_ch[layer],
                                      skip_ch[layer] * (layer + 1),
                                      out_ch[layer])
            else:
                blocks[(d, layer)] = (skip_ch[layer - 1],
                                      skip_ch[layer] * (layer + 1 - d),
                                      skip_ch[layer])
    blocks[(0, len(in_ch) - 1)] = (in_ch[-1], 0, out_ch[len(in_ch) - 1])
    return blocks


class UnetPlusPlusModel(nn.Module):
    """UNet++ — smp-exact nested dense decoder; 3,714,090 parameters with
    the mbv3-small encoder and 10 classes. Over ``resnet18`` (Path A's
    ``smp_UNet++``) the same generic plan runs with encoder channels (64,
    64, 128, 256, 512). Every registered encoder has five feature levels,
    so the head's upsampling is 1 (``decoders.py:324``).

    ``forward`` takes an NHWC image batch and returns NHWC f32 logits.
    ``dtype`` is the compute dtype (parameters stay f32). ``fused=True``
    (bf16 only) runs the fine-resolution nodes and the head on the fused
    K1 kernel; ``fused_frontend=True`` (needs ``fused``) also runs the
    encoder stem and b0_0 on K2. In train mode BN takes batch statistics
    and the kernels' backward runs under autograd; ``labels`` (the (B, H,
    W) class ids; fused model only) routes the head through the fused head
    + loss kernel and ``forward`` returns ``{"stats", "conf", "n_pixels",
    "logp"}`` (``packed_chain.assemble_dice_ce`` reads the first three)."""

    def __init__(self, num_classes: int,
                 encoder_name: str = "tu-mobilenetv3_small_100",
                 decoder_channels: tuple[int, ...] = (256, 128, 64, 32, 16),
                 fused: bool = False, packed_min_hw: int = 64 * 64,
                 fused_frontend: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if fused_frontend and not fused:
            raise ValueError("fused_frontend requires fused=True")
        if fused and dtype != torch.bfloat16:
            raise ValueError("the fused path computes in bf16")
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.fused = fused
        self.packed_min_hw = packed_min_hw
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        self.encoder = spec.build(fused_frontend=fused_frontend)
        self.plan = smp_unetpp_plan(spec.channels, tuple(decoder_channels))
        for (d, l), (i, s, o) in self.plan.items():
            self.add_module(f"x_{d}_{l}", DecoderBlock(i, s, o))
        self.depth = len(spec.channels) - 1
        self.head = SegmentationHead(decoder_channels[-1], num_classes)

    def _node(self, d: int, l: int) -> DecoderBlock:
        return getattr(self, f"x_{d}_{l}")

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                with_conf: bool = True):
        if labels is not None and not self.fused:
            raise ValueError("labels route the fused head + loss: fused=True only")
        x = nchw(x.to(self.dtype).contiguous())
        fr = self.encoder(x)[::-1]             # [f5 .. f1], smp order
        depth = self.depth
        if self.fused:
            return self._fused_decoder(fr, depth, labels, with_conf)
        dense: dict[tuple[int, int], torch.Tensor] = {}
        for layer in range(depth):
            for d in range(depth - layer):
                l = d + layer
                if layer == 0:
                    x_in, skips = fr[d], [fr[d + 1]]
                else:
                    x_in = dense[(d, l - 1)]
                    skips = [dense[(i, l)] for i in range(d + 1, l + 1)] \
                        + [fr[l + 1]]
                dense[(d, l)] = self._node(d, l)(x_in, skips)
        dense[(0, depth)] = self._node(0, depth)(dense[(0, depth - 1)])
        return nhwc(self.head(dense[(0, depth)]))

    def _fused_decoder(self, fr, depth: int, labels=None, with_conf=True):
        """Same topology; nodes at an output scale with H·W ≥
        ``packed_min_hw`` run as K1 launches over Pending inputs (lazy ×2
        upsample of the node input, skips consumed raw with their BN
        pending), the rest on cuDNN over materialized inputs."""
        h5, w5 = fr[0].shape[-2:]

        def run_node(d, l, x_in, skips):
            block = self._node(d, l)
            if (h5 << (l + 1)) * (w5 << (l + 1)) < self.packed_min_hw:
                return block(as_array(x_in), [as_array(s) for s in skips])
            return block.fused([up_lazy(x_in)] + [as_pending(s) for s in skips])

        dense: dict[tuple[int, int], object] = {}
        for layer in range(depth):
            for d in range(depth - layer):
                l = d + layer
                if layer == 0:
                    x_in, skips = fr[d], [fr[d + 1]]
                else:
                    x_in = dense[(d, l - 1)]
                    skips = [dense[(i, l)] for i in range(d + 1, l + 1)] \
                        + [fr[l + 1]]
                dense[(d, l)] = run_node(d, l, x_in, skips)
        top = run_node(0, depth, dense[(0, depth - 1)], [])
        if isinstance(top, Pending):
            if labels is not None:
                logp, stats, conf = self.head.fused_loss(top, labels, with_conf)
                return {"stats": stats, "conf": conf,
                        "n_pixels": labels.numel(), "logp": logp}
            return self.head.fused([top]).raw.float()
        if labels is not None:
            raise ValueError("the fused head + loss needs the top node fused "
                             "(its output H·W >= packed_min_hw)")
        return nhwc(self.head(top))
