"""Encoder–decoder segmentation models over a pyramid encoder (counterpart
of ``mmr_tpu/models/decoders.py``): UNet++, and smp's Unet, DeepLabV3+ and
MAnet. Topology, concat order and module names replicate the JAX models,
so JAX variables convert mechanically.

UNet++ (smp ``UnetPlusPlusDecoder``, see :func:`smp_unetpp_plan`):
``fused=True`` runs every node whose output H·W ≥ ``packed_min_hw`` as two
K1 launches (:mod:`fused_blocks`) and the head as a third; smaller nodes
stay on cuDNN. The plain and fused paths share one ``state_dict``. In train
mode with ``labels`` the fused model runs the head as the fused head + loss
kernel (:mod:`..ops.head_loss`) and returns the loss partials instead of
logits.

Unet, DeepLabV3+ and MAnet run the plain path only: their bf16 3×3 stride-1
convs at H·W ≥ 4096 (``Conv3x3``) take K6, the rest the library conv, as in
JAX. The Unet ``packed=True`` path and Segformer are not ported (ROADMAP).
Every forward takes an NHWC image batch and returns NHWC f32 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.encoders import get_encoder
from mmr_tpu_torch.models.fused_blocks import (FusedConvBN, Pending, as_array,
                                               as_pending, up_lazy)
from mmr_tpu_torch.models.fused_blocks import hwio
from mmr_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvBN, Dropout,
                                         nchw, nhwc)
from mmr_tpu_torch.ops.head_loss import fused_head_loss
from mmr_tpu_torch.ops.resize import resize_bilinear, upsample2x


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


def _up_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """×``scale`` bilinear resize (align_corners=True) of an NCHW view."""
    h, w = x.shape[-2:]
    return nchw(resize_bilinear(nhwc(x), (h * scale, w * scale),
                                align_corners=True))


class SegmentationHead(FusedConvBN):
    """3×3 conv + bias to classes (smp SegmentationHead, upsampling 1: every
    ported decoder ends at full resolution; DeepLabV3+ resizes on its own)."""

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


def _encode(model: nn.Module, x: torch.Tensor) -> list[torch.Tensor]:
    """NHWC image -> the encoder's NCHW pyramid [f1 .. f5], in the model's
    compute dtype."""
    return model.encoder(nchw(x.to(model.dtype).contiguous()))


class UnetDecoderModel(nn.Module):
    """smp ``Unet`` over a pyramid encoder (``decoders.py:83-110``, plain
    path): five :class:`DecoderBlock` (×2 nearest upsample, concat the skip
    [f4, f3, f2, f1, none], two ConvBN) and a 3×3 head. ``packed=True``
    (the JAX packed-halo dataflow) is not ported and raises."""

    def __init__(self, num_classes: int, encoder_name: str = "resnet18",
                 decoder_channels: tuple[int, ...] = (256, 128, 64, 32, 16),
                 packed: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if packed:
            raise NotImplementedError("the packed smp Unet path is not ported "
                                      "(ROADMAP.md)")
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        self.encoder = spec.build()
        enc = spec.channels
        skip_ch = list(enc[:-1][::-1]) + [0]
        in_ch = [enc[-1]] + list(decoder_channels[:-1])
        for i, ch in enumerate(decoder_channels):
            self.add_module(f"block{i}", DecoderBlock(in_ch[i], skip_ch[i], ch))
        self.n_blocks = len(decoder_channels)
        self.head = SegmentationHead(decoder_channels[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = _encode(self, x)
        skips = feats[:-1][::-1] + [None]
        y = feats[-1]
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y, None if skips[i] is None else [skips[i]])
        return nhwc(self.head(y))


class SeparableConvBNReLU(nn.Module):
    """smp ``SeparableConv2d`` + BN + ReLU (``decoders.py:567-589``): a
    bias-free depthwise 3×3 (dilation d, padding d: a grouped library
    conv, as in JAX), a bias-free pointwise 1×1, flax ``nn.BatchNorm``."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        d = dilation
        self.dw = Conv2d(cin, cin, 3, 1, d, dilation=d, groups=cin, bias=False)
        self.pw = Conv2d(cin, cout, 1, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.pw(self.dw(x))))


class ASPP(nn.Module):
    """smp's separable atrous spatial pyramid pooling
    (``decoders.py:592-621``): a 1×1 branch, three separable branches at
    ``rates``, a global-pool branch broadcast back, then 1×1 project + BN
    + ReLU + Dropout(0.5)."""

    def __init__(self, cin: int, cout: int = 256,
                 rates: tuple[int, ...] = (12, 24, 36)):
        super().__init__()
        for name, c in (("c0", cin), ("pool", cin), ("proj", cout * (len(rates) + 2))):
            self.add_module(f"{name}_conv", Conv2d(c, cout, 1, bias=False))
            self.add_module(f"{name}_bn", BatchNorm(cout))
        for i, r in enumerate(rates, start=1):
            self.add_module(f"c{i}", SeparableConvBNReLU(cin, cout, r))
        self.n_rates = len(rates)
        self.drop = Dropout(0.5)

    def _cbr(self, y, name):
        return F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(y)))

    def forward(self, x):
        branches = [self._cbr(x, "c0")]
        branches += [getattr(self, f"c{i}")(x) for i in range(1, self.n_rates + 1)]
        pooled = self._cbr(x.mean((2, 3), keepdim=True), "pool")
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return self.drop(self._cbr(torch.cat(branches, 1), "proj"))


class DeepLabV3PlusModel(nn.Module):
    """smp ``DeepLabV3Plus`` (``decoders.py:624-667``): the encoder at
    output stride 16 (dilated last stage), separable ASPP + a separable
    post conv, ×4 bilinear (align_corners=True), a 48-channel projection of
    the stride-4 feature, a separable fuse, a 1×1 head and a ×4 bilinear
    upsample of the f32 logits."""

    def __init__(self, num_classes: int, encoder_name: str = "resnet18",
                 aspp_ch: int = 256, atrous_rates: tuple[int, ...] = (12, 24, 36),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        self.encoder = spec.build(output_stride=16)
        enc = spec.channels
        self.aspp = ASPP(enc[-1], aspp_ch, atrous_rates)
        self.post = SeparableConvBNReLU(aspp_ch, aspp_ch)
        self.block1_conv = Conv2d(enc[1], 48, 1, bias=False)
        self.block1_bn = BatchNorm(48)
        self.block2 = SeparableConvBNReLU(aspp_ch + 48, aspp_ch)
        self.head_conv = Conv2d(aspp_ch, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = _encode(self, x)
        y = self.post(self.aspp(feats[-1]))
        y = _up_bilinear(y, 4)
        h = F.relu(self.block1_bn(self.block1_conv(feats[1])))
        y = self.block2(torch.cat([y, h], 1))
        logits = self.head_conv(y).float()
        up = x.shape[1] // logits.shape[2]
        if up > 1:
            logits = _up_bilinear(logits, up)
        return nhwc(logits)


class PAB(nn.Module):
    """smp's position attention block (``decoders.py:670-699``) with both
    of its quirks: the softmax runs over the whole flattened hw × hw map,
    and the attended (b, hw, C) tensor is read as (b, C, h, w) by a raw
    reshape before the residual add. Products in f32 of the compute-dtype
    values, as JAX's ``preferred_element_type``."""

    def __init__(self, c: int, pab_channels: int = 64):
        super().__init__()
        self.top_conv = Conv2d(c, pab_channels, 1)
        self.center_conv = Conv2d(c, pab_channels, 1)
        self.bottom_conv = Conv2d(c, c, 3, 1, 1)
        self.out_conv = Conv2d(c, c, 3, 1, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        flat = lambda y: nhwc(y).reshape(b, h * w, -1)
        top, center = flat(self.top_conv(x)), flat(self.center_conv(x))
        bottom = flat(self.bottom_conv(x))
        sp = center.float() @ top.float().transpose(1, 2)
        sp = torch.softmax(sp.reshape(b, -1), -1).reshape(b, h * w, h * w)
        att = (sp.to(x.dtype).float() @ bottom.float()).to(x.dtype)
        return self.out_conv(x + att.reshape(b, c, h, w))


class MFAB(nn.Module):
    """smp's multi-scale fusion attention block (``decoders.py:702-733``):
    ConvBN 3×3 then 1×1 to the skip's channels, ×2 nearest upsample, SE
    attention of both streams summed and applied to the upsampled one,
    concat the skip, two ConvBN."""

    def __init__(self, cin: int, skip_ch: int, out_ch: int, reduction: int = 16):
        super().__init__()
        red = max(1, skip_ch // reduction)
        self.hl_conv1 = ConvBN(cin, cin)
        self.hl_conv2 = ConvBN(cin, skip_ch, kernel=1, padding=0)
        for name in ("se_hl", "se_ll"):
            self.add_module(f"{name}_reduce", Conv2d(skip_ch, red, 1))
            self.add_module(f"{name}_expand", Conv2d(red, skip_ch, 1))
        self.conv1 = ConvBN(2 * skip_ch, out_ch)
        self.conv2 = ConvBN(out_ch, out_ch)

    def _se(self, y, name):
        s = getattr(self, f"{name}_reduce")(y.mean((2, 3), keepdim=True))
        return torch.sigmoid(getattr(self, f"{name}_expand")(F.relu(s)))

    def forward(self, x, skip):
        x = nchw(upsample2x(nhwc(self.hl_conv2(self.hl_conv1(x)))))
        att = self._se(x, "se_hl") + self._se(skip, "se_ll")
        return self.conv2(self.conv1(torch.cat([x * att, skip], 1)))


class MAnetModel(nn.Module):
    """smp ``MAnet`` (``decoders.py:736-763``): a :class:`PAB` centre on the
    deepest feature, :class:`MFAB` blocks wherever a skip exists, a plain
    :class:`DecoderBlock` for the skipless tail, a 3×3 head."""

    def __init__(self, num_classes: int, encoder_name: str = "resnet18",
                 decoder_channels: tuple[int, ...] = (256, 128, 64, 32, 16),
                 pab_channels: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        self.encoder = spec.build()
        enc = spec.channels
        self.center = PAB(enc[-1], pab_channels)
        skip_ch = list(enc[:-1][::-1])
        in_ch = [enc[-1]] + list(decoder_channels[:-1])
        for i, ch in enumerate(decoder_channels):
            block = (MFAB(in_ch[i], skip_ch[i], ch) if i < len(skip_ch)
                     else DecoderBlock(in_ch[i], 0, ch))
            self.add_module(f"block{i}", block)
        self.n_blocks = len(decoder_channels)
        self.head = SegmentationHead(decoder_channels[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = _encode(self, x)
        skips = feats[:-1][::-1]
        y = self.center(feats[-1])
        for i in range(self.n_blocks):
            block = getattr(self, f"block{i}")
            y = block(y, skips[i]) if i < len(skips) else block(y)
        return nhwc(self.head(y))
