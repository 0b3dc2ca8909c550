"""Encoder–decoder segmentation models over a pyramid encoder (counterpart
of ``mmr_tpu/models/decoders.py``): UNet++, and smp's Unet, DeepLabV3+,
MAnet and Segformer. Topology, concat order and module names replicate
the JAX models, so JAX variables convert mechanically.

UNet++ (smp ``UnetPlusPlusDecoder``, see :func:`smp_unetpp_plan`) and the
smp Unet: ``fused=True`` runs every block whose output H·W ≥
``packed_min_hw`` as two K1 launches (:mod:`fused_blocks`) and the head
as a third; smaller blocks stay on cuDNN. The plain and fused paths share
one ``state_dict``. In train mode with ``labels`` the fused model runs the
head as the fused head + loss kernel (:mod:`..ops.head_loss`) and returns
the loss partials instead of logits.

DeepLabV3+, MAnet and Segformer run the plain path only: their bf16 3×3
stride-1 convs at H·W ≥ 4096 (``Conv3x3``) take K6, the rest the library
conv, as in JAX. Encoders with four levels (ConvNeXt, MiT: f1 is
``None``) drop the missing level as JAX does: UNet++ plans over four
features and ends with a ×2 head, the Unet and MAnet take no skip there,
DeepLabV3+ refuses them. Every forward takes an NHWC image batch and
returns NHWC f32 logits.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.encoders import get_encoder
from mmr_tpu_torch.models.fused_blocks import (FusedConvBN, Pending, as_array,
                                               as_pending, up_lazy)
from mmr_tpu_torch.models.fused_blocks import hwio
from mmr_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvBN, Dropout,
                                         Linear, nchw, nhwc)
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

    def fused(self, inputs: list[Pending], thru: list[bool] | None = None):
        """``inputs`` in concat order: [up(x), skips...]. Returns ``(out,
        raws)``: conv1 threads the dx of the inputs flagged in ``thru`` and
        hands their raws back (:meth:`FusedConvBN.fused`)."""
        y, raws = self.conv1.fused(inputs, thru)
        return self.conv2.fused([y])[0], raws


def _up_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """×``scale`` bilinear resize (align_corners=True) of an NCHW view."""
    h, w = x.shape[-2:]
    return nchw(resize_bilinear(nhwc(x), (h * scale, w * scale),
                                align_corners=True))


class SegmentationHead(FusedConvBN):
    """3×3 conv + bias to classes, then smp's ``UpsamplingBilinear2d``
    (align_corners=True) by ``upsampling`` in the compute dtype, then f32
    (``decoders.py:45-63``): ×4 in Segformer, ×2 in UNet++ over a
    four-level encoder, else 1."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__(in_ch, num_classes, act="identity", use_bn=False,
                         use_bias=True)

    def forward(self, x, upsampling: int = 1):
        y = super().forward(x)
        if upsampling > 1:
            y = _up_bilinear(y, upsampling)
        return y.float()

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
    64, 128, 256, 512). A four-level encoder (ConvNeXt, MiT) drops its
    missing f1: the plan runs over four features, the last block ends at
    stride 2 and the head upsamples ×2 (``decoders.py:297-302, 322-325``);
    the fused path refuses such an encoder (JAX's packed decoder returns
    its logits at stride 2 there, ``decoders.py:511-530``).

    ``forward`` takes an NHWC image batch and returns NHWC f32 logits.
    ``dtype`` is the compute dtype (parameters stay f32). ``fused=True``
    (bf16 only) runs the fine-resolution nodes and the head on the fused
    K1 kernel; ``fused_frontend=True`` (needs ``fused``) also runs the
    encoder stem and b0_0 on K2. ``thread_dx`` (the default, as JAX's):
    in a differentiable train-mode forward, a surface read by several
    nodes is handed from fused consumer to fused consumer, so that each
    consumer's K3 adds the cotangent of the later ones in the kernel
    (``decoders.py:395-500``); ``False`` leaves autograd to sum them.
    ``threaded_inputs`` is the number of node inputs the last forward
    threaded. In train mode BN takes batch statistics
    and the kernels' backward runs under autograd; ``labels`` (the (B, H,
    W) class ids; fused model only) routes the head through the fused head
    + loss kernel and ``forward`` returns ``{"stats", "conf", "n_pixels",
    "logp"}`` (``packed_chain.assemble_dice_ce`` reads the first three)."""

    def __init__(self, num_classes: int,
                 encoder_name: str = "tu-mobilenetv3_small_100",
                 decoder_channels: tuple[int, ...] = (256, 128, 64, 32, 16),
                 fused: bool = False, packed_min_hw: int = 64 * 64,
                 fused_frontend: bool = False, thread_dx: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if fused_frontend and not fused:
            raise ValueError("fused_frontend requires fused=True")
        if fused and dtype != torch.bfloat16:
            raise ValueError("the fused path computes in bf16")
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.fused = fused
        self.thread_dx = thread_dx
        self.threaded_inputs = 0
        self.packed_min_hw = packed_min_hw
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        enc_ch = tuple(c for c in spec.channels if c)
        if fused and len(enc_ch) < 5:
            raise ValueError(
                f"the fused UNet++ needs a five-level encoder; {encoder_name} "
                "has no stride-2 feature (use fused=False)")
        self.encoder = spec.build(fused_frontend=fused_frontend)
        self.plan = smp_unetpp_plan(enc_ch, tuple(decoder_channels))
        for (d, l), (i, s, o) in self.plan.items():
            self.add_module(f"x_{d}_{l}", DecoderBlock(i, s, o))
        self.depth = len(enc_ch) - 1
        self.head_up = 2 ** max(0, 5 - len(enc_ch))
        self.head = SegmentationHead(self.plan[(0, self.depth)][2], num_classes)

    def _node(self, d: int, l: int) -> DecoderBlock:
        return getattr(self, f"x_{d}_{l}")

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                with_conf: bool = True):
        if labels is not None and not self.fused:
            raise ValueError("labels route the fused head + loss: fused=True only")
        x = nchw(x.to(self.dtype).contiguous())
        fr = [f for f in self.encoder(x) if f is not None][::-1]  # smp order
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
        return nhwc(self.head(dense[(0, depth)], self.head_up))

    def _fused_decoder(self, fr, depth: int, labels=None, with_conf=True):
        """Same topology; nodes at an output scale with H·W ≥
        ``packed_min_hw`` run as K1 launches over Pending inputs (lazy ×2
        upsample of the node input, skips consumed raw with their BN
        pending), the rest on cuDNN over materialized inputs.

        ``slots`` holds every surface once: an encoder feature ``("fr",
        i)`` or a node's output ``("dense", d, l)``. With ``thread_dx`` in
        a differentiable train-mode forward, the dx of multi-consumer
        surfaces is threaded (JAX's ``remaining`` count and
        ``thread_back``, ``decoders.py:395-500``): ``remaining`` counts,
        ahead of the node loops, the nodes that still read a surface; a
        fused node flags each input whose surface has later readers, its
        conv1 hands that raw back, and the slot then holds the returned
        raw, which every later reader consumes, so their summed cotangent
        reaches this node's K3 as its addend."""
        h5, w5 = fr[0].shape[-2:]
        threading = self.thread_dx and self.training and torch.is_grad_enabled()
        keys = {}
        for layer in range(depth):
            for d in range(depth - layer):
                l = d + layer
                keys[(d, l)] = ([("fr", d), ("fr", d + 1)] if layer == 0 else
                                [("dense", d, l - 1)]
                                + [("dense", i, l) for i in range(d + 1, l + 1)]
                                + [("fr", l + 1)])
        keys[(0, depth)] = [("dense", 0, depth - 1)]
        remaining = collections.Counter(k for ks in keys.values() for k in ks)
        slots = {("fr", i): f for i, f in enumerate(fr)}
        self.threaded_inputs = 0

        def run_node(d, l):
            ks = keys[(d, l)]
            x_in, *skips = (slots[k] for k in ks)
            remaining.subtract(ks)
            block = self._node(d, l)
            if (h5 << (l + 1)) * (w5 << (l + 1)) < self.packed_min_hw:
                out = block(as_array(x_in), [as_array(s) for s in skips])
            else:
                flags = [threading and remaining[k] > 0 for k in ks]
                out, raws = block.fused(
                    [up_lazy(x_in)] + [as_pending(s) for s in skips], flags)
                for k, r in zip(ks, raws):
                    if r is not None:
                        slots[k] = dataclasses.replace(as_pending(slots[k]), raw=r)
                        self.threaded_inputs += 1
            slots[("dense", d, l)] = out
            return out

        for layer in range(depth):
            for d in range(depth - layer):
                run_node(d, d + layer)
        return _fused_head(self.head, run_node(0, depth), labels, with_conf)


def _fused_head(head: SegmentationHead, top, labels, with_conf: bool):
    """The head over a fused decoder's top: one K1 launch (NHWC f32
    logits) or, with ``labels``, the fused head + loss (K5a; K5b backward)
    and its ``{"stats", "conf", "n_pixels", "logp"}``; over a plain top
    the plain head."""
    if isinstance(top, Pending):
        if labels is not None:
            logp, stats, conf = head.fused_loss(top, labels, with_conf)
            return {"stats": stats, "conf": conf,
                    "n_pixels": labels.numel(), "logp": logp}
        return head.fused([top])[0].raw.float()
    if labels is not None:
        raise ValueError("the fused head + loss needs the top block fused "
                         "(its output H·W >= packed_min_hw)")
    return nhwc(head(top))


def _encode(model: nn.Module, x: torch.Tensor) -> list[torch.Tensor]:
    """NHWC image -> the encoder's NCHW pyramid [f1 .. f5], in the model's
    compute dtype."""
    return model.encoder(nchw(x.to(model.dtype).contiguous()))


class UnetDecoderModel(nn.Module):
    """smp ``Unet`` over a pyramid encoder (``decoders.py:83-174``): five
    :class:`DecoderBlock` (×2 nearest upsample, concat the skip [f4, f3,
    f2, f1, none]; no skip where the encoder has no such level), two
    ConvBN each, and a 3×3 head.

    ``fused=True`` (bf16; JAX's ``packed=True``, ``_packed``) runs each
    block whose output H·W ≥ ``packed_min_hw`` as ``DecoderBlock.fused``:
    two K1 launches over the lazily ×2-upsampled block input and the raw
    skip (one input where there is no skip), BN + ReLU pending into the
    next launch; the blocks before the first such one stay on cuDNN. The
    head then runs as K1 in eval and, with ``labels``, as the fused head +
    loss (``forward`` returns ``{"stats", "conf", "n_pixels", "logp"}``,
    as :class:`UnetPlusPlusModel`'s). The size rule is the port's UNet++
    rule; JAX's ``choose_row_geom`` may also refuse a geometry its
    packing cannot take, which leaves that block plain there."""

    def __init__(self, num_classes: int, encoder_name: str = "resnet18",
                 decoder_channels: tuple[int, ...] = (256, 128, 64, 32, 16),
                 fused: bool = False, packed_min_hw: int = 64 * 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if fused and dtype != torch.bfloat16:
            raise ValueError("the fused path computes in bf16")
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.fused = fused
        self.packed_min_hw = packed_min_hw
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

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                with_conf: bool = True):
        if labels is not None and not self.fused:
            raise ValueError("labels route the fused head + loss: fused=True only")
        feats = _encode(self, x)
        skips = feats[:-1][::-1] + [None]
        y = feats[-1]
        h5, w5 = y.shape[-2:]
        for i in range(self.n_blocks):
            block, s = getattr(self, f"block{i}"), skips[i]
            if self.fused and (h5 << (i + 1)) * (w5 << (i + 1)) >= self.packed_min_hw:
                y, _ = block.fused([up_lazy(y)]
                                   + ([] if s is None else [as_pending(s)]))
            else:
                y = block(as_array(y), None if s is None else [s])
        if self.fused:
            return _fused_head(self.head, y, labels, with_conf)
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
        if not spec.channels[0]:
            raise ValueError(
                f"DeepLabV3+ dilates its encoder to output stride 16; "
                f"{encoder_name} takes no output_stride (nor in JAX)")
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
    :class:`DecoderBlock` where none does (the tail; f1 of a four-level
    encoder), a 3×3 head."""

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
        skip_ch = list(enc[:-1][::-1]) + [0]
        in_ch = [enc[-1]] + list(decoder_channels[:-1])
        for i, ch in enumerate(decoder_channels):
            block = (MFAB(in_ch[i], skip_ch[i], ch) if skip_ch[i]
                     else DecoderBlock(in_ch[i], 0, ch))
            self.add_module(f"block{i}", block)
        self.n_blocks = len(decoder_channels)
        self.head = SegmentationHead(decoder_channels[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = _encode(self, x)
        skips = feats[:-1][::-1] + [None]
        y = self.center(feats[-1])
        for i in range(self.n_blocks):
            block = getattr(self, f"block{i}")
            y = block(y, skips[i]) if skips[i] is not None else block(y)
        return nhwc(self.head(y))


class SegformerModel(nn.Module):
    """smp ``Segformer`` (``decoders.py:533-564``): the last four pyramid
    levels each projected by a Dense (``linear_c{i}``) to ``embed_dim``,
    bilinearly resized (align_corners=False) to the stride-4 level,
    concatenated deepest first, fused by a 1×1 ConvBN + ReLU (``fuse``),
    then the 3×3 head (K6a at bf16 when the stride-4 map has H·W ≥ 4096,
    K6a dx and K6b backward) and its ×4 bilinear (align_corners=True)."""

    def __init__(self, num_classes: int, encoder_name: str = "mit_b2",
                 embed_dim: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.encoder_name = encoder_name
        self.dtype = dtype
        spec = get_encoder(encoder_name)
        self.encoder = spec.build()
        chans = [c for c in spec.channels if c][-4:]
        for i, c in enumerate(chans):
            self.add_module(f"linear_c{i + 1}", Linear(c, embed_dim))
        self.n_levels = len(chans)
        self.fuse = ConvBN(embed_dim * len(chans), embed_dim, kernel=1, padding=0)
        self.head = SegmentationHead(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [f for f in _encode(self, x) if f is not None][-4:]
        target = tuple(feats[0].shape[-2:])
        proj = []
        for i, f in enumerate(feats):
            y = getattr(self, f"linear_c{i + 1}")(nhwc(f))
            if tuple(y.shape[1:3]) != target:
                y = resize_bilinear(y, target)
            proj.append(y)
        y = self.fuse(nchw(torch.cat(proj[::-1], -1)))
        return nhwc(self.head(y, x.shape[1] // y.shape[2]))
