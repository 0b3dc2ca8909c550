"""Fused-kernel MobileNetV3 front-end (counterpart of
``mmr_tpu/models/packed_encoder.py``).

- **stem**: one K2 launch (dense 3×3/2, 3→16) reading the image once and
  writing the raw stride-2 feature once; its BN + hardswish travel as a
  pending prologue.
- **b0_0**: one K2 depthwise launch that reads the stem output raw and
  applies the stem's BN + hardswish as its prologue (the activated stem
  tensor never exists in device memory); then BN + relu, SE and the 1×1
  pointwise conv in torch. The pointwise output stays raw with b0_0's
  second BN pending (act linear).
- **b1_0, b1_1** (``fused_b1``; :class:`FusedIRBlock`, ``PackedIRBlock``):
  expand 1×1 as an f32 product of bf16 operands with the input's pending
  linear BN folded into the matrix; the depthwise 3×3 on the depthwise
  tile with BN1 + relu as its prologue — b1_0 (stride 2, C = 72) on K2 / K4
  with dx, b1_1 (stride 1, C = 88) on the depthwise mode of K1 / K3; the
  project 1×1 on the relu-applied core, BN3 pending; b1_1's residual adds
  both affines in one pass and leaves f3 a plain tensor.

In train mode the K2 launches and the depthwise convs emit their BN
moments and run through their differentiable wrappers (K4 / K3 backward;
the stem's image needs no dx), the BNs take batch statistics, and the 1×1
convs run as f32 products of bf16 operands whose output moments give
their BNs (``packed_encoder.py::packed_stem``, ``PackedDSBlock``,
``PackedIRBlock``).

The parameters are those of the plain encoder modules (``conv_stem``,
``bn1``, ``b0_0``, ``b1_0``, ``b1_1``); the diagonal-expanded depthwise
weights and the block-diagonal lane GEMMs of the TPU version are layout
artifacts and are not ported: the depthwise convs stay per channel (the
TPU's b1_1 did 88× the MACs on its dense taps, why it measured slower
there), and the 1×1 convs are plain products.
"""

from __future__ import annotations

import torch

from mmr_tpu_torch.models.encoders.mobilenetv3 import (_ACT, DepthwiseSeparable,
                                                      InvertedResidual)
from mmr_tpu_torch.models.fused_blocks import Pending, hwio
from mmr_tpu_torch.models.layers import hard_sigmoid, nchw, nhwc
from mmr_tpu_torch.ops.fused_conv import (activated, apply_act, fused_conv,
                                          fused_conv_ad,
                                          fused_conv_down, fused_conv_down_ad,
                                          moments)


def _pixels(y: torch.Tensor) -> int:
    return y.shape[0] * y.shape[1] * y.shape[2]


def fused_stem(encoder, x: torch.Tensor) -> Pending:
    """3×3/2 conv 3→16 as one K2 launch; ``encoder.bn1`` + hardswish
    pending. ``x``: NCHW (channels_last) image."""
    raw = nhwc(x).to(torch.bfloat16).contiguous()
    w = hwio(encoder.conv_stem.weight)
    if encoder.training:
        y, mom = fused_conv_down_ad(Pending(raw), w, emit_moments=True)
        s, t = encoder.bn1.batch_affine(mom, _pixels(y))
    else:
        y = fused_conv_down(Pending(raw), w)
        s, t = encoder.bn1.affine()
    return Pending(y, s.contiguous(), t.contiguous(), "hswish")


class FusedDSBlock(DepthwiseSeparable):
    """``DepthwiseSeparable`` (b0_0) with a fused execution, :meth:`fused`."""

    def fused(self, f1: Pending) -> Pending:
        if self.residual:
            raise NotImplementedError("fused b0_0 is the stride-2 block")
        if self.training:
            return self._fused_train(f1)
        y = fused_conv_down(f1, hwio(self.conv_dw.weight), depthwise=True)
        s1, t1 = self.bn1.affine()
        a = self._gated(y, s1, t1)
        out = self.conv_pw(nchw(a.to(torch.bfloat16)))       # bf16
        s2, t2 = self.bn2.affine()
        return Pending(nhwc(out).contiguous(), s2.contiguous(),
                       t2.contiguous(), "linear")

    def _gated(self, y, s1, t1) -> torch.Tensor:
        """act(BN1(y)) (NHWC f32) times the SE gate."""
        a = _ACT[self.act](y.float() * s1 + t1)
        if self.se is not None:
            pooled = a.mean(dim=(1, 2))[:, :, None, None]   # (B, C, 1, 1)
            s = self.se.excite(pooled.to(torch.bfloat16))
            a = a * nhwc(hard_sigmoid(s.float()))
        return a

    def _fused_train(self, f1: Pending) -> Pending:
        y, mom = fused_conv_down_ad(f1, hwio(self.conv_dw.weight),
                                    depthwise=True, emit_moments=True)
        s1, t1 = self.bn1.batch_affine(mom, _pixels(y))
        a = self._gated(y, s1, t1)
        w = self.conv_pw.weight[:, :, 0, 0].to(torch.bfloat16).float()
        out = a.to(torch.bfloat16).float() @ w.t()          # NHWC f32
        s2, t2 = self.bn2.batch_affine(moments(out), _pixels(out))
        return Pending(out.to(torch.bfloat16).contiguous(), s2.contiguous(),
                       t2.contiguous(), "linear")


def _bn(bn, y: torch.Tensor, training: bool):
    """(s, t) of ``bn``: batch statistics from the f32 NHWC ``y``'s
    moments in train mode, the running ones in eval mode."""
    return bn.batch_affine(moments(y), _pixels(y)) if training else bn.affine()


class FusedIRBlock(InvertedResidual):
    """``InvertedResidual`` of the b1 flavour (expand 1×1, depthwise 3×3,
    project 1×1; relu, no SE) with a fused execution, :meth:`fused`:
    ``packed_encoder.py::PackedIRBlock`` (``:169-302``) without its lane
    packing. The parameter tree is the plain block's."""

    def fused(self, x: Pending) -> Pending:
        """``x``: the block input, raw NHWC bf16 with its BN pending. Returns
        the raw output with BN3 pending (act linear) or, with the residual
        (stride 1, cin = cout), the final sum with no prologue."""
        if (self.conv_pw is None or self.se is not None or self.act != "relu"
                or self.conv_dw.kernel_size != (3, 3)):
            raise NotImplementedError(
                "the fused IR block is the b1 flavour: expand, 3x3 depthwise, "
                "project, relu, no SE")
        train, bf16 = self.training, torch.bfloat16
        w1 = self.conv_pw.weight[:, :, 0, 0].t().float()   # (cin, exp)
        if x.scale is None or x.act == "linear":
            # (s·x + t)·W = x·(diag(s)·W) + t·W: the pending BN folded in
            core, bias = x.raw, None
            if x.scale is not None:
                bias = x.shift @ w1
                w1 = x.scale[:, None] * w1
        else:
            core, bias = activated(x).to(bf16), None
        e = core.float() @ w1.to(bf16).float()           # NHWC f32
        if bias is not None:
            e = e + bias
        s1, t1 = _bn(self.bn1, e, train)
        pe = Pending(e.to(bf16).contiguous(), s1.contiguous(), t1.contiguous(),
                     "relu")
        wdw = hwio(self.conv_dw.weight)                     # (3, 3, 1, C)
        down = self.conv_dw.stride == (2, 2)
        if train:
            if down:
                y, mom2 = fused_conv_down_ad(pe, wdw, depthwise=True,
                                             emit_moments=True)
            else:
                (y, mom2), _ = fused_conv_ad([pe], [wdw], emit_moments=True,
                                             depthwise=True)
            s2, t2 = self.bn2.batch_affine(mom2, _pixels(y))
        else:
            y = (fused_conv_down(pe, wdw, depthwise=True) if down else
                 fused_conv([pe], [wdw], depthwise=True))
            s2, t2 = self.bn2.affine()
        a = torch.clamp_min(y.float() * s2 + t2, 0.0).to(bf16)
        w3 = self.conv_pwl.weight[:, :, 0, 0].t().to(bf16).float()
        out = a.float() @ w3                                 # NHWC f32
        s3, t3 = _bn(self.bn3, out, train)
        if not self.residual:
            return Pending(out.to(bf16).contiguous(), s3.contiguous(),
                           t3.contiguous(), "linear")
        # the sum of two affines has no raw + prologue form: both applied
        # in one pass, the result final
        short = x.raw.float()
        if x.scale is not None:
            short = apply_act(short * x.scale + x.shift, x.act)
        return Pending((out * s3 + t3 + short).to(bf16).contiguous())
