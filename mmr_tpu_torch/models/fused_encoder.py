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

The parameters are those of the plain encoder modules (``conv_stem``,
``bn1``, ``b0_0``); the diagonal-expanded depthwise weights and the
block-diagonal lane GEMMs of the TPU version are layout artifacts and are
not ported.
"""

from __future__ import annotations

import torch

from mmr_tpu_torch.models.encoders.mobilenetv3 import _ACT, DepthwiseSeparable
from mmr_tpu_torch.models.fused_blocks import Pending, hwio
from mmr_tpu_torch.models.layers import hard_sigmoid, nchw, nhwc
from mmr_tpu_torch.ops.fused_conv import fused_conv_down


def fused_stem(encoder, x: torch.Tensor) -> Pending:
    """3×3/2 conv 3→16 as one K2 launch; ``encoder.bn1`` + hardswish
    pending. ``x``: NCHW (channels_last) image."""
    raw = nhwc(x).to(torch.bfloat16).contiguous()
    y = fused_conv_down(Pending(raw), hwio(encoder.conv_stem.weight))
    s, t = encoder.bn1.affine()
    return Pending(y, s.contiguous(), t.contiguous(), "hswish")


class FusedDSBlock(DepthwiseSeparable):
    """``DepthwiseSeparable`` (b0_0) with a fused execution, :meth:`fused`."""

    def fused(self, f1: Pending) -> Pending:
        if self.residual:
            raise NotImplementedError("fused b0_0 is the stride-2 block")
        y = fused_conv_down(f1, hwio(self.conv_dw.weight), depthwise=True)
        s1, t1 = self.bn1.affine()
        a = _ACT[self.act](y.float() * s1 + t1)             # NHWC f32
        if self.se is not None:
            pooled = a.mean(dim=(1, 2))[:, :, None, None]   # (B, C, 1, 1)
            s = self.se.excite(pooled.to(torch.bfloat16))
            a = a * nhwc(hard_sigmoid(s.float()))
        out = self.conv_pw(nchw(a.to(torch.bfloat16)))       # bf16
        s2, t2 = self.bn2.affine()
        return Pending(nhwc(out).contiguous(), s2.contiguous(),
                       t2.contiguous(), "linear")
