"""Classic U-Net, the Path-A hand-written model (counterpart of
``mmr_tpu/models/unet.py``): 4 down / 4 up, 64 → 1024 channels (``factor``
2 halves the deep ones when ``bilinear``), DoubleConv = (ConvBN 3×3) ×2,
Down = max-pool 2 + DoubleConv, Up = ×2 upsample → pad to the skip (odd
sizes) → concat [skip, up] → DoubleConv, a 1×1 head.

Quirk kept: the "bilinear" branch upsamples with ``mode="nearest"``
(``upsample_mode``, ``unet.py:41-83``) and its DoubleConv's middle width
is in // 2; ``bilinear=False`` upsamples with a ConvTranspose2d(k=2, s=2)
named ``{up}_upconv``. Every ConvBN 3×3 is a ``Conv3x3``: in bf16 at
H·W ≥ 4096 it runs K6, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.layers import Conv2d, ConvBN, ConvTranspose2d, nchw, nhwc
from mmr_tpu_torch.ops.padcrop import pad_to
from mmr_tpu_torch.ops.resize import upsample2x


class DoubleConv(nn.Module):
    def __init__(self, cin: int, out_ch: int, mid_ch: int | None = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.conv1 = ConvBN(cin, mid)
        self.conv2 = ConvBN(mid, out_ch)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UNet(nn.Module):
    """Takes an NHWC image batch, returns NHWC f32 logits."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 bilinear: bool = True, upsample_mode: str = "nearest",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.bilinear = bilinear
        self.upsample_mode = upsample_mode
        self.dtype = dtype
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(in_channels, 64)
        downs = (64, 128, 256, 512, 1024 // factor)
        for i in range(1, 5):
            self.add_module(f"down{i}", DoubleConv(downs[i - 1], downs[i]))
        ch = downs[-1]
        for i, (skip, out) in enumerate(zip((512, 256, 128, 64),
                                            (512 // factor, 256 // factor,
                                             128 // factor, 64)), start=1):
            if bilinear:
                self.add_module(f"up{i}_conv",
                                DoubleConv(ch + skip, out, (ch + skip) // 2))
            else:
                self.add_module(f"up{i}_upconv", ConvTranspose2d(ch, ch // 2, 2, 2))
                self.add_module(f"up{i}_conv", DoubleConv(ch // 2 + skip, out))
            ch = out
        self.outc = Conv2d(64, num_classes, 1)

    def _up(self, i: int, y, skip):
        if self.bilinear:
            y = nchw(upsample2x(nhwc(y), self.upsample_mode))
        else:
            y = getattr(self, f"up{i}_upconv")(y)
        y = nchw(pad_to(nhwc(y), tuple(skip.shape[2:])))
        return getattr(self, f"up{i}_conv")(torch.cat([skip, y], 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = [self.inc(nchw(x.to(self.dtype).contiguous()))]
        for i in range(1, 5):
            xs.append(getattr(self, f"down{i}")(F.max_pool2d(xs[-1], 2, 2)))
        y = xs[-1]
        for i in range(1, 5):
            y = self._up(i, y, xs[4 - i])
        return nhwc(self.outc(y).float())
