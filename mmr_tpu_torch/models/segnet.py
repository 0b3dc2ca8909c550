"""SegNet-style strided encoder / decoder without skips, the Path-A
``segnet`` (counterpart of ``mmr_tpu/models/segnet.py``): five ConvBN
encoders (4×4 stride 2 padding 1, 3 → 64 → 128 → 256 → 512, then 4×4
stride 1 padding 0 to 1024), a mirrored stack of ConvTransposeBN decoders
(1024 → 512 k4 s1 p0, then 512 → 256 → 128 → 64 → classes k4 s2 p1) with
Dropout2d after the first three. The reference's softmax on the output is
kept behind ``apply_softmax`` (True here, False from the factory, as JAX's
``factory.py:56``). Every conv is a library conv: none is 3×3 stride 1.
"""

from __future__ import annotations

import torch
from torch import nn

from mmr_tpu_torch.models.layers import ConvBN, ConvTransposeBN, Dropout2d, nchw, nhwc

# channel dropout after the first three decoders; JAX's ``drop_rate``
# default, which no entry point changes (``segnet.py:30``)
DROP = 0.5


class SegNet(nn.Module):
    """Takes an NHWC image batch, returns NHWC f32 logits (probabilities
    with ``apply_softmax``)."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 apply_softmax: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.apply_softmax = apply_softmax
        self.dtype = dtype
        enc = ((in_channels, 64, 2, 1), (64, 128, 2, 1), (128, 256, 2, 1),
               (256, 512, 2, 1), (512, 1024, 1, 0))
        for i, (cin, cout, s, p) in enumerate(enc, start=1):
            self.add_module(f"enc{i}", ConvBN(cin, cout, 4, s, p))
        dec = ((1024, 512, 1, 0), (512, 256, 2, 1), (256, 128, 2, 1),
               (128, 64, 2, 1), (64, num_classes, 2, 1))
        for i, (cin, cout, s, p) in enumerate(dec, start=1):
            self.add_module(f"dec{i}", ConvTransposeBN(
                cin, cout, 4, s, p, act="identity" if i == 5 else "relu"))
            if i <= 3:
                self.add_module(f"drop{i}", Dropout2d(DROP))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x.to(self.dtype).contiguous())
        for i in range(1, 6):
            x = getattr(self, f"enc{i}")(x)
        for i in range(1, 6):
            x = getattr(self, f"dec{i}")(x)
            if i <= 3:
                x = getattr(self, f"drop{i}")(x)
        x = x.float()
        if self.apply_softmax:
            x = torch.softmax(x, 1)
        return nhwc(x)
