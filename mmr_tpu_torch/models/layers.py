"""Shared building blocks (PyTorch counterparts of ``mmr_tpu/models/layers.py``).

Conventions:
- Modules take and return NCHW tensors in ``torch.channels_last`` memory
  (the bytes of NHWC); :func:`nchw` / :func:`nhwc` switch between the two
  views without a copy.
- Parameters are f32; a conv casts them to its input's dtype, so the model's
  compute dtype (bf16 by default) is the dtype of the tensors it is fed
  (flax ``nn.Conv(dtype=...)`` semantics).
- BatchNorm runs in eval mode only in this slice: the running statistics
  are folded to one per-channel affine. Batch statistics (training) come
  with the train slice (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC view -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW view -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


ACTIVATIONS = {
    "relu": F.relu,
    "hardswish": hard_swish,
    "identity": lambda x: x,
}

# ConvBN activation name -> prologue act code of the fused kernels
PROLOGUE_ACT = {"relu": "relu", "hardswish": "hswish", "identity": "linear"}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


class Conv3x3(Conv2d):
    """3×3 stride-1 SAME conv (JAX ``Conv3x3``). On the serving path the JAX
    op dispatches to ``lax.conv`` (only x_0_0 at 32×40 uses it), so this is
    a plain conv; the standalone TPU kernel behind it (K6) is not ported."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 3, 1, 1, bias=bias)


class FusedBatchNorm(nn.Module):
    """Eval-mode BatchNorm with the running statistics folded to
    ``s = γ·rsqrt(var + eps)``, ``t = β − mean·s`` (f32), applied as
    ``x·s + t`` in the input's dtype. State-dict keys: ``weight``, ``bias``,
    ``running_mean``, ``running_var``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm batch statistics (training) are not ported yet; "
                "call .eval()")
        s, t = self.affine()
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation (``conv`` / ``bn`` submodules)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, groups: int = 1, act: str = "relu",
                 use_bn: bool = True, use_bias: bool = False):
        super().__init__()
        bias = use_bias or not use_bn
        if (kernel, stride, padding, groups) == (3, 1, 1, 1):
            self.conv = Conv3x3(cin, cout, bias)
        else:
            self.conv = Conv2d(cin, cout, kernel, stride, padding,
                               groups=groups, bias=bias)
        self.bn = FusedBatchNorm(cout) if use_bn else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return ACTIVATIONS[self.act](x)


class SqueezeExcite(nn.Module):
    """MobileNetV3 SE: global average pool -> 1×1 reduce -> relu -> 1×1
    expand -> hard-sigmoid gate."""

    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv2d(c, reduced, 1)
        self.conv_expand = Conv2d(reduced, c, 1)

    def excite(self, pooled: torch.Tensor) -> torch.Tensor:
        """(B, C, 1, 1) pooled features -> (B, C, 1, 1) pre-gate logits."""
        return self.conv_expand(F.relu(self.conv_reduce(pooled)))

    def forward(self, x):
        return x * hard_sigmoid(self.excite(x.mean(dim=(2, 3), keepdim=True)))
