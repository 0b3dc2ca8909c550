"""Shared building blocks (PyTorch counterparts of ``mmr_tpu/models/layers.py``).

Conventions:
- Modules take and return NCHW tensors in ``torch.channels_last`` memory
  (the bytes of NHWC); :func:`nchw` / :func:`nhwc` switch between the two
  views without a copy.
- Parameters are f32; a conv casts them to its input's dtype, so the model's
  compute dtype (bf16 by default) is the dtype of the tensors it is fed
  (flax ``nn.Conv(dtype=...)`` semantics).
- BatchNorm follows flax (``mmr_tpu/models/layers.py::FusedBatchNorm``):
  train mode normalizes with the batch's f32 statistics and updates the
  running statistics with flax momentum 0.9 (torch's 0.1); eval mode folds
  the running statistics. A bf16 input takes them from one pass of Σx and
  Σx² (biased variance ``max(E[x²] − E[x]², 0)``, as the kernels' moments
  give them) and is normalized by one per-channel affine; an f32 input
  takes the variance in two passes, ``mean((x − mean)²)``, and is
  normalized centred. ``F.batch_norm`` is not used: it stores the unbiased
  variance. While a step runs on a multi-rank mesh
  (:mod:`mmr_tpu_torch.core.mesh`), train-mode statistics are those of the
  global batch: the moments (and the f32 path's two sums) are summed over
  the ranks, as JAX's ``FusedBatchNorm`` ``psum``s them under
  ``shard_map`` and GSPMD reduces them over the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.core.mesh import active_mesh, all_reduce_moments, all_reduce_sum
from mmr_tpu_torch.ops import conv3x3_packed as k6


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


class Linear(nn.Linear):
    """flax ``nn.Dense`` over the last axis: the f32 parameters cast to the
    input's dtype, the product rounded to it, then the bias added in it
    (flax adds the cast bias to the rounded product)."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (``normalization.py::
    _compute_stats`` and ``_normalize``, flax 0.12): mean and the fast
    variance ``max(E[x²] − E[x]², 0)`` in f32, then ``(x − mean) ·
    (rsqrt(var + eps) · scale) + bias`` in f32, rounded once to the
    input's dtype. ``F.layer_norm`` takes the centred variance instead."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Conv3x3(Conv2d):
    """3×3 stride-1 SAME conv (JAX ``Conv3x3``) with ``nn.Conv2d``'s
    parameters. A bf16 conv runs through
    :func:`~mmr_tpu_torch.ops.conv3x3_packed.conv3x3p_bias_act` when its
    forward or its backward takes the standalone kernels (K6a forward; K6a
    dx and K6b dW backward), each direction as the per-shape table says
    (``conv3x3_packed.conv3x3_layer``), as JAX's ``conv3x3p_bias_act``
    dispatches to its Pallas kernel; a conv that takes them in neither
    direction, and every f32 conv, stays on the library conv. The
    flagship's fused nodes never reach this module."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 3, 1, 1, bias=bias)

    def forward(self, x):
        return nchw(k6.conv3x3_layer(nhwc(x), self.weight, self.bias))


# flax convention: running = MOMENTUM·running + (1 − MOMENTUM)·batch
# (torch's momentum 0.1). Every BN of the reference models uses it: JAX's
# ConvBN / ConvTransposeBN / SegNet expose ``bn_momentum`` but no entry
# point sets it from its default 0.1 (``layers.py:78,109``, ``segnet.py:29``)
MOMENTUM = 0.9


def moments_to_stats(mom: torch.Tensor, count: int):
    """(2, C) [Σx, Σx²] over ``count`` values per channel -> (mean, biased
    var), flax ``nn.BatchNorm`` semantics
    (``packed_chain.py::moments_to_stats``)."""
    mean = mom[0] / count
    return mean, torch.clamp_min(mom[1] / count - mean * mean, 0.0)


class FusedBatchNorm(nn.Module):
    """BatchNorm as one per-channel affine ``x·s + t`` in the input's dtype,
    ``s = γ·rsqrt(var + eps)``, ``t = β − mean·s`` (f32): batch statistics
    in train mode (:meth:`batch_affine`), running statistics in eval mode
    (:meth:`affine`). An f32 input is normalized centred, ``(x − mean)·s
    + β``: the same affine without the cancellation of ``x·s`` against
    ``mean·s`` (see :class:`BatchNorm`), which moved the f32 gradient of a
    Path-A UNet step, whose first ConvBN sees raw [0, 1] images, 1.1 %
    (relative L2) from a float64 run against 0.6 % for this form (CPU
    measurement). State-dict keys: ``weight``, ``bias``, ``running_mean``,
    ``running_var`` (biased, as flax keeps it)."""

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

    def batch_affine(self, mom: torch.Tensor, count: int):
        """(s, t) from the batch moments ``mom`` (2, C) f32 over ``count``
        values per channel (gradients flow into ``mom``); updates the
        running statistics in place (``packed_blocks.py::DeferredBN``).
        On a multi-rank mesh the moments and the count are the global
        batch's (``layers.py:149-156``)."""
        mom, count = all_reduce_moments(mom, count)
        mean, var = moments_to_stats(mom, count)
        self._update_running(mean, var)
        s = self.weight * torch.rsqrt(var + self.eps)
        return s, self.bias - mean * s

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
        self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)

    @staticmethod
    def _moments(x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])

    def forward(self, x):
        if x.dtype == torch.float32:
            return self._centred(x)
        if self.training:
            s, t = self.batch_affine(self._moments(x), x.numel() // x.shape[1])
        else:
            s, t = self.affine()
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]

    def _centred(self, x):
        """``((x − mean)·s + β)`` in f32, rounded to x's dtype. In train
        mode the variance is two-pass, ``mean((x − mean)²)``: E[x²] − E[x]²
        put the f32 step-1 gradient of a UNet++/ResNet-18 case 3.7e-3 from
        float64 (relative L2), the two-pass form 7.2e-6 (CPU measurement).
        On a multi-rank mesh each pass's sums are summed over the ranks: the
        global mean before the centred sum."""
        if self.training:
            xf = x.float()
            mesh = active_mesh()
            if mesh is None:
                mean = xf.mean((0, 2, 3))
                var = (xf - mean[:, None, None]).square().mean((0, 2, 3))
            else:
                n = xf.numel() // xf.shape[1] * mesh.size
                mean = all_reduce_sum(xf.sum((0, 2, 3)), mesh) / n
                var = all_reduce_sum((xf - mean[:, None, None]).square()
                                     .sum((0, 2, 3)), mesh) / n
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        s = self.weight * torch.rsqrt(var + self.eps)
        y = (x.float() - mean[:, None, None]) * s[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class BatchNorm(FusedBatchNorm):
    """flax ``nn.BatchNorm``, which the JAX ResNet encoder uses: the
    parameters, statistics and momentum of :class:`FusedBatchNorm`, but the
    normalization centred and in f32, ``((x − mean)·s + β)`` rounded to the
    input's dtype, as flax computes it. The one-affine form ``x·s + t``
    cancels ``x·s`` against ``mean·s`` when a channel's mean is large
    against its spread, as after the ResNet's residual sums: there it moved
    the f32 gradient of a UNet++/ResNet-18 step 1.1 % (relative L2) from a
    float64 run, against 0.4 % for this form (CPU measurement)."""

    def forward(self, x):
        return self._centred(x)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation (``conv`` / ``bn`` submodules;
    ``layers.py::ConvBN``). A 3×3 stride-1 padding-1 ungrouped conv is a
    :class:`Conv3x3`; any other kernel, stride, padding or grouping a
    library conv."""

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


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose f32 parameters are cast to the input's
    dtype. Its (in, out, kh, kw) weight is flax ``ConvTranspose``'s (kh,
    kw, in, out) kernel flipped in both spatial axes
    (:mod:`~mmr_tpu_torch.models.convert`): flax pads the dilated input by
    q = k − 1 − p and correlates with the kernel as it is, torch convolves."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTransposeBN(nn.Module):
    """Bias-free ConvTranspose2d(k, stride, padding) + BN + activation, the
    SegNet decoder unit (``layers.py::ConvTransposeBN``); output size
    (H − 1)·s − 2p + k as torch's."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, act: str = "relu"):
        super().__init__()
        self.conv = ConvTranspose2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = FusedBatchNorm(cout)
        self.act = act

    def forward(self, x):
        return ACTIVATIONS[self.act](self.bn(self.conv(x)))


class Dropout(nn.Module):
    """Inverted dropout in train mode, identity in eval mode (flax
    ``nn.Dropout``: ``where(keep, x / (1 − rate), 0)``). The keep-mask is
    fed (:attr:`keep`, a bool tensor of :meth:`mask_shape`) or drawn from
    :attr:`generator`; the train step sets the generator
    (:func:`set_dropout`). In train mode with neither, it raises. With
    :attr:`rows` = (rank, ranks) the mask is drawn for the global batch of
    ``ranks`` equal shards and this rank's rows are kept (GSPMD's draws)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        self.keep: torch.Tensor | None = None
        self.rows: tuple[int, int] | None = None

    def mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape)

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        if self.keep is not None:
            return self.keep.to(x.device)
        if self.generator is None:
            raise ValueError("dropout in train mode needs a generator or a "
                             "fed keep-mask")
        shape = self.mask_shape(x)
        rank, ranks = self.rows or (0, 1)
        u = torch.rand((shape[0] * ranks,) + shape[1:], generator=self.generator,
                       device=self.generator.device)[rank * shape[0]:(rank + 1) * shape[0]]
        return (u < 1.0 - self.rate).to(x.device)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.rate),
                           torch.zeros_like(x))


class Dropout2d(Dropout):
    """Channel-wise dropout (torch ``nn.Dropout2d``; ``layers.py::
    Dropout2d``): one keep draw per (sample, channel), mask (B, C, 1, 1)
    over the NCHW view, ``x · keep / (1 − rate)``."""

    def mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return (x.shape[0], x.shape[1], 1, 1)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return x * self.keep_mask(x).to(x.dtype) / (1.0 - self.rate)


def dropouts(model: nn.Module) -> list[Dropout]:
    """The model's dropout modules with a nonzero rate."""
    return [m for m in model.modules()
            if isinstance(m, Dropout) and m.rate > 0.0]


def set_dropout(model: nn.Module, generator: torch.Generator | None,
                rows: tuple[int, int] | None = None):
    """Let every dropout of ``model`` draw its masks from ``generator``
    (``rows``: see :class:`Dropout`)."""
    for m in dropouts(model):
        m.generator, m.rows = generator, rows


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
