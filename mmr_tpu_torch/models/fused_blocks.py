"""Fused-kernel decoder building blocks (counterpart of
``mmr_tpu/models/packed_blocks.py``).

Conv outputs are kept raw (pre-BN) as :class:`Pending` tensors; their BN +
activation travel as per-channel ``(scale, shift, act)`` and are applied in
the consuming kernel's prologue, and a node's concat never materializes
(one multi-input K1 launch). Parameters are those of the plain modules
(:class:`FusedConvBN` *is* a ``ConvBN``), so the plain and fused paths share
one ``state_dict``.
"""

from __future__ import annotations

import dataclasses

import torch

from mmr_tpu_torch.models.layers import PROLOGUE_ACT, ConvBN, nchw, nhwc
from mmr_tpu_torch.ops.fused_conv import Pending, apply_act, fused_conv
from mmr_tpu_torch.ops.resize import upsample2x

__all__ = ["Pending", "FusedConvBN", "as_array", "as_pending", "up_lazy",
           "hwio"]


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> HWIO view (the JAX kernel layout)."""
    return w.permute(2, 3, 1, 0)


def as_array(v) -> torch.Tensor:
    """Pending -> NCHW (channels_last) tensor with the prologue applied in
    the raw dtype and the pending ×2 upsample materialized (``PackedT
    .unpack``); a plain NCHW tensor passes through."""
    if not isinstance(v, Pending):
        return v
    x = v.raw
    if v.scale is not None:
        x = apply_act(x * v.scale.to(x.dtype) + v.shift.to(x.dtype), v.act)
    if v.up2x:
        x = upsample2x(x)
    return nchw(x)


def as_pending(v) -> Pending:
    """Deliver ``v`` as a kernel input: Pendings pass, NCHW tensors wrap."""
    if isinstance(v, Pending):
        return v
    return Pending(nhwc(v).contiguous())


def up_lazy(v) -> Pending:
    """The ×2-nearest upsample of ``v`` as a lazy Pending (the prologue
    commutes with nearest upsampling; nothing is materialized)."""
    p = as_pending(v)
    if p.up2x:
        raise ValueError("a lazily upsampled tensor cannot be upsampled again")
    return dataclasses.replace(p, up2x=True)


class FusedConvBN(ConvBN):
    """A 3×3 stride-1 ``ConvBN`` that can also run fused: :meth:`fused`
    convolves the concat of Pending inputs in one K1 launch and returns the
    raw output with this module's eval BN + activation pending
    (``use_bn=False``: with the conv bias, no prologue)."""

    def fused(self, inputs: list[Pending]) -> Pending:
        w = hwio(self.conv.weight)
        parts = list(torch.split(w, [p.c for p in inputs], dim=2))
        y = fused_conv(inputs, parts, self.conv.bias)
        if self.bn is None:
            return Pending(y)
        s, t = self.bn.affine()
        return Pending(y, s.contiguous(), t.contiguous(),
                       PROLOGUE_ACT[self.act])
