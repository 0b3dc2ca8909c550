"""Resampling ops (NHWC). Only the ×2 nearest upsample of the UNet decoders
is ported; the bilinear resizes of ``mmr_tpu/ops/resize.py`` wait for the
models that use them (ROADMAP)."""

from __future__ import annotations

import torch


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """×2 nearest spatial upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
