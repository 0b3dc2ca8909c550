"""Padding math (counterpart of ``mmr_tpu/ops/padcrop.py::pad_to``; the
Zarr crop helpers wait for the host data path)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to(x: torch.Tensor, target_hw: tuple[int, int],
           value: float = 0.0) -> torch.Tensor:
    """Pad the NHWC spatial dims of ``x`` up to ``target_hw``: diff // 2 on
    the leading side, the rest trailing (the UNet skip alignment of
    ``unet_parts.py:325-330``)."""
    h, w = x.shape[-3], x.shape[-2]
    dh, dw = target_hw[0] - h, target_hw[1] - w
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2),
                 value=value)
