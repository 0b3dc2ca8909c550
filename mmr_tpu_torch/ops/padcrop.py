"""Padding and cropping math (counterpart of ``mmr_tpu/ops/padcrop.py``):

- :func:`pad_to`, the UNet skip-alignment pad for odd sizes
  (``unet_parts.py:308-338``), on the device;
- :func:`window_slices`, :func:`assemble_window` and
  :func:`center_pad_bbox_crop`, the host-side Zarr bbox crop with
  out-of-bounds padding (``Pre_Process.py:466-535`` ``crop_from_zarr``),
  in numpy.
"""

from __future__ import annotations

import numpy as np
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


def window_slices(bbox_lo, patch, spatial):
    """The in-bounds source slices and the leading pad widths of a
    :func:`center_pad_bbox_crop` window at ``bbox_lo`` of size ``patch``
    over an array of spatial shape ``spatial``."""
    src, before = [], []
    for lo, p, s in zip(bbox_lo, patch, spatial):
        lo = int(lo)
        lo_c = min(max(lo, 0), s)
        hi_c = min(max(lo + p, 0), s)
        src.append(slice(lo_c, hi_c))
        before.append(max(0, lo_c - lo))
    return tuple(src), before


def assemble_window(cropped: np.ndarray, before, patch, n_lead: int,
                    pad_value=0.0) -> np.ndarray:
    """Pad the in-bounds crop (``n_lead`` leading dims passed through) out
    to ``patch``, ``before[i]`` values ahead on spatial dim ``i``."""
    pads = [(0, 0)] * n_lead + [
        (b, p - b - cropped.shape[n_lead + i])
        for i, (b, p) in enumerate(zip(before, patch))
    ]
    if any(pw != (0, 0) for pw in pads):
        cropped = np.pad(cropped, pads, constant_values=pad_value)
    return cropped


def center_pad_bbox_crop(arr, bbox_lo, patch, pad_value=0.0) -> np.ndarray:
    """Crop ``arr[..., *spatial]`` from ``bbox_lo`` with size ``patch``,
    padding with ``pad_value`` outside the array; leading (channel) dims
    pass through. Only the in-bounds window is read from ``arr`` (an
    ndarray or a :class:`~mmr_tpu_torch.data.zarr_io.ZarrArray`)."""
    patch = tuple(int(p) for p in patch)
    n_lead = len(arr.shape) - len(patch)
    spatial = arr.shape[n_lead:]
    src, before = window_slices(bbox_lo, patch, spatial)
    cropped = np.asarray(arr[(slice(None),) * n_lead + src])
    return assemble_window(cropped, before, patch, n_lead, pad_value)
