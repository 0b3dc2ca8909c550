"""Image resize primitives with PyTorch-semantics options (NHWC), the
counterpart of ``mmr_tpu/ops/resize.py``:

- the Path-A UNet's "bilinear" upsample is nearest (the reference quirk,
  ``mode="nearest"``);
- ResNetUNet and the smp heads resize bilinearly with
  ``align_corners=True``;
- dataset-style resizes use half-pixel centres (``align_corners=False``).

Both resizes are separable 1-D gathers along H then W, as in JAX; the
bilinear lerp runs in the input's dtype (``resize.py:52``), so a bf16
tensor rounds where JAX's does. The gather indices and lerp weights of each
(in, out, align_corners, device, dtype) are made once, on the tensor's
device, and cached: a call does no host work beyond its launches.

``F.interpolate`` is not used: it computes source coordinates in f32 (JAX
in f64), which moves an f32 bilinear result up to ~1e-6 from JAX's (5 → 9
rows, half-pixel) and puts some nearest indices one off (4 → 82 pixels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _source_coords(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """Fractional source coordinate of each output index, clipped to
    [0, in_size − 1] (``resize.py::_source_coords``)."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and (in_size == 1 or out_size == 1):
        return np.zeros(out_size)
    if align_corners:
        src = dst * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    return np.clip(src, 0.0, in_size - 1)


@functools.lru_cache(maxsize=128)
@torch.inference_mode(False)
def _lerp_plan(in_size: int, out_size: int, align_corners: bool,
               device: torch.device, dtype: torch.dtype):
    """(lo, hi, 1 − w, w) of one axis: gather indices and weights in
    ``dtype`` on ``device``; ordinary tensors even when first made under
    ``inference_mode`` (autograd may meet them later)."""
    src = _source_coords(out_size, in_size, align_corners)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = torch.as_tensor((src - lo).astype(np.float32)).to(device, dtype)
    return (torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device),
            1.0 - w, w)


@functools.lru_cache(maxsize=128)
@torch.inference_mode(False)
def _nearest_index(in_size: int, out_size: int, device: torch.device):
    """torch ``nn.Upsample(mode="nearest")``: floor(dst · in / out)."""
    return torch.arange(out_size, device=device) * in_size // out_size


def _lerp_axis(x: torch.Tensor, axis: int, out_size: int,
               align_corners: bool) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if not x.is_floating_point():
        x = x.float()
    lo, hi, w0, w1 = _lerp_plan(in_size, out_size, align_corners, x.device, x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_size
    return (x.index_select(axis, lo) * w0.reshape(shape)
            + x.index_select(axis, hi) * w1.reshape(shape))


def _nearest_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size % in_size == 0:
        return x.repeat_interleave(out_size // in_size, dim=axis)
    return x.index_select(axis, _nearest_index(in_size, out_size, x.device))


def _h_axis(x: torch.Tensor) -> int:
    return x.ndim - 3 if x.ndim >= 3 else 0


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC / HW) images to ``out_hw``."""
    h = _h_axis(x)
    y = _lerp_axis(x, h, out_hw[0], align_corners)
    return _lerp_axis(y, h + 1, out_hw[1], align_corners)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize, any factor (the UNet quirk; masks)."""
    h = _h_axis(x)
    return _nearest_axis(_nearest_axis(x, h, out_hw[0]), h + 1, out_hw[1])


def resize(x: torch.Tensor, out_hw: tuple[int, int], mode: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    if mode == "nearest":
        return resize_nearest(x, out_hw)
    if mode == "bilinear":
        return resize_bilinear(x, out_hw, align_corners)
    raise ValueError(f"unknown resize mode {mode!r}")


def upsample2x(x: torch.Tensor, mode: str = "nearest",
               align_corners: bool = False) -> torch.Tensor:
    """×2 spatial upsample of an NHWC tensor."""
    return resize(x, (x.shape[-3] * 2, x.shape[-2] * 2), mode, align_corners)
