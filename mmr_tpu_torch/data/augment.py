"""Path-A train-time augmentation, counterpart of
``mmr_tpu/data/augment.py::augment_path_a_batch`` (the reference's
``SegNetDataLoaderV1_SAR.py:185-209``), on NHWC batches, per sample:

1. h-flip, v-flip and rotate-90° (same canvas), each with p = 0.5, on the
   image and the mask alike;
2. brightness ×U(0.9, 1.1) with p = 0.5 (torchvision ``adjust_brightness``,
   clipped to [0, 1]);
3. contrast: a blend with the grayscale mean, factor U(0.9, 1.1), p = 0.5
   (torchvision ``adjust_contrast``, clipped to [0, 1]).

:func:`path_a_draws` takes the random draws from an explicit
``torch.Generator``; :func:`apply_path_a` applies given draws, so that a
test can feed JAX's own draws to it. The two generators give different
numbers from the same seed.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PathADraws:
    """Per-sample draws, each a (B,) tensor: the three spatial coin flips
    and the two photometric ones (bool), and the two factors (f32)."""

    hflip: torch.Tensor
    vflip: torch.Tensor
    rot90: torch.Tensor
    bright: torch.Tensor
    do_bright: torch.Tensor
    contrast: torch.Tensor
    do_contrast: torch.Tensor


def path_a_draws(generator: torch.Generator, batch: int) -> PathADraws:
    """The draws for ``batch`` samples, on the generator's device."""
    u = torch.rand((7, batch), generator=generator, device=generator.device)
    return PathADraws(hflip=u[0] < 0.5, vflip=u[1] < 0.5, rot90=u[2] < 0.5,
                      bright=0.9 + 0.2 * u[3], do_bright=u[4] < 0.5,
                      contrast=0.9 + 0.2 * u[5], do_contrast=u[6] < 0.5)


def _rot90_index(h: int, w: int, device):
    """Source (row, col) of every output pixel of torchvision
    ``TF.rotate(x, 90)`` (content 90° counter-clockwise about the center,
    same canvas, nearest), and whether it lies inside the image
    (``augment.py::_rotate90_same_canvas``: map_coordinates order 0 rounds
    half away from zero, mode constant)."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    sy, sx = cy + (gx - cx), cx - (gy - cy)
    iy = (torch.sign(sy) * torch.floor(sy.abs() + 0.5)).long()
    ix = (torch.sign(sx) * torch.floor(sx.abs() + 0.5)).long()
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return iy.clamp(0, h - 1), ix.clamp(0, w - 1), inside


def _where(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(do.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def apply_path_a(images: torch.Tensor, masks: torch.Tensor, d: PathADraws):
    """``images`` (B, H, W, C) f32 in [0, 1], ``masks`` (B, H, W) ints ->
    the augmented pair under the draws ``d``."""
    d = PathADraws(*(t.to(images.device) for t in dataclasses.astuple(d)))
    images = _where(d.hflip, images.flip(2), images)
    masks = _where(d.hflip, masks.flip(2), masks)
    images = _where(d.vflip, images.flip(1), images)
    masks = _where(d.vflip, masks.flip(1), masks)

    iy, ix, inside = _rot90_index(images.shape[1], images.shape[2], images.device)
    rot_i = images[:, iy, ix] * inside[..., None].to(images.dtype)
    rot_m = torch.where(inside, masks[:, iy, ix], torch.zeros_like(masks[:, iy, ix]))
    images = _where(d.rot90, rot_i, images)
    masks = _where(d.rot90, rot_m, masks)

    bright = d.bright.to(images.dtype).reshape(-1, 1, 1, 1)
    images = _where(d.do_bright, torch.clamp(images * bright, 0.0, 1.0), images)
    c = d.contrast.to(images.dtype).reshape(-1, 1, 1, 1)
    gray = (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2]).mean((1, 2)).reshape(-1, 1, 1, 1)
    images = _where(d.do_contrast,
                    torch.clamp(c * images + (1 - c) * gray, 0.0, 1.0), images)
    return images, masks


def augment_path_a_batch(generator: torch.Generator, images: torch.Tensor,
                         masks: torch.Tensor):
    """The Path-A augmentation with fresh draws from ``generator``: the
    ``augment(generator, images, masks)`` hook of
    :func:`mmr_tpu_torch.train.steps.make_train_step`."""
    return apply_path_a(images, masks, path_a_draws(generator, images.shape[0]))
