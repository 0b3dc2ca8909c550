"""Train-time augmentation, counterpart of ``mmr_tpu/data/augment.py``,
on NHWC batches. Each pipeline takes its random draws from explicit
``torch.Generator``s in one function and applies given draws in another,
so that a test can feed JAX's own draws to the port. The generators give
other numbers than JAX's keys from the same seed.

Path A (``augment_path_a_batch``; the reference's
``SegNetDataLoaderV1_SAR.py:185-209``), per sample:

1. h-flip, v-flip and rotate-90° (same canvas), each with p = 0.5, on the
   image and the mask alike;
2. brightness ×U(0.9, 1.1) with p = 0.5 (torchvision ``adjust_brightness``,
   clipped to [0, 1]);
3. contrast: a blend with the grayscale mean, factor U(0.9, 1.1), p = 0.5
   (torchvision ``adjust_contrast``, clipped to [0, 1]).

:func:`path_a_draws` draws, :func:`apply_path_a` applies.

Path B (the nnU-Net pipeline, ``Pre_Process.py:278-463``; ranges by regime
in :class:`AugmentConfig`): rotation and scaling (p = 0.2 each; one
angle and scale for the whole batch unless ``per_sample_spatial``) with
the center crop to the patch → Gaussian noise → Gaussian blur →
brightness → contrast → simulated low resolution → gamma → mirror, the
intensity chain in bf16 with JAX's rounding points (``augment.py:
399-477``). :func:`augment_draws` draws: the batch-shared scalars (whether
the warp runs, its angle and scale, the low-resolution scale) on the host
from a CPU generator, so that choosing between the warp and the crop is a
host decision and never waits on the card; the per-sample draws in two
bulk calls on a device generator seeded from it. :func:`apply_augment`
and :func:`apply_augment_u8` apply; :func:`augment_train_batch` and
:func:`augment_train_batch_u8` do both. The uint8 path warps the raw bytes
and folds the per-channel normalization in after the warp through the
corners' weight-sum map (``augment.py:240-252, 338-343``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


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


# ------------------------------------------------------------------ Path B

_BLUR_RADIUS = 4   # batchgenerators truncates at 4σ; σ ≤ 1 needs radius 4


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    patch_size: tuple[int, int] = (512, 640)
    rotation: bool = True
    scaling: bool = True
    gaussian_noise: bool = True
    gaussian_blur: bool = True
    brightness: bool = True
    contrast: bool = True
    low_resolution: bool = True
    gamma: bool = True
    mirror: bool = True
    heavy: bool = False
    # one rotation / scale per sample (the reference's distribution) instead
    # of one per batch; intensity transforms and mirroring are per sample
    # either way
    per_sample_spatial: bool = False

    # regime-dependent ranges (Pre_Process.py:713-771)
    @property
    def rot_range(self) -> float:
        if not self.heavy:
            return 0.174533  # ±10°
        ph, pw = self.patch_size
        return np.pi * 15 / 180 if max(ph, pw) / min(ph, pw) > 1.5 else np.pi

    @property
    def scale_range(self):
        return (0.7, 1.4) if self.heavy else (0.9, 1.1)

    @property
    def brightness_range(self):
        return (0.75, 1.25) if self.heavy else (0.9, 1.1)

    @property
    def contrast_range(self):
        return (0.75, 1.25) if self.heavy else (0.9, 1.1)

    @property
    def gamma_range(self):
        return (0.7, 1.5) if self.heavy else (0.9, 1.1)

    @property
    def mirror_axes(self) -> tuple[int, ...]:
        return (0, 1) if self.heavy else (1,)  # (H, W) axes; soft mirrors W only

    @property
    def initial_patch_size(self) -> tuple[int, int]:
        """The source patch that heavy rotation / scaling never samples
        outside (nnU-Net ``get_initial_patch_size``; the patch itself in the
        soft regime)."""
        if not self.heavy:
            return self.patch_size
        ph, pw = self.patch_size
        rot = min(self.rot_range, np.pi / 2)
        c, s = np.abs(np.cos(rot)), np.abs(np.sin(rot))
        scale = 1 / min(self.scale_range)
        return (int(np.ceil((ph * c + pw * s) * scale)),
                int(np.ceil((ph * s + pw * c) * scale)))

    @property
    def intensity(self) -> bool:
        """Whether any intensity transform is on (the chain then runs in
        bf16)."""
        return (self.gaussian_noise or self.gaussian_blur or self.brightness
                or self.contrast or self.low_resolution or self.gamma)


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    """The draws of one batch.

    Spatial. Batch-shared: ``warp`` (rotation or scaling fired: warp, else
    center crop) and the host floats ``angle`` (0 unless rotation fired)
    and ``scale`` (1 unless scaling fired). Per sample
    (``per_sample_spatial``): ``angle`` and ``scale`` are (B,) tensors.

    Intensity, per sample, None for a transform that is off:
    ``noise_do`` (B,) bool, ``noise_var`` (B,), ``noise`` (B, oh, ow, C)
    bf16 standard normal; ``blur_sigma`` (B,) and ``blur_ch`` (B, C) bool
    (the channels blurred: fired and picked); ``bright`` and ``contrast``
    (B, C) factors, 1 where not fired; ``lowres_scale`` a host float and
    ``lowres_ch`` (B, C) bool; ``gamma_do`` (B,) bool and ``gamma`` (B, C),
    1 where not fired; ``mirror``, one (B,) bool per mirror axis."""

    warp: bool
    angle: float | torch.Tensor
    scale: float | torch.Tensor
    noise_do: torch.Tensor | None = None
    noise_var: torch.Tensor | None = None
    noise: torch.Tensor | None = None
    blur_sigma: torch.Tensor | None = None
    blur_ch: torch.Tensor | None = None
    bright: torch.Tensor | None = None
    contrast: torch.Tensor | None = None
    lowres_scale: float | None = None
    lowres_ch: torch.Tensor | None = None
    gamma_do: torch.Tensor | None = None
    gamma: torch.Tensor | None = None
    mirror: tuple[torch.Tensor, ...] = ()


def _f32(x: float) -> float:
    return float(np.float32(x))


def augment_draws(cfg: AugmentConfig, generator: torch.Generator, shape,
                  device: str | torch.device) -> AugmentDraws:
    """The draws of a batch of ``shape`` (B, iH, iW, C). ``generator`` is a
    CPU generator: the batch-shared scalars come from it on the host, and
    it seeds a generator on ``device`` for the per-sample draws (one
    uniform block, and the noise)."""
    if generator.device.type != "cpu":
        raise ValueError("the Path-B augmentation draws from a CPU generator")
    b, c = shape[0], shape[-1]
    oh, ow = cfg.patch_size
    u = torch.rand(5, generator=generator, dtype=torch.float64).tolist()
    dev_gen = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2 ** 62, (1,), generator=generator)))
    rr, (s_lo, s_hi) = cfg.rot_range, cfg.scale_range
    if cfg.per_sample_spatial:
        v = torch.rand((4, b), generator=dev_gen, device=device)
        rot = (v[0] < 0.2) & cfg.rotation
        sc = (v[2] < 0.2) & cfg.scaling
        warp = True
        angle = torch.where(rot, -rr + 2 * rr * v[1], 0.0)
        scale = torch.where(sc, s_lo + (s_hi - s_lo) * v[3], 1.0)
    else:
        rot, sc = cfg.rotation and u[0] < 0.2, cfg.scaling and u[2] < 0.2
        warp = rot or sc
        angle = _f32(-rr + 2 * rr * u[1]) if rot else 0.0
        scale = _f32(s_lo + (s_hi - s_lo) * u[3]) if sc else 1.0

    v = torch.rand((b, 10 + 11 * c), generator=dev_gen, device=device)
    col = lambda i: v[:, i]
    blk = lambda j: v[:, 10 + j * c:10 + (j + 1) * c]

    def bg_contrast(j, lo, hi):
        """batchgenerators' BGContrast: U(lo, 1) or U(1, hi), p = 0.5 each."""
        return torch.where(blk(j + 2) < 0.5, lo + (1.0 - lo) * blk(j),
                           1.0 + (hi - 1.0) * blk(j + 1))

    def fired(i, p, factor):
        return torch.where(col(i)[:, None] < p, factor, 1.0)

    kw = {}
    if cfg.gaussian_noise:
        kw.update(noise_do=col(0) < 0.1, noise_var=0.1 * col(1),
                  noise=torch.randn((b, oh, ow, c), generator=dev_gen,
                                    device=device, dtype=torch.bfloat16))
    if cfg.gaussian_blur:
        kw.update(blur_sigma=0.5 + 0.5 * col(3),
                  blur_ch=(blk(0) < 0.5) & (col(2) < 0.2)[:, None])
    if cfg.brightness:
        kw.update(bright=fired(4, 0.15, bg_contrast(2, *cfg.brightness_range)))
    if cfg.contrast:
        kw.update(contrast=fired(5, 0.15, bg_contrast(5, *cfg.contrast_range)))
    if cfg.low_resolution:
        kw.update(lowres_scale=_f32(0.5 + 0.5 * u[4]),
                  lowres_ch=(blk(1) < 0.5) & (col(6) < 0.25)[:, None])
    if cfg.gamma:
        kw.update(gamma_do=col(7) < 0.3,
                  gamma=fired(7, 0.3, bg_contrast(8, *cfg.gamma_range)))
    if cfg.mirror:
        kw.update(mirror=tuple(col(8 + i) < 0.5
                               for i in range(len(cfg.mirror_axes))))
    return AugmentDraws(warp=warp, angle=angle, scale=scale, **kw)


def _coords(oh: int, ow: int, angle, scale, cy, cx, device):
    """Source rows and columns (f32) of every output pixel of the
    rotate-then-scale map about the center (``augment.py:140-150``):
    (oh, ow) for host scalars, (B, oh, ow) for (B,) tensors."""
    yy = torch.arange(oh, dtype=torch.float32, device=device) - (oh - 1) / 2.0
    xx = torch.arange(ow, dtype=torch.float32, device=device) - (ow - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    if isinstance(angle, torch.Tensor):
        ca, sa = (f(angle)[:, None, None] for f in (torch.cos, torch.sin))
        scale = scale[:, None, None]
    else:
        a = np.float32(angle)
        ca, sa = float(np.cos(a)), float(np.sin(a))
    return ((gy * ca - gx * sa) * scale + cy, (gy * sa + gx * ca) * scale + cx)


def _nearest_masks(masks, sy, sx, round_fn):
    """Nearest-neighbour mask lookup at source coordinates (oh, ow) or
    (B, oh, ow), 0 outside the source."""
    b, ih, iw = masks.shape
    yn, xn = round_fn(sy).long(), round_fn(sx).long()
    rows = lambda t: t.reshape(-1, sy.shape[-2] * sy.shape[-1]).expand(b, -1)
    inb = (yn >= 0) & (yn < ih) & (xn >= 0) & (xn < iw)
    idx = rows(yn.clamp(0, ih - 1) * iw + xn.clamp(0, iw - 1))
    mw = torch.gather(masks.reshape(b, ih * iw), 1, idx)
    return torch.where(rows(inb), mw, 0).reshape(b, *sy.shape[-2:])


def _warp_shared(images, masks, angle: float, scale: float, out_hw, u8: bool):
    """Warp the whole batch with one (angle, scale) (``augment.py:
    130-186``; uint8 sources ``:240-294``). The source center is the crop's
    floor offset, so the identity warp is the center crop. Each bilinear
    corner is gathered in bf16 (uint8 sources as they are), weighted by
    its bf16 weight, 0 outside the source, and added into a bf16
    accumulator. Masks take the nearest pixel (round half to even, as
    ``jnp.round``). Returns (accumulator bf16 (B, oh, ow, C), the corners'
    f32 weight sum (oh, ow), masks)."""
    b, ih, iw, c = images.shape
    oh, ow = out_hw
    sy, sx = _coords(oh, ow, angle, scale, (ih - oh) // 2 + (oh - 1) / 2.0,
                     (iw - ow) // 2 + (ow - 1) / 2.0, images.device)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    y0i, x0i = y0.long(), x0.long()
    flat = images.reshape(b, ih * iw, c)
    if not u8:
        flat = flat.to(torch.bfloat16)
    acc = torch.zeros((b, oh * ow, c), dtype=torch.bfloat16, device=images.device)
    wsum = torch.zeros((oh, ow), dtype=torch.float32, device=images.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yc, xc = y0i + dy, x0i + dx
            wgt = (fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
            inb = (yc >= 0) & (yc < ih) & (xc >= 0) & (xc < iw)
            w_eff = torch.where(inb, wgt, 0.0)
            idx = (yc.clamp(0, ih - 1) * iw + xc.clamp(0, iw - 1)).reshape(-1)
            acc = acc + flat[:, idx].to(torch.bfloat16) \
                * w_eff.reshape(1, -1, 1).to(torch.bfloat16)
            wsum = wsum + w_eff
    return (acc.reshape(b, oh, ow, c), wsum,
            _nearest_masks(masks, sy, sx, torch.round))


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (``lax.round``'s default)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _warp_per_sample(images, masks, angle, scale, out_hw):
    """Each sample warped by its own (angle, scale) about the source's
    center ``(ih − 1) / 2``, as ``map_coordinates`` does it in
    ``augment.py:108-127``: the image bilinear in f32 (corners outside the
    source 0, the four weighted corners added in order), the masks nearest
    (round half away from zero)."""
    b, ih, iw, c = images.shape
    oh, ow = out_hw
    sy, sx = _coords(oh, ow, angle, scale, (ih - 1) / 2.0, (iw - 1) / 2.0,
                     images.device)
    flat = images.reshape(b, ih * iw, c)
    nodes = []
    for s, n in ((sy, ih), (sx, iw)):
        lo = torch.floor(s)
        hi_w = s - lo
        nodes.append(((lo.long(), 1 - hi_w), (lo.long() + 1, hi_w)))
    out = None
    for yi, wy in nodes[0]:
        for xi, wx in nodes[1]:
            valid = (yi >= 0) & (yi < ih) & (xi >= 0) & (xi < iw)
            idx = (yi.clamp(0, ih - 1) * iw + xi.clamp(0, iw - 1)).reshape(b, -1, 1)
            v = torch.gather(flat, 1, idx.expand(-1, -1, c))
            o = (wy * wx).reshape(b, -1, 1) * torch.where(
                valid.reshape(b, -1, 1), v, 0.0)
            out = o if out is None else out + o
    return out.reshape(b, oh, ow, c), _nearest_masks(masks, sy, sx, _round_away)


def center_crop_batch(images, masks, patch_size: tuple[int, int]):
    """The deterministic center crop (views): the augmentation's identity
    warp, and validation's crop (the reference's validation pipeline is
    SpatialTransform-only, Pre_Process.py:450-462)."""
    ih, iw = images.shape[1], images.shape[2]
    oh, ow = patch_size
    y0, x0 = (ih - oh) // 2, (iw - ow) // 2
    return images[:, y0:y0 + oh, x0:x0 + ow], masks[:, y0:y0 + oh, x0:x0 + ow]


def _gaussian_blur(images, sigma, ch):
    """Separable Gaussian blur with a per-sample sigma, edge padding, radius
    4 (``augment.py:196-221``): bf16 taps, each pass accumulated in f32 and
    rounded to bf16; only the channels in ``ch`` take it."""
    b, h, w, c = images.shape
    r = _BLUR_RADIUS
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=images.device)
    wgt = torch.exp(-0.5 * (x[None, :] / torch.clamp_min(sigma[:, None], 1e-6)) ** 2)
    wgt = wgt / wgt.sum(dim=1, keepdim=True)
    k = wgt.repeat_interleave(c, dim=0).to(images.dtype).float()   # (B·C, 2r+1)
    y = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w).float()
    y = F.pad(y, (r, r, r, r), mode="replicate")
    y = F.conv2d(y, k[:, None, :, None], groups=b * c).to(images.dtype)
    y = F.conv2d(y.float(), k[:, None, None, :], groups=b * c).to(images.dtype)
    y = y.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return torch.where(ch[:, None, None, :], y, images)


def _low_res(images, scale: float, ch):
    """Simulated low resolution with one scale for the batch: every row and
    column taken from its snapped source (``augment.py:224-237``)."""
    def snap(n):
        i = torch.arange(n, dtype=torch.float32, device=images.device)
        return torch.floor(torch.floor(i * scale) / scale + 0.5).long().clamp(0, n - 1)

    low = images[:, snap(images.shape[1])][:, :, snap(images.shape[2])]
    return torch.where(ch[:, None, None, :], low, images)


def _intensity_and_mirror(images, masks, d: AugmentDraws, cfg: AugmentConfig):
    """The intensity chain and mirroring (``augment.py:399-477``): in bf16
    when any intensity transform is on, each transform rounded back to bf16
    where JAX rounds it; statistics in f32, the standard deviations
    population ones."""
    bf16 = torch.bfloat16
    if cfg.intensity:
        images = images.to(bf16)
    per_sample = lambda t: t[:, None, None, None]
    per_channel = lambda t: t[:, None, None, :]
    if cfg.gaussian_noise:
        images = torch.where(per_sample(d.noise_do), images + d.noise * per_sample(
            torch.sqrt(d.noise_var).to(bf16)), images)
    if cfg.gaussian_blur:
        images = _gaussian_blur(images, d.blur_sigma, d.blur_ch)
    if cfg.brightness:
        images = (images * per_channel(d.bright)).to(bf16)
    if cfg.contrast:
        imf = images.float()
        mean = imf.mean(dim=(1, 2), keepdim=True)
        mn, mx = imf.amin(dim=(1, 2), keepdim=True), imf.amax(dim=(1, 2), keepdim=True)
        images = torch.clamp((images - mean) * per_channel(d.contrast) + mean,
                             mn, mx).to(bf16)
    if cfg.low_resolution:
        images = _low_res(images, d.lowres_scale, d.lowres_ch)
    if cfg.gamma:
        imf = images.float()
        mn = imf.amin(dim=(1, 2), keepdim=True)
        rng = imf.amax(dim=(1, 2), keepdim=True) - mn
        mean = imf.mean(dim=(1, 2), keepdim=True)
        std = imf.std(dim=(1, 2), keepdim=True, correction=0)
        norm = (images - mn) / (rng + 1e-7)
        gam = torch.pow(torch.clamp(norm, 1e-7, 1.0), per_channel(d.gamma)) \
            * (rng + 1e-7) + mn
        gam = (gam - gam.mean(dim=(1, 2), keepdim=True)) / (
            gam.std(dim=(1, 2), keepdim=True, correction=0) + 1e-8) * std + mean
        images = torch.where(per_sample(d.gamma_do), gam, images).to(bf16)
    if cfg.mirror:
        for do, ax in zip(d.mirror, cfg.mirror_axes):
            images = torch.where(per_sample(do), images.flip(ax + 1), images)
            masks = torch.where(do[:, None, None], masks.flip(ax + 1), masks)
    return images.contiguous(), masks.contiguous()


def _on(d: AugmentDraws, device) -> AugmentDraws:
    """The draws' tensors on ``device`` (no copy where they are already)."""
    move = lambda v: v.to(device) if isinstance(v, torch.Tensor) else v
    return dataclasses.replace(d, **{
        f.name: (tuple(map(move, v)) if isinstance(v, tuple) else move(v))
        for f in dataclasses.fields(d) for v in (getattr(d, f.name),)})


def apply_augment(images, masks, d: AugmentDraws, cfg: AugmentConfig):
    """``images`` (B, iH, iW, C) f32 (normalized), ``masks`` (B, iH, iW)
    ints -> the patch-sized augmented pair under the draws ``d``
    (``augment.py:348-396``). Images come out bf16 when an intensity
    transform is on, else in their own dtype (bf16-rounded values where the
    batch-shared warp ran)."""
    d = _on(d, images.device)
    if cfg.per_sample_spatial:
        images, masks = _warp_per_sample(images, masks, d.angle, d.scale,
                                         cfg.patch_size)
    elif d.warp:
        acc, _, masks = _warp_shared(images, masks, d.angle, d.scale,
                                     cfg.patch_size, u8=False)
        images = acc.to(images.dtype)
    else:
        images, masks = center_crop_batch(images, masks, cfg.patch_size)
    return _intensity_and_mirror(images, masks, d, cfg)


@functools.lru_cache(maxsize=None)
def _u8_affine(mean: tuple, std: tuple, device: str):
    """The uint8 path's bf16 per-channel scale 1 / (255·std) and offset
    mean / std (``augment.py:338-339``), made once per device."""
    m, s = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    inv, off = 1.0 / (255.0 * s), m / s
    return tuple(torch.from_numpy(a).to(torch.bfloat16).to(device) for a in (inv, off))


def apply_augment_u8(images, masks, d: AugmentDraws, cfg: AugmentConfig,
                     mean: tuple, std: tuple):
    """``images`` (B, iH, iW, C) uint8 0..255 -> bf16 images normalized by
    ``(x / 255 − mean) / std`` and augmented under the draws ``d``
    (``augment.py:297-345``): the warp or crop on the raw bytes, the
    normalization after it, the warp's zero fill outside the source
    rebuilt from the corners' weight sum. ``per_sample_spatial`` takes the
    f32 path."""
    if cfg.per_sample_spatial:
        raise ValueError("per-sample spatial draws take the f32 path")
    d = _on(d, images.device)
    inv, off = _u8_affine(tuple(mean), tuple(std), str(images.device))
    if d.warp:
        acc, wsum, masks = _warp_shared(images, masks, d.angle, d.scale,
                                        cfg.patch_size, u8=True)
        images = acc * inv - off * wsum[None, :, :, None].to(torch.bfloat16)
    else:
        imc, masks = center_crop_batch(images, masks, cfg.patch_size)
        images = imc.to(torch.bfloat16) * inv - off    # the weight sum is 1
    return _intensity_and_mirror(images, masks, d, cfg)


def augment_train_batch(generator: torch.Generator, images, masks,
                        cfg: AugmentConfig):
    """Path B's augmentation of an f32 batch with fresh draws from the CPU
    ``generator`` (see :func:`augment_draws`)."""
    return apply_augment(images, masks, augment_draws(
        cfg, generator, images.shape, images.device), cfg)


def augment_train_batch_u8(generator: torch.Generator, images, masks,
                           cfg: AugmentConfig, mean: tuple, std: tuple):
    """Path B's augmentation of a uint8 batch, normalization folded in,
    with fresh draws from the CPU ``generator``."""
    return apply_augment_u8(images, masks, augment_draws(
        cfg, generator, images.shape, images.device), cfg, mean, std)
