"""Path B's augmentation in the port (``mmr_tpu_torch/data/augment.py``:
``apply_augment``, ``apply_augment_u8``, ``augment_draws``) held against
the JAX package's ``augment_train_batch`` / ``augment_train_batch_u8`` on
JAX's own draws.

The draws are rebuilt from a key with JAX's own split sequence (26 keys,
taken in the order of ``augment.py:323-336, 371-394, 399-477``, the
Gaussian noise tensor included, ``_bg_contrast_batch`` called as it is)
and fed to the port's apply functions; the JAX function runs on the same
key. Batches of 8 × 40×48 into 32×32. Keys are picked by replaying the
draws so that each case covers its branch (warp or crop) with every
intensity transform firing on at least one sample.

Bounds: masks equal everywhere. Images equal bit for bit wherever the
spatial draws are batch-shared (both paths, both branches, both regimes,
every transform off): the port reproduces each bf16 rounding point of
JAX's chain, so one point missing or added would show as a difference.
With ``per_sample_spatial=True`` the bilinear sampling's f32 arithmetic
differs from ``map_coordinates``' by an f32 ulp now and then, and such a
value can round to the neighbouring bf16 value: images within atol 4e-3
with at most 0.1 % of values differing (measured 1.953e-3, one bf16 step
at |x| in [0.25, 0.5), on 0.04 % of values; one bf16 step at |x| in
[2, 4) is 1.6e-2).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.data.augment import (AugmentConfig, AugmentDraws,
                                        apply_augment, apply_augment_u8,
                                        augment_draws, augment_train_batch,
                                        augment_train_batch_u8,
                                        center_crop_batch)
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
B, IH, IW, C = 8, 40, 48, 3
PATCH = (32, 32)


def _cfg(**kw):
    from mmr_tpu.data.augment import AugmentConfig as JCfg

    kw.setdefault("patch_size", PATCH)
    return JCfg(**kw), AugmentConfig(**kw)


@functools.partial(jax.jit, static_argnames=("jcfg", "b", "c"))
def _jax_raw_draws(key, jcfg, b, c):
    """JAX's draws for ``key`` in its own order, as arrays (one compile
    per config in place of one per random op)."""
    from mmr_tpu.data.augment import _bg_contrast_batch

    jr = jax.random
    ks = iter(jr.split(key, 26))
    oh, ow = jcfg.patch_size
    shape = (b,) if jcfg.per_sample_spatial else ()
    rot = jr.bernoulli(next(ks), 0.2, shape) & bool(jcfg.rotation)
    r = dict(rot=rot, angle=jnp.where(rot, jr.uniform(
        next(ks), shape, minval=-jcfg.rot_range, maxval=jcfg.rot_range), 0.0))
    sc = jr.bernoulli(next(ks), 0.2, shape) & bool(jcfg.scaling)
    r.update(sc=sc, scale=jnp.where(sc, jr.uniform(
        next(ks), shape, minval=jcfg.scale_range[0], maxval=jcfg.scale_range[1]), 1.0))
    if jcfg.gaussian_noise:
        r.update(noise_do=jr.bernoulli(next(ks), 0.1, (b, 1, 1, 1)),
                 noise_var=jr.uniform(next(ks), (b, 1, 1, 1), minval=0.0, maxval=0.1),
                 noise=jr.normal(next(ks), (b, oh, ow, c), jnp.bfloat16))
    if jcfg.gaussian_blur:
        do = jr.bernoulli(next(ks), 0.2, (b, 1))
        r.update(blur_sigma=jr.uniform(next(ks), (b,), minval=0.5, maxval=1.0),
                 blur_ch=jr.bernoulli(next(ks), 0.5, (b, c)) & do)
    if jcfg.brightness:
        do = jr.bernoulli(next(ks), 0.15, (b, 1))
        mult = _bg_contrast_batch(next(ks), *jcfg.brightness_range, (b, c))
        r.update(bright_do=do, bright=jnp.where(do, mult, 1.0))
    if jcfg.contrast:
        do = jr.bernoulli(next(ks), 0.15, (b, 1))
        r.update(contrast_do=do, contrast=jnp.where(
            do, _bg_contrast_batch(next(ks), *jcfg.contrast_range, (b, c)), 1.0))
    if jcfg.low_resolution:
        do = jr.bernoulli(next(ks), 0.25, (b, 1))
        r.update(lowres_scale=jr.uniform(next(ks), (), minval=0.5, maxval=1.0),
                 lowres_ch=jr.bernoulli(next(ks), 0.5, (b, c)) & do)
    if jcfg.gamma:
        do = jr.bernoulli(next(ks), 0.3, (b, 1))
        r.update(gamma_do=do, gamma=jnp.where(
            do, _bg_contrast_batch(next(ks), *jcfg.gamma_range, (b, c)), 1.0))
    if jcfg.mirror:
        r.update(mirror=tuple(jr.bernoulli(next(ks), 0.5, (b, 1, 1, 1))
                              for _ in jcfg.mirror_axes))
    return r


def jax_draws(key, jcfg, b=B, c=C):
    """JAX's draws for ``key`` in its own order (``augment.py:323-336,
    371-394, 399-477``), as the port's :class:`AugmentDraws` (CPU
    tensors), and whether each intensity transform fired on some sample."""
    r = jax.tree_util.tree_map(np.array, _jax_raw_draws(key, jcfg, b, c))
    t = torch.from_numpy
    if jcfg.per_sample_spatial:
        kw = dict(warp=True, angle=t(r["angle"]), scale=t(r["scale"]))
    else:
        kw = dict(warp=bool(r["rot"] | r["sc"]), angle=float(r["angle"]),
                  scale=float(r["scale"]))
    fired = {}
    if jcfg.gaussian_noise:
        kw.update(noise_do=t(r["noise_do"]).reshape(b),
                  noise_var=t(r["noise_var"]).reshape(b),
                  noise=t(r["noise"].astype(np.float32)).to(torch.bfloat16))
        fired["noise"] = bool(r["noise_do"].any())
    if jcfg.gaussian_blur:
        kw.update(blur_sigma=t(r["blur_sigma"]), blur_ch=t(r["blur_ch"]))
        fired["blur"] = bool(r["blur_ch"].any())
    if jcfg.brightness:
        kw.update(bright=t(r["bright"]))
        fired["brightness"] = bool(r["bright_do"].any())
    if jcfg.contrast:
        kw.update(contrast=t(r["contrast"]))
        fired["contrast"] = bool(r["contrast_do"].any())
    if jcfg.low_resolution:
        kw.update(lowres_scale=float(r["lowres_scale"]), lowres_ch=t(r["lowres_ch"]))
        fired["low_resolution"] = bool(r["lowres_ch"].any())
    if jcfg.gamma:
        kw.update(gamma_do=t(r["gamma_do"]).reshape(b), gamma=t(r["gamma"]))
        fired["gamma"] = bool(r["gamma_do"].any())
    if jcfg.mirror:
        kw.update(mirror=tuple(t(m).reshape(b) for m in r["mirror"]))
        fired["mirror"] = any(bool(m.any()) for m in r["mirror"])
    return AugmentDraws(**kw), fired


def _key(jcfg, warp):
    """The first key whose draws take the given branch and fire every
    intensity transform on some sample."""
    for k in range(400):
        d, fired = jax_draws(jax.random.key(k), jcfg)
        if d.warp == warp and all(fired.values()):
            return jax.random.key(k), d
    raise AssertionError("no key found")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(11)
    img_u8 = rng.randint(0, 256, (B, IH, IW, C)).astype(np.uint8)
    # masks in blocks, so that a warp moves class borders
    masks = np.kron(rng.randint(0, 10, (B, IH // 4, IW // 4)),
                    np.ones((4, 4), np.int64)).astype(np.int32)
    img_f = (img_u8.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32)) \
        / np.asarray(STD, np.float32)
    return img_u8, img_f, masks


def _compare(got, want, atol=0.0, share=0.0):
    """Masks equal; images within ``atol`` with at most ``share`` of the
    values differing (both 0: bit-equal)."""
    gi, gm = got
    wi, wm = want
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm).astype(gm.numpy().dtype))
    wi = np.asarray(wi.astype(jnp.float32))
    gi = gi.float().numpy()
    assert gi.shape == wi.shape
    err, differ = np.abs(gi - wi).max(), np.mean(gi != wi)
    print(f"max |dimage| {err:.3e}, {differ:.4f} of values differ")
    assert err <= atol and differ <= share, (err, differ)


@pytest.mark.parametrize("regime, warp", [("soft", True), ("soft", False),
                                          ("heavy", True), ("heavy", False)])
def test_f32_path_matches_jax(batch, regime, warp):
    """Every transform on (low resolution too), batch-shared spatial
    draws, both branches, both regimes: masks and images bit-equal."""
    from mmr_tpu.data.augment import augment_train_batch as jax_aug

    _, img_f, masks = batch
    jcfg, cfg = _cfg(low_resolution=True, heavy=regime == "heavy")
    key, d = _key(jcfg, warp)
    want = jax_aug(key, jnp.asarray(img_f), jnp.asarray(masks), jcfg)
    got = apply_augment(torch.from_numpy(img_f), torch.from_numpy(masks), d, cfg)
    assert got[0].dtype == torch.bfloat16
    _compare(got, want)


@pytest.mark.parametrize("regime, warp", [("soft", True), ("soft", False),
                                          ("heavy", True)])
def test_u8_path_matches_jax(batch, regime, warp):
    """``augment_train_batch_u8``'s path: the warp on the raw bytes, the
    normalization after it through the weight-sum map; bit-equal."""
    from mmr_tpu.data.augment import augment_train_batch_u8 as jax_aug_u8

    img_u8, _, masks = batch
    jcfg, cfg = _cfg(low_resolution=True, heavy=regime == "heavy")
    key, d = _key(jcfg, warp)
    m8 = masks.astype(np.uint8)
    want = jax_aug_u8(key, jnp.asarray(img_u8), jnp.asarray(m8), jcfg, MEAN, STD)
    got = apply_augment_u8(torch.from_numpy(img_u8), torch.from_numpy(m8), d, cfg,
                           MEAN, STD)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.uint8
    _compare(got, want)


def test_per_sample_spatial_matches_jax(batch):
    """``per_sample_spatial=True``: each sample's own angle and scale
    through ``map_coordinates`` (bilinear f32, nearest masks rounding half
    away from zero), then the chain: masks equal, images within 4e-3 on
    at most 0.1 % of values (measured 1.953e-3 on 0.04 %)."""
    from mmr_tpu.data.augment import augment_train_batch as jax_aug

    _, img_f, masks = batch
    jcfg, cfg = _cfg(per_sample_spatial=True, heavy=True)
    for k in range(400):
        d, fired = jax_draws(jax.random.key(k), jcfg)
        if bool((d.angle != 0).any()) and bool((d.scale != 1).any()) \
                and all(fired.values()):
            break
    want = jax_aug(jax.random.key(k), jnp.asarray(img_f), jnp.asarray(masks), jcfg)
    _compare(apply_augment(torch.from_numpy(img_f), torch.from_numpy(masks), d, cfg),
             want, atol=4e-3, share=1e-3)


def test_all_off_is_the_center_crop(batch):
    """Every transform off: exactly the center crop, in f32, on both sides
    (the u8 path: the crop normalized in bf16, as JAX's)."""
    from mmr_tpu.data.augment import augment_train_batch as jax_aug
    from mmr_tpu.data.augment import augment_train_batch_u8 as jax_aug_u8
    from mmr_tpu.data.augment import center_crop_batch as jax_crop

    img_u8, img_f, masks = batch
    off = dict(rotation=False, scaling=False, gaussian_noise=False,
               gaussian_blur=False, brightness=False, contrast=False,
               low_resolution=False, gamma=False, mirror=False)
    jcfg, cfg = _cfg(**off)
    it, mt = torch.from_numpy(img_f), torch.from_numpy(masks)
    ci, cm = center_crop_batch(it, mt, PATCH)
    gi, gm = augment_train_batch(torch.Generator().manual_seed(0), it, mt, cfg)
    assert gi.dtype == torch.float32
    assert torch.equal(gi, ci) and torch.equal(gm, cm)
    wi, wm = jax_crop(jnp.asarray(img_f), jnp.asarray(masks), PATCH)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(wm))
    key = jax.random.key(3)
    want = jax_aug(key, jnp.asarray(img_f), jnp.asarray(masks), jcfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want[0]))
    d, _ = jax_draws(key, jcfg)
    want = jax_aug_u8(key, jnp.asarray(img_u8), jnp.asarray(masks.astype(np.uint8)),
                      jcfg, MEAN, STD)
    got = apply_augment_u8(torch.from_numpy(img_u8), torch.from_numpy(masks.astype(
        np.uint8)), d, cfg, MEAN, STD)
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(want[0].astype(jnp.float32)))


@pytest.mark.parametrize("heavy", [False, True])
def test_u8_path_equals_f32_path(batch, heavy):
    """The port's uint8 path against its own f32 path on the same draws
    (``tests/test_augment_u8.py:40-83`` for JAX): masks equal; images
    within the bf16 sampling bounds that file uses (max 0.08 and mean 0.01
    spatial only; mean 0.02 and 99.9 % quantile 0.2 with the whole chain)."""
    img_u8, img_f, masks = batch
    for chain in (False, True):
        kw = {} if chain else dict(gaussian_noise=False, gaussian_blur=False,
                                   brightness=False, contrast=False,
                                   low_resolution=False, gamma=False)
        cfg = AugmentConfig(patch_size=PATCH, heavy=heavy, **kw)
        for seed in range(6):
            d = augment_draws(cfg, torch.Generator().manual_seed(seed),
                              img_u8.shape, "cpu")
            ri, rm = apply_augment(torch.from_numpy(img_f), torch.from_numpy(masks),
                                   d, cfg)
            ni, nm = apply_augment_u8(torch.from_numpy(img_u8),
                                      torch.from_numpy(masks.astype(np.uint8)),
                                      d, cfg, MEAN, STD)
            np.testing.assert_array_equal(rm.numpy(), nm.numpy().astype(np.int32))
            err = (ri.float() - ni.float()).abs().numpy()
            if chain:
                assert err.mean() < 0.02 and np.quantile(err, 0.999) < 0.2
            else:
                assert err.max() < 0.08 and err.mean() < 0.01


def test_draw_distributions():
    """Each coin's rate and each factor's range over 4096 samples (batch
    draws over 1024 batches): rates within 4σ of p, factors inside their
    ranges and of both sides of 1 (``tests/test_aug_stats.py:20-47``)."""
    cfg = AugmentConfig(patch_size=(8, 8), heavy=True, low_resolution=True)
    n, c = 4096, 3
    d = augment_draws(cfg, torch.Generator().manual_seed(0), (n, 8, 8, c), "cpu")

    def rate(x, p):
        sigma = np.sqrt(p * (1 - p) / x.numel())
        assert abs(x.float().mean().item() - p) < 4 * sigma, (x.float().mean(), p)

    rate(d.noise_do, 0.1)
    rate(d.blur_ch, 0.2 * 0.5)
    rate(d.lowres_ch, 0.25 * 0.5)
    rate(d.gamma_do, 0.3)
    rate(d.bright[:, 0] != 1, 0.15)
    rate(d.contrast[:, 0] != 1, 0.15)
    for m in d.mirror:
        rate(m, 0.5)
    assert len(d.mirror) == 2
    assert 0 <= d.noise_var.min() and d.noise_var.max() < 0.1
    assert 0.5 <= d.blur_sigma.min() and d.blur_sigma.max() < 1.0
    for f, (lo, hi) in ((d.bright, cfg.brightness_range), (d.contrast, cfg.contrast_range),
                        (d.gamma, cfg.gamma_range)):
        fired = f[f != 1]
        assert lo <= fired.min() and fired.max() < hi
        rate(fired < 1, 0.5)
    assert d.noise.dtype == torch.bfloat16 and d.noise.shape == (n, 8, 8, c)
    assert abs(d.noise.float().std().item() - 1) < 0.01
    # batch-shared draws: one per batch, from the host generator
    gen = torch.Generator().manual_seed(1)
    draws = [augment_draws(cfg, gen, (1, 8, 8, c), "cpu") for _ in range(1024)]
    rot = torch.tensor([x.angle != 0 for x in draws])
    sc = torch.tensor([x.scale != 1 for x in draws])
    rate(rot, 0.2)
    rate(sc, 0.2)
    assert all(x.warp == (a or s) for x, a, s in zip(draws, rot, sc))
    angles = np.array([x.angle for x in draws if x.angle != 0])
    assert np.abs(angles).max() < cfg.rot_range and angles.min() < 0 < angles.max()
    lscale = np.array([x.lowres_scale for x in draws])
    assert 0.5 <= lscale.min() and lscale.max() < 1.0
    with pytest.raises(ValueError, match="CPU generator"):
        augment_draws(cfg, SimpleNamespace(device=torch.device("cuda")), (1, 8, 8, c),
                      "cpu")


class _Taken(Exception):
    pass


@pytest.mark.parametrize("dtype, pre, per_sample, path", [
    ("uint8", "imagenet", False, "u8"),
    ("float32", "imagenet", False, "f32"),
    ("uint8", "imagenet", True, "f32"),
    ("uint8", None, False, "f32"),
    ("uint8", "callable", False, "f32"),
])
def test_train_step_picks_the_uint8_path_as_jax(monkeypatch, dtype, pre, per_sample,
                                                path):
    """``make_train_step(augment=AugmentConfig(...))`` takes
    ``augment_train_batch_u8`` exactly where ``mmr_tpu/train/steps.py:
    135-154`` does (uint8 images, a ``Preprocessing``, batch-shared
    spatial draws), else /255 → preprocess → ``augment_train_batch``."""
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.train import steps
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState

    seen = {}

    def spy(name):
        def f(generator, images, masks, cfg, *a):
            seen.update(path=name, dtype=images.dtype, extra=a)
            raise _Taken
        return f

    monkeypatch.setattr(steps, "augment_train_batch_u8", spy("u8"))
    monkeypatch.setattr(steps, "augment_train_batch", spy("f32"))
    prep = {"imagenet": get_preprocessing(), None: None,
            "callable": lambda x: x * 2.0}[pre]
    model = create_model("unet", classes=3, device="cpu")
    opt = build_optimizer("adamw")
    cfg = AugmentConfig(patch_size=(16, 16), per_sample_spatial=per_sample)
    step = steps.make_train_step(model, opt, dice_ce_loss, 3, augment=cfg,
                                 preprocess=prep, device="cpu")
    images = torch.zeros((1, 2, 16, 16, 3), dtype=getattr(torch, dtype))
    masks = torch.zeros((1, 2, 16, 16), dtype=torch.uint8)
    with pytest.raises(_Taken):
        step(TrainState.create(model, opt), images, masks, 1e-3, torch.Generator())
    assert seen["path"] == path
    if path == "u8":
        assert seen["dtype"] == torch.uint8 and seen["extra"] == (prep.mean, prep.std)
    else:
        assert seen["dtype"] == torch.float32
    with pytest.raises(ValueError, match="CPU generator"):
        step(TrainState.create(model, opt), images, masks, 1e-3,
             SimpleNamespace(device=torch.device("cuda")))
