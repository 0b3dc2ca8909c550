"""Train and eval steps (counterpart of ``mmr_tpu/train/steps.py``), on
one device or on a data-parallel :class:`~mmr_tpu_torch.core.mesh.Mesh`.

One train step: per microbatch the augmentation → forward in train mode →
loss → backward (gradients summed over the ``n_accum`` microbatches as the
mean, BN running statistics updated microbatch by microbatch, as the JAX
scan carries them) → clip + optimizer update. With the default DiceCE loss
a fused model runs the head as the fused head + loss kernel
(``steps.py:85-87``): loss and the per-batch macro IoU come from its
statistics and confusion, and the NHWC logits never exist. The step
updates the model's parameters and BN statistics and the optimizer state
in place.

``augment`` is Path B's :class:`~mmr_tpu_torch.data.augment.AugmentConfig`
or a callable ``augment(generator, images, masks) -> (images, masks)``
(the Path-A hook, ``cli/train_path_a.py:239-251``). The input path is
chosen where JAX chooses it (``steps.py:135-154``): uint8 images with an
``AugmentConfig``, batch-shared spatial draws and a
:class:`~mmr_tpu_torch.models.factory.Preprocessing` take
``augment_train_batch_u8`` (the warp on the raw bytes, the normalization
folded in after it); anything else runs /255 (uint8) → ``preprocess`` →
the augmentation. An ``AugmentConfig`` draws from a CPU generator (its
batch-shared scalars on the host, its per-sample draws on a device
generator seeded from it). A model with dropout (SegNet, DeepLabV3+) draws
its masks in train mode from the step's ``generator`` after a callable
augmentation's draws, as JAX feeds its step's key to flax's ``dropout``
stream; with an ``AugmentConfig``, from a device generator seeded from the
CPU one.

On a multi-rank mesh each rank's step takes its slice of the global batch
(``mesh.shard_batch(..., axis=1)``) and computes what JAX's sharded steps
compute (``steps.py:195-225``): train-mode BN over the global batch (the
moments summed over the ranks), the per-rank loss's gradient averaged over
the ranks in one flat all-reduce before the clip, the IoU from statistics
summed before the divide, the loss the ranks' mean (DiceCE is a mean over
samples and pixels, so the mean of equal shards is the global batch's).
Draws: a fused model runs as JAX's ``shard_map`` step, each rank drawing
over its own samples from the step's generator folded with its rank
(``steps.py:160-162``); a plain model as JAX's GSPMD step, every rank
drawing for the global batch and taking its rows (augmentation and
dropout), so that together they draw what one device draws.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable

import torch

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.core.mesh import Mesh, psum_if_sharded
from mmr_tpu_torch.data.augment import (AugmentConfig, augment_train_batch,
                                        augment_train_batch_u8)
from mmr_tpu_torch.losses.dice_ce import dice_ce_loss
from mmr_tpu_torch.metrics.confusion import segmentation_stats
from mmr_tpu_torch.metrics.iou import iou_score
from mmr_tpu_torch.models.factory import Preprocessing
from mmr_tpu_torch.models.layers import dropouts, set_dropout
from mmr_tpu_torch.ops.head_loss import assemble_dice_ce


def _macro_iou(tp, fp, fn, tn) -> torch.Tensor:
    return iou_score(tp[None], fp[None], fn[None], tn[None], reduction="macro")


def batch_iou(logits: torch.Tensor, masks: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Per-batch macro IoU: per-class stats summed over the batch, and over
    the ranks of an active mesh, before the divide (``steps.py:43-56``)."""
    tp, fp, fn, tn = segmentation_stats(logits.argmax(-1), masks, num_classes)
    return _macro_iou(*psum_if_sharded(
        torch.stack([tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0)])))


def confusion_iou(conf: torch.Tensor) -> torch.Tensor:
    """Macro IoU from a ``conf[pred, label]`` confusion, summed over the
    ranks of an active mesh first (``steps.py:107-117``)."""
    conf = psum_if_sharded(conf)
    tp = torch.diagonal(conf)
    fp = conf.sum(1) - tp
    fn = conf.sum(0) - tp
    return _macro_iou(tp, fp, fn, conf.sum() - tp - fp - fn)


def _prepare(images: torch.Tensor, device, preprocess):
    img = images.to(device, non_blocking=True)
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    return preprocess(img) if preprocess is not None else img


def _device(device, mesh: Mesh | None) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        raise ValueError("pass device or mesh, not both")
    return mesh.device


def _rank_mean(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks (JAX's ``pmean``), or ``x``."""
    return x if mesh is None or mesh.size == 1 else psum_if_sharded(x, mesh) / mesh.size


def _folded(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator for this rank's own draws: seeded from one draw of
    ``generator`` (the same on every rank) plus the rank (JAX's
    ``fold_in(key, axis_index)``)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed + rank)


def make_train_step(model, optimizer, loss_fn: Callable, num_classes: int,
                    n_accum: int = 1, augment=None,
                    preprocess: Callable | None = None,
                    compute_iou: bool = True,
                    fused_head_loss: bool | None = None, device=None,
                    mesh: Mesh | None = None):
    """Returns ``step(state, images, masks, lr, generator=None) -> (state,
    metrics)``.

    ``images``: (n_accum, B, H, W, C) uint8 or f32 in [0, 1]; ``masks``:
    (n_accum, B, H, W) int; ``state.model`` is ``model``; ``generator``
    (a ``torch.Generator``, needed with ``augment`` and with dropout unless
    every dropout's keep-mask is fed; a CPU one with an ``AugmentConfig``)
    supplies the augmentation and dropout draws. ``metrics`` holds 0-d
    device tensors ``loss`` and ``iou`` (means over the microbatches).
    ``device=None`` is CUDA; ``mesh`` runs the step data-parallel on
    ``mesh.device`` (B is then this rank's share, the same on every rank;
    see the module's docstring)."""
    config = isinstance(augment, AugmentConfig)
    if augment is not None and not config and not callable(augment):
        raise TypeError("augment is an AugmentConfig or a callable "
                        "augment(generator, images, masks)")
    dev = _device(device, mesh)
    sharded = mesh is not None and mesh.size > 1
    # a plain model draws for the global batch (JAX's GSPMD step)
    rows = (mesh.rank, mesh.size) if sharded and not getattr(model, "fused", False) else None
    if (rows and augment is not None and not config
            and "rows" not in inspect.signature(augment).parameters):
        raise ValueError("on a multi-rank mesh a plain model's augmentation "
                         "draws for the global batch: the callable needs a "
                         "rows=(rank, ranks) argument")
    aug_kw = {"rows": rows} if rows else {}
    if fused_head_loss is None:
        fused_head_loss = loss_fn is dice_ce_loss and getattr(model, "fused", False)
    names, params = zip(*model.named_parameters())
    params = list(params)
    mult = optimizer.lr_mult(list(names), params)
    drops = dropouts(model)

    def micro(images, masks, generator):
        msk = masks.to(dev, non_blocking=True)
        if (config and images.dtype == torch.uint8 and not augment.per_sample_spatial
                and isinstance(preprocess, Preprocessing)):
            img, msk = augment_train_batch_u8(
                generator, images.to(dev, non_blocking=True), msk, augment,
                preprocess.mean, preprocess.std, **aug_kw)
        else:
            img = _prepare(images, dev, preprocess)
            if config:
                img, msk = augment_train_batch(generator, img, msk, augment, **aug_kw)
            elif augment is not None:
                img, msk = augment(generator, img, msk, **aug_kw)
        if fused_head_loss:
            res = model(img, labels=msk, with_conf=compute_iou)
            loss, conf = assemble_dice_ce(res["stats"], res["conf"], res["n_pixels"])
            iou = confusion_iou(conf) if compute_iou else loss.new_zeros(())
        else:
            logits = model(img)
            loss = loss_fn(logits, msk)
            iou = (batch_iou(logits.detach(), msk, num_classes) if compute_iou
                   else loss.new_zeros(()))
        return loss, iou

    def step(state, images, masks, lr: float,
             generator: torch.Generator | None = None):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was built for")
        if images.shape[0] != n_accum or masks.shape[0] != n_accum:
            raise ValueError(f"expected {n_accum} stacked microbatches")
        if augment is not None and generator is None:
            raise ValueError("augment needs a generator for its draws")
        if generator is None and any(m.keep is None for m in drops):
            raise ValueError("the model's dropout needs a generator for its "
                             "draws")
        if config and generator.device.type != "cpu":
            raise ValueError("an AugmentConfig draws from a CPU generator")
        if sharded and rows is None and generator is not None:
            generator = _folded(generator, mesh.rank)
        if config and drops:
            set_dropout(model, torch.Generator(device=dev).manual_seed(
                int(torch.randint(0, 2 ** 62, (1,), generator=generator))), rows)
        else:
            set_dropout(model, generator, rows)
        model.train()
        for p in params:
            p.grad = None
        loss_sum = iou_sum = 0.0
        with mesh.active() if sharded else contextlib.nullcontext():
            for i in range(n_accum):
                loss, iou = micro(images[i], masks[i], generator)
                (loss / n_accum).backward()
                loss_sum = loss_sum + loss.detach()
                iou_sum = iou_sum + iou
        state.opt_state = optimizer.apply_updates(
            params, state.opt_state, [p.grad for p in params], lr, mult, mesh=mesh)
        state.step += 1
        loss_sum, iou_sum = _rank_mean(mesh, torch.stack([loss_sum, iou_sum]).float())
        return state, {"loss": loss_sum / n_accum, "iou": iou_sum / n_accum}

    return step


def make_eval_step(model, loss_fn: Callable, num_classes: int,
                   preprocess: Callable | None = None, device=None,
                   mesh: Mesh | None = None):
    """Returns ``eval_step(state, images, masks) -> metrics``: loss, macro
    IoU and the per-class tp/fp/fn summed over the batch (for streaming
    aggregation); eval-mode BN. On a multi-rank ``mesh`` each rank passes
    its slice of the batch and gets the global batch's metrics: the loss
    the ranks' mean, tp/fp/fn summed over them before the IoU
    (``steps.py:235-262``)."""
    dev = _device(device, mesh)

    @torch.no_grad()
    def step(state, images, masks):
        model.eval()
        logits = model(_prepare(images, dev, preprocess))
        msk = masks.to(dev, non_blocking=True)
        tp, fp, fn, tn = segmentation_stats(logits.argmax(-1), msk, num_classes)
        tpc, fpc, fnc, tnc = psum_if_sharded(
            torch.stack([tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0)]), mesh)
        return {"loss": _rank_mean(mesh, loss_fn(logits, msk)), "iou": _macro_iou(tpc, fpc, fnc, tnc),
                "tp": tpc, "fp": fpc, "fn": fnc}

    return step
