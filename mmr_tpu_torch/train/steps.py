"""Train and eval steps (counterpart of ``mmr_tpu/train/steps.py``), on
one device.

One train step: per microbatch uint8 → /255 → ``preprocess`` →
``augment`` → forward in train mode → loss → backward (gradients summed
over the ``n_accum`` microbatches as the mean, BN running statistics
updated microbatch by microbatch, as the JAX scan carries them) → clip +
optimizer update. With the default DiceCE loss a fused model runs the head
as the fused head + loss kernel (``steps.py:85-87``): loss and the
per-batch macro IoU come from its statistics and confusion, and the NHWC
logits never exist. The step updates the model's parameters and BN
statistics and the optimizer state in place. ``augment`` is a callable
``augment(generator, images, masks) -> (images, masks)``, as the JAX step
takes a custom callable (the Path-A hook, ``cli/train_path_a.py:239-251``;
:func:`mmr_tpu_torch.data.augment.augment_path_a_batch`); Path B's
``AugmentConfig`` pipeline is not ported yet. A model with dropout (SegNet,
DeepLabV3+) draws its masks in train mode from the step's ``generator``
after the augmentation's draws, as JAX feeds its step's key to flax's
``dropout`` stream.
"""

from __future__ import annotations

from typing import Callable

import torch

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.losses.dice_ce import dice_ce_loss
from mmr_tpu_torch.metrics.confusion import segmentation_stats
from mmr_tpu_torch.metrics.iou import iou_score
from mmr_tpu_torch.models.layers import dropouts, set_dropout
from mmr_tpu_torch.ops.head_loss import assemble_dice_ce


def _macro_iou(tp, fp, fn, tn) -> torch.Tensor:
    return iou_score(tp[None], fp[None], fn[None], tn[None], reduction="macro")


def batch_iou(logits: torch.Tensor, masks: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Per-batch macro IoU: per-class stats summed over the batch before
    the divide (``steps.py:43-56``)."""
    tp, fp, fn, tn = segmentation_stats(logits.argmax(-1), masks, num_classes)
    return _macro_iou(tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0))


def confusion_iou(conf: torch.Tensor) -> torch.Tensor:
    """Macro IoU from a ``conf[pred, label]`` confusion (``steps.py:111-117``)."""
    tp = torch.diagonal(conf)
    fp = conf.sum(1) - tp
    fn = conf.sum(0) - tp
    return _macro_iou(tp, fp, fn, conf.sum() - tp - fp - fn)


def _prepare(images: torch.Tensor, device, preprocess):
    img = images.to(device, non_blocking=True)
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    return preprocess(img) if preprocess is not None else img


def make_train_step(model, optimizer, loss_fn: Callable, num_classes: int,
                    n_accum: int = 1, augment=None,
                    preprocess: Callable | None = None,
                    compute_iou: bool = True,
                    fused_head_loss: bool | None = None, device=None):
    """Returns ``step(state, images, masks, lr, generator=None) -> (state,
    metrics)``.

    ``images``: (n_accum, B, H, W, C) uint8 or f32 in [0, 1]; ``masks``:
    (n_accum, B, H, W) int; ``state.model`` is ``model``; ``generator``
    (a ``torch.Generator``, needed with ``augment`` and with dropout unless
    every dropout's keep-mask is fed) supplies the augmentation and dropout
    draws. ``metrics`` holds 0-d device tensors ``loss`` and ``iou`` (means
    over the microbatches). ``device=None`` is CUDA."""
    if augment is not None and not callable(augment):
        raise NotImplementedError(
            "only a callable augment(generator, images, masks) is ported; "
            "the AugmentConfig pipeline (mmr_tpu/data/augment.py) is not "
            "(ROADMAP.md)")
    dev = resolve_device(device)
    if fused_head_loss is None:
        fused_head_loss = loss_fn is dice_ce_loss and getattr(model, "fused", False)
    names, params = zip(*model.named_parameters())
    params = list(params)
    mult = optimizer.lr_mult(list(names), params)
    drops = dropouts(model)

    def micro(images, masks, generator):
        img = _prepare(images, dev, preprocess)
        msk = masks.to(dev, non_blocking=True)
        if augment is not None:
            img, msk = augment(generator, img, msk)
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
        set_dropout(model, generator)
        model.train()
        for p in params:
            p.grad = None
        loss_sum = iou_sum = 0.0
        for i in range(n_accum):
            loss, iou = micro(images[i], masks[i], generator)
            (loss / n_accum).backward()
            loss_sum = loss_sum + loss.detach()
            iou_sum = iou_sum + iou
        state.opt_state = optimizer.apply_updates(
            params, state.opt_state, [p.grad for p in params], lr, mult)
        state.step += 1
        return state, {"loss": loss_sum / n_accum, "iou": iou_sum / n_accum}

    return step


def make_eval_step(model, loss_fn: Callable, num_classes: int,
                   preprocess: Callable | None = None, device=None):
    """Returns ``eval_step(state, images, masks) -> metrics``: loss, macro
    IoU and the per-class tp/fp/fn summed over the batch (for streaming
    aggregation); eval-mode BN."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(state, images, masks):
        model.eval()
        logits = model(_prepare(images, dev, preprocess))
        msk = masks.to(dev, non_blocking=True)
        tp, fp, fn, tn = segmentation_stats(logits.argmax(-1), msk, num_classes)
        tpc, fpc, fnc, tnc = tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0)
        return {"loss": loss_fn(logits, msk),
                "iou": _macro_iou(tpc, fpc, fnc, tnc),
                "tp": tpc, "fp": fpc, "fn": fnc}

    return step
