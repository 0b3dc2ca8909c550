"""Path-A argparse trainer — the ``ModelTraining.py`` surface, counterpart
of ``mmr_tpu/cli/train_path_a.py``, on one device or data-parallel under
``torchrun --nproc_per_node N`` (one card a rank over NCCL; with ``--device
cpu`` gloo ranks on the CPU), its steps on the mesh as JAX builds them
(``train_path_a.py:109-125``): each rank takes its slice of every train
and validation batch (the batch sizes are global, multiples of N), the
validation's counts and the heavy metrics are summed over the ranks, and
rank 0 alone writes the log, checkpoints, curves and triptychs.

The same flags (``ModelTraining.py:59-133``; canonical values in
``ConfigModelUnetPlus/train_sarrarp50.sh:4-28``) plus ``--device`` (default
``cuda``; ``cpu`` to run there, and nothing falls back to it): model zoo
strings (``segnet | unet | resnet18 | resnet34 | smp_UNet++ | smp_unet18 |
smp_DeepLabV3+ | smp_MANet``), CE + Dice blended loss
(``--dice_loss_factor``), Adam / AdamW / SGD / RMSprop
(+ ``--differential_lr``), StepLR (``--lr_steps``, ``--step_gamma``),
best-F1 checkpoints, heavy metrics (binary dice + Hausdorff) at epoch 1
and every ``--heavy_metric_interval``-th (``ModelTraining.py:420-444,
622-654``), loss / accuracy curve PNGs and last-epoch sample triptychs.
Training batches are augmented on the device (the Path-A augmentation,
draws from a generator per (epoch, step) of ``--seed``); the validation's
losses and confusion counts stay on the device until the epoch ends.

Example:
    python -m mmr_tpu_torch.cli.train_path_a --data_dir <root> \\
        --model smp_UNet++ --epochs 20 --trainBatchSize 8 --lr 1e-3 \\
        --optimizer Adam --wd 1e-5 --dice_loss_factor 0.5 \\
        --resizedHeight 256 --resizedWidth 256 --save_dir runs/a
On two cards: ``torchrun --nproc_per_node 2 -m mmr_tpu_torch.cli.train_path_a
...`` with the same flags.
"""

from __future__ import annotations

import argparse
import functools
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from mmr_tpu_torch.core.mesh import (broadcast_module, host_shard, launch_mesh,
                                    psum_if_sharded)
from mmr_tpu_torch.core.prng import RngStream, seed_everything
from mmr_tpu_torch.data.augment import augment_path_a_batch
from mmr_tpu_torch.data.classes import load_class_json, sarrarp50_key, sarrarp50_names
from mmr_tpu_torch.data.png_dataset import PngFolderDataset
from mmr_tpu_torch.losses import blended_ce_dice_loss
from mmr_tpu_torch.metrics.dice import binary_dice
from mmr_tpu_torch.metrics.evaluate import Evaluate
from mmr_tpu_torch.metrics.hausdorff import capped_hausdorff
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.monitor import (get_logger, save_accuracy_curves, save_losses,
                                   save_triptychs)
from mmr_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint_path
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.schedules import step_lr
from mmr_tpu_torch.train.state import TrainState
from mmr_tpu_torch.train.steps import make_eval_step, make_train_step

HEADS = ("outc", "conv_last", "head", "dec5")   # re-initialised on --resume


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MMR-TPU Path-A trainer (PyTorch port)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--json_path", type=str, default="",
                   help="class-definition JSON (defaults to built-in sarrarp50)")
    p.add_argument("--dataset", type=str, default="sarrarp50")
    p.add_argument("--model", type=str, default="segnet")
    p.add_argument("--batchnorm_momentum", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--start-epoch", dest="start_epoch", type=int, default=0)
    p.add_argument("--trainBatchSize", type=int, default=8)
    p.add_argument("--valBatchSize", type=int, default=4)
    p.add_argument("--lr", "--learning-rate", type=float, default=1e-3)
    p.add_argument("--optimizer", type=str, default="Adam")
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--dice_loss_factor", type=float, default=0.5)
    p.add_argument("--lr_steps", type=int, default=2)
    p.add_argument("--step_gamma", type=float, default=0.1)
    p.add_argument("--resnetModel", type=int, default=18)
    p.add_argument("--differential_lr", type=str, default="False")
    p.add_argument("--resizedHeight", type=int, default=256)
    p.add_argument("--resizedWidth", type=int, default=256)
    p.add_argument("--cropSize", type=int, default=256)
    p.add_argument("--display_samples", type=str, default="False")
    p.add_argument("--save_samples", type=str, default="True")
    p.add_argument("--full_res_validation", type=str, default="False")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--save_dir", type=str, default="save_temp")
    p.add_argument("--seed", type=int, default=6210)
    p.add_argument("--heavy_metric_interval", type=int, default=25)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process group under torchrun: nccl (one card a rank; "
                        "the default on cuda) or gloo (the CPU's; on cuda it "
                        "lets ranks share a card)")
    return p.parse_args(argv)


def strbool(s) -> bool:
    return str(s).lower() in ("true", "1", "yes")


def arch_of(args) -> str:
    return (args.model if args.model.lower() not in ("resnet18", "resnet34")
            else f"resnet{args.resnetModel}")


def class_key(json_path: str):
    """(colour key, names): from ``json_path``, else SAR-RARP50's."""
    if json_path:
        return load_class_json(json_path)
    return sarrarp50_key(), sarrarp50_names()


def _predict(model, imgs: np.ndarray, dev) -> np.ndarray:
    """Eval-mode argmax ids of an (N, H, W, 3) batch, on the host."""
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(imgs).to(dev)).argmax(-1).cpu().numpy()


def _silent_logger() -> logging.Logger:
    """The logger of a rank other than 0: it writes nothing."""
    logger = logging.getLogger("mmr_tpu_torch.train_path_a.silent")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def _rank_sums(mesh, *values) -> list[float]:
    """Host numbers summed over the mesh's ranks."""
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    return psum_if_sharded(t, mesh).tolist()


def main(argv=None):
    args = parse_args(argv)
    mesh = launch_mesh(args.device, args.backend)
    dev, main_rank = mesh.device, mesh.rank == 0
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    logger = get_logger(save_dir) if main_rank else _silent_logger()
    rng = RngStream(seed_everything(args.seed))

    key, names = class_key(args.json_path)
    num_classes = len(key)
    logger.info(f"{num_classes} classes: {names}")

    hw = (args.resizedHeight, args.resizedWidth)
    train_ds = PngFolderDataset(args.data_dir, "train", hw, args.cropSize, num_classes)
    val_split = "val" if (Path(args.data_dir) / "val").is_dir() else "test"
    val_ds = PngFolderDataset(args.data_dir, val_split, hw, args.cropSize, num_classes,
                              full_res=strbool(args.full_res_validation))
    logger.info(f"train {len(train_ds)} images, {val_split} {len(val_ds)} images")

    arch = arch_of(args)
    model = create_model(arch, classes=num_classes, device=dev,
                         generator=rng.named("init"))
    optimizer = build_optimizer(
        args.optimizer, differential_lr=strbool(args.differential_lr),
        weight_decay=args.wd,
        momentum=0.9 if args.optimizer.lower() == "sgd" else 0.0)
    state = TrainState.create(model, optimizer)
    sched = step_lr(args.lr, args.epochs, args.lr_steps, args.step_gamma)
    loss_fn = functools.partial(blended_ce_dice_loss,
                                dice_loss_factor=args.dice_loss_factor)
    train_step = make_train_step(model, optimizer, loss_fn, num_classes,
                                 augment=augment_path_a_batch, mesh=mesh)
    eval_step = make_eval_step(model, loss_fn, num_classes, mesh=mesh)
    ckpts = CheckpointManager(save_dir / "checkpoints")

    if args.resume:
        # Path-A resume (ModelTraining.py:308-337): --resume is a checkpoint
        # path, possibly of another run; weights load tolerantly, the head
        # keeps a fresh init, and start_epoch takes the checkpoint's epoch
        # unless --start-epoch was given
        try:
            state, meta = load_checkpoint_path(args.resume, state)
        except FileNotFoundError:
            print(f"=> no checkpoint found at '{args.resume}'")
            meta = None
        if meta is not None:
            logger.info(f"=> loaded checkpoint '{args.resume}' "
                        f"(epoch {meta.get('epoch', '?')})")
            if meta.get("skipped"):
                logger.info(f"   skipped {len(meta['skipped'])} non-matching "
                            f"entries: {meta['skipped'][:5]}...")
            if args.start_epoch == 0 and meta.get("epoch"):
                args.start_epoch = int(meta["epoch"])
            fresh = create_model(arch, classes=num_classes, device=dev,
                                 generator=rng.named("reinit"))
            for head in HEADS:
                if hasattr(model, head):
                    getattr(model, head).load_state_dict(
                        getattr(fresh, head).state_dict())
                    logger.info(f"re-initialized head {head!r} for resume")
            del fresh
    broadcast_module(mesh, model)   # the ranks start from rank 0's weights

    history = {"epoch": [], "train_loss": [], "val_loss": [],
               "train_iou": [], "val_iou": []}
    for epoch in range(args.start_epoch + 1, args.epochs + 1):
        lr = sched(epoch - 1)
        tr_losses, tr_ious = [], []
        for i, (imgs, masks) in enumerate(
                train_ds.epoch(args.trainBatchSize, seed=args.seed + epoch)):
            b_img, b_msk = host_shard(mesh, (imgs[None], masks[None]), axis=1)
            state, met = train_step(state, torch.from_numpy(b_img),
                                    torch.from_numpy(b_msk), lr,
                                    rng.step("train", epoch, i, device=dev))
            tr_losses.append(met["loss"])
            tr_ious.append(met["iou"])

        ev = Evaluate(num_classes)
        va_losses, counts, last_batch = [], None, None
        for imgs, masks in val_ds.epoch(args.valBatchSize, shuffle=False):
            b_img, b_msk = host_shard(mesh, (imgs, masks))
            met = eval_step(state, torch.from_numpy(b_img), torch.from_numpy(b_msk))
            va_losses.append(met["loss"])
            stats = torch.stack([met["tp"], met["fp"], met["fn"]])
            counts = stats if counts is None else counts + stats
            last_batch = (imgs, masks)
        if counts is not None:   # read once an epoch
            host = counts.double().cpu().numpy()
            ev.tp += host[0]
            ev.fp += host[1]
            ev.fn += host[2]

        per_class_iou, miou = ev.iou()
        mean_f1 = ev.mean_f1()
        mean = lambda xs: float(np.mean(torch.stack(xs).double().cpu().numpy()))
        tl, vl = mean(tr_losses), mean(va_losses) if va_losses else float("nan")
        history["epoch"].append(epoch)
        history["train_loss"].append(tl)
        history["val_loss"].append(vl)
        history["train_iou"].append(mean(tr_ious))
        history["val_iou"].append(miou)
        logger.info(f"epoch {epoch}/{args.epochs} lr {lr:.2e} "
                    f"train loss {tl:.4f} val loss {vl:.4f} "
                    f"mIoU {miou:.4f} mF1 {mean_f1:.4f}")

        # heavy metrics at epoch 1 and every interval-th
        # (ModelTraining.py:420-444,622-654): dice over the joint one-hot
        # stack of all classes and the per-class Hausdorff distances (∞ →
        # 1000) summed per image, over the validation set, on the host
        if epoch == 1 or epoch % args.heavy_metric_interval == 0:
            tot_dice, tot_haus, n_img = 0.0, 0.0, 0
            eye = np.eye(num_classes, dtype=bool)
            for imgs, masks in val_ds.epoch(args.valBatchSize, shuffle=False):
                imgs, masks = host_shard(mesh, (imgs, masks))
                for p, m in zip(_predict(model, imgs, dev), masks):
                    tot_dice += float(binary_dice(eye[p], eye[m]))
                    tot_haus += sum(capped_hausdorff(p == c, m == c)
                                    for c in range(num_classes))
                    n_img += 1
            tot_dice, tot_haus, n_img = _rank_sums(mesh, tot_dice, tot_haus, n_img)
            n_img = int(n_img)
            logger.info(
                f"  heavy metrics over {n_img} val images: "
                f"mean dice {tot_dice / max(n_img, 1):.4f} "
                f"mean hausdorff {tot_haus / max(n_img, 1):.1f}")

        if main_rank and ckpts.save_best_by_f1(state, epoch, mean_f1):
            logger.info(f"  new best mean F1 {mean_f1:.4f} — checkpointed")

        if (main_rank and epoch == args.epochs and strbool(args.save_samples)
                and last_batch is not None):
            imgs, masks = last_batch
            save_triptychs(imgs, masks, _predict(model, imgs, dev),
                           save_dir / f"epoch_{epoch}_samples.png", key=key)
        mesh.barrier()

    if main_rank:
        save_losses(history["train_loss"], history["val_loss"], save_dir,
                    loss_name="CE+Dice")
        save_accuracy_curves(history, save_dir)
    logger.info("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
