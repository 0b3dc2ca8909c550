"""Path-A standalone evaluator CLI — the ``ModelEval.py`` surface
(``ModelEval.py:52-89`` argparse; ``:363-458`` validate loop;
``:259-304`` class-wise printout), counterpart of
``mmr_tpu/cli/eval_path_a.py``: build the model on ``--device``, load a
checkpoint of :class:`~mmr_tpu_torch.train.checkpoint.CheckpointManager`
into it, run whole-image forwards over a PNG-folder split through
``evaluate_checkpoint`` (the confusion kernel K7 on every batch) and report
loss and per-class IoU / P / R / F1. With ``--save_dir`` it writes the
first batch's triptych, ``eval_samples.png``, and the report,
``eval_report.json``.

Example:
    python -m mmr_tpu_torch.cli.eval_path_a --data_dir <root> --split val \\
        --checkpoint_dir runs/a/checkpoints --save_dir runs/a/eval
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

from mmr_tpu_torch.cli.train_path_a import _predict, arch_of, class_key
from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.data.png_dataset import PngFolderDataset
from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
from mmr_tpu_torch.losses import blended_ce_dice_loss
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.monitor import save_triptychs
from mmr_tpu_torch.train.checkpoint import CheckpointManager
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.state import TrainState


def main(argv=None):
    p = argparse.ArgumentParser(
        description="MMR-TPU Path-A checkpoint evaluation (PyTorch port)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--json_path", type=str, default="")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--model", type=str, default="smp_UNet++")
    p.add_argument("--resnetModel", type=int, default=18)
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="directory holding the checkpoint (best_f1, ...)")
    p.add_argument("--which", type=str, default="best_f1")
    p.add_argument("--valBatchSize", type=int, default=4)
    p.add_argument("--resizedHeight", type=int, default=256)
    p.add_argument("--resizedWidth", type=int, default=256)
    p.add_argument("--dice_loss_factor", type=float, default=0.5)
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    key, _ = class_key(args.json_path)
    num_classes = len(key)
    hw = (args.resizedHeight, args.resizedWidth)
    ds = PngFolderDataset(args.data_dir, args.split, hw, -1, num_classes)
    model = create_model(arch_of(args), classes=num_classes, device=dev)
    state = TrainState.create(model, build_optimizer("adam"))
    state, meta = CheckpointManager(args.checkpoint_dir).load(
        state, args.which, weights_only=True)
    print(f"Loaded {args.which} checkpoint: {meta}")

    loss_fn = functools.partial(blended_ce_dice_loss,
                                dice_loss_factor=args.dice_loss_factor)
    report = evaluate_checkpoint(model, ds.epoch(args.valBatchSize, shuffle=False),
                                 num_classes, loss_fn=loss_fn, device=dev)

    if args.save_dir:
        out = Path(args.save_dir)
        imgs, masks = next(ds.epoch(args.valBatchSize, shuffle=False))
        save_triptychs(imgs, masks, _predict(model, imgs, dev),
                       out / "eval_samples.png", key=key)
        (out / "eval_report.json").write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
