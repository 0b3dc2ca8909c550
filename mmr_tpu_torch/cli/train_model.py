"""``mmr_torch_train_model`` — Path B's training CLI (counterpart of
``mmr_tpu/cli/train_model.py``; the reference's
``MMR_Segmentation/MMR_Model_Training.py``), on one device, or data-parallel
under ``torchrun --nproc_per_node N`` (one card a rank over NCCL; with
``--device cpu`` gloo ranks on the CPU). Rank 0 writes the split file,
``config.yaml`` and every output, and hands the config to the others.

Positional: ``dataset_path results_path splitting n_classes patch_size``;
flags ``-f/--fold``, ``-p/--progress_bar``, ``-c/--continue_training``
(resume from ``last_model``) and ``--device`` (default ``cuda``; ``cpu``
to run there, and nothing falls back to it); any remaining ``--key
value`` pairs go through the config override grammar
(``MMR_Model_Training.py:69-136``).

Example (the notebook's smoke run, How_To-Run...ipynb cell 9):
    python -m mmr_tpu_torch.cli.train_model <ds> <res> train-val-test 9 \\
        "[512,640]" -p --batch_size 2 --grad_accumulate_step 4 --n_epochs 2
On two cards (``--batch_size`` is the global batch, a multiple of 2):
    torchrun --nproc_per_node 2 -m mmr_tpu_torch.cli.train_model <ds> <res> \\
        train-val-test 9 "[512,640]" --batch_size 8
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mmr_tpu_torch.config import (check_and_convert_user_config_args, get_config,
                                  safe_eval)
from mmr_tpu_torch.core.mesh import broadcast_object, launch_mesh


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MMR-TPU model training (PyTorch port)")
    parser.add_argument("dataset_path", type=str)
    parser.add_argument("results_path", type=str)
    parser.add_argument("splitting", type=str,
                        choices=["train-val-test", "5-fold"])
    parser.add_argument("n_classes", type=int,
                        help="number of foreground classes (background added)")
    parser.add_argument("patch_size", type=str, help='e.g. "[512,640]"')
    parser.add_argument("-f", "--fold", type=int, default=None)
    parser.add_argument("-p", "--progress_bar", action="store_true")
    parser.add_argument("-c", "--continue_training", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="process group under torchrun: nccl (one card a rank; "
                             "the default on cuda) or gloo (the CPU's; on cuda it "
                             "lets ranks share a card)")
    args, unknown = parser.parse_known_args(argv)

    if args.splitting == "5-fold" and args.fold is None:
        parser.error("--fold is required when splitting is '5-fold'")
    if args.splitting != "5-fold" and args.fold is not None:
        parser.error("--fold is only valid with 5-fold splitting")
    results = Path(args.results_path)
    if results.exists() and any(results.iterdir()) and not args.continue_training:
        parser.error(
            f"results path {results} already exists; pass -c to continue training")
    return args, unknown


def main(argv=None):
    args, unknown = parse_args(argv)
    mesh = launch_mesh(args.device, args.backend)
    mesh.barrier()   # every rank has checked the results path before any write
    mode = "continue_training" if args.continue_training else "training"
    config_args = check_and_convert_user_config_args(unknown, "training")
    patch_size = safe_eval(args.patch_size)

    # the model's modules after the arguments are checked (a fast --help)
    from mmr_tpu_torch.data.patch_dataset import PatchSampler
    from mmr_tpu_torch.data.splits import create_split_files, get_data_ids
    from mmr_tpu_torch.train.engine import Trainer

    config = None
    if mesh.rank == 0:
        config = get_config(args.dataset_path, args.results_path, mode,
                            config_args=config_args, n_classes=args.n_classes,
                            patch_size=patch_size, progress_bar=args.progress_bar)
        config.setdefault("patch_size", list(patch_size))
        config["dataset_path"] = args.dataset_path
        create_split_files(args.dataset_path, args.splitting)
    config = broadcast_object(mesh, config)
    data_dir = Path(args.dataset_path) / "data"
    trainer = Trainer(config, mesh=mesh)

    aug_initial = trainer.augment.initial_patch_size
    train_ids = get_data_ids(args.dataset_path, args.splitting, "train", args.fold)
    val_ids = get_data_ids(args.dataset_path, args.splitting, "val", args.fold)
    train_sampler = PatchSampler(
        [data_dir / f"{i}.zarr" for i in train_ids],
        tuple(config["patch_size"]), config["batch_size"],
        int(config.get("steps_per_epoch", 250)),
        oversample_foreground_percent=float(config.get("oversample_ratio", 0.33)),
        oversample_strategy=str(config.get("oversample_strategy", "deterministic")),
        initial_patch_size=aug_initial,
        seed=int(config.get("seed", 6210)))
    val_sampler = PatchSampler(
        [data_dir / f"{i}.zarr" for i in val_ids],
        tuple(config["patch_size"]), config["batch_size"],
        int(config.get("val_steps_per_epoch", 50)),
        oversample_foreground_percent=0.0,
        seed=int(config.get("seed", 6210)) + 1)

    if args.continue_training:
        trainer.maybe_resume()
    trainer.train(train_sampler, val_sampler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
