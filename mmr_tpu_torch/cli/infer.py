"""``mmr_torch_infer`` — Path B's inference CLI (counterpart of
``mmr_tpu/cli/infer.py``; the reference's
``MMR_Segmentation/model_inference.py``), on one device.

Positional: ``test_dataset_path results_path``; ``--device`` (default
``cuda``; ``cpu`` to run there); other overrides restricted to the
inference allow-list (``model_inference.py:78-93``). The model is the
run's ``best_model``. Mode detection (``:169-194``): when the test
dataset path is the training dataset path, the saved test split is used;
otherwise every ``*.zarr`` under the path is a new dataset. Writes
``<results_path>/inference_report.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from mmr_tpu_torch.config import check_and_convert_user_config_args, get_config
from mmr_tpu_torch.core.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="MMR-TPU sliding-window inference (PyTorch port)")
    parser.add_argument("test_dataset_path", type=str)
    parser.add_argument("results_path", type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args, unknown = parser.parse_known_args(argv)
    dev = resolve_device(args.device)
    config_args = check_and_convert_user_config_args(unknown, "testing")
    config = get_config(args.test_dataset_path, args.results_path, "testing",
                        config_args=config_args)

    from mmr_tpu_torch.data.splits import get_data_ids
    from mmr_tpu_torch.data.video_dataset import VideoFrameDataset
    from mmr_tpu_torch.data.zarr_io import list_dataset_stores
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.train.engine import Trainer

    trainer = Trainer(config, device=dev)
    trainer.init_state()
    trainer.state, meta = trainer.checkpoints.load(trainer.state, "best_model")
    print(f"Loaded best model from epoch {meta['epoch']} "
          f"(val loss {meta['validation_loss']:.4f})")

    test_path = Path(args.test_dataset_path)
    train_path = Path(config.get("dataset_path", ""))
    if test_path.resolve() == train_path.resolve() and (
            test_path / "train_val_test_split.json").exists():
        ids = get_data_ids(test_path, "train-val-test", "test")
        stores = [test_path / "data" / f"{i}.zarr" for i in ids]
        print(f"Using saved test split: {len(stores)} videos")
    else:
        stores = list_dataset_stores(test_path)
        print(f"New dataset: {len(stores)} videos")

    dataset = VideoFrameDataset(stores, int(config.get("infer_batch_size", 6)))
    report = run_inference(trainer.model, dataset, config,
                           preprocess=trainer.preprocess, device=dev)
    out = Path(args.results_path) / "inference_report.json"
    out.write_text(json.dumps(report, indent=2))
    print(f"Report written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
