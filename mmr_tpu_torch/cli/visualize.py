"""``mmr_torch_visualize`` — the prediction visualizer (counterpart of
``mmr_tpu/cli/visualize.py``): per-frame sliding-window prediction over a
video store (the notebooks' ``CustomVisualizer``, overlap 0.25) written
as [image | ground truth | prediction] triptychs
(``MMR_Seg_Unet/Visualization_Segment_Prediction.py``), on one device.

``--legend`` writes ``class_legend.png`` (a bar a class in matplotlib's
``hot`` colours, labelled ``"{i}: {name}"``), ``--architecture`` prints
``model_summary`` and writes ``architecture_diagram.png`` (JAX's six boxes
and five arrows with the parameter count), both drawn by
:mod:`mmr_tpu_torch.monitor.plots` with its bitmap font. A compact
store's uint8 frames are shown divided by 255.

Usage:
    python -m mmr_tpu_torch.cli.visualize <results_path> <zarr_store_or_dataset> \\
        [--frames 0 5 10] [--overlap 0.25] [--legend] [--architecture] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mmr_tpu_torch.core.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="MMR-TPU prediction visualizer (PyTorch port)")
    p.add_argument("results_path", type=str,
                   help="training results dir (config.yaml + checkpoints)")
    p.add_argument("data_path", type=str, help="a .zarr store or a dataset dir")
    p.add_argument("--frames", type=int, nargs="*", default=[0])
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--which", type=str, default="best_model")
    p.add_argument("--legend", action="store_true",
                   help="also write class_legend.png, the class colours")
    p.add_argument("--architecture", action="store_true",
                   help="also print the layer summary and write "
                        "architecture_diagram.png")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    import numpy as np

    from mmr_tpu_torch.config import read_config
    from mmr_tpu_torch.data.video_dataset import VideoFrameDataset
    from mmr_tpu_torch.data.zarr_io import list_dataset_stores
    from mmr_tpu_torch.infer.sliding_window import make_sliding_window_fn
    from mmr_tpu_torch.data.classes import sarrarp50_names
    from mmr_tpu_torch.monitor import model_summary
    from mmr_tpu_torch.monitor.plots import (save_architecture_diagram,
                                             save_class_legend, save_triptychs)
    from mmr_tpu_torch.train.engine import Trainer

    results = Path(args.results_path)
    config = read_config(results / "config.yaml")
    config["results_path"] = str(results)
    trainer = Trainer(config, device=dev)
    trainer.init_state()
    trainer.state, meta = trainer.checkpoints.load(trainer.state, args.which)
    print(f"Loaded {args.which} (epoch {meta['epoch']})")

    data = Path(args.data_path)
    stores = [data] if data.suffix == ".zarr" else list_dataset_stores(data)
    vd = VideoFrameDataset(stores[:1], infer_batch_size=1)
    sw = make_sliding_window_fn(
        trainer.model, config["patch_size"], trainer.n_classes,
        sw_batch_size=int(config.get("sw_batch_size", 24)),
        overlap=args.overlap, preprocess=trainer.preprocess, device=dev)

    out_dir = Path(args.out) if args.out else results / "visualizations"
    out_dir.mkdir(parents=True, exist_ok=True)
    imgs, gts, preds = [], [], []
    for t in args.frames:
        item = vd[min(t, len(vd) - 1)]
        img = item["image"][0]
        imgs.append(img / 255.0 if img.dtype == np.uint8 else img)
        gts.append(item["mask"][0])
        preds.append(sw(item["image"]).argmax(-1)[0].cpu().numpy())
    out = save_triptychs(np.stack(imgs), np.stack(gts), np.stack(preds),
                         out_dir / "prediction_triptychs.png",
                         max_samples=len(imgs))
    print(f"Wrote {out}")

    if args.legend:
        out = save_class_legend(sarrarp50_names()[:trainer.n_classes], out_dir)
        print(f"Wrote {out}")
    if args.architecture:
        model = trainer.model
        print("Model Architecture Summary:")
        print("=" * 50)
        print(model_summary(model))
        out = save_architecture_diagram(
            type(model).__name__, getattr(model, "encoder_name", None),
            trainer.n_classes, sum(p.numel() for p in model.parameters()), out_dir)
        print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
