"""Evaluation entry points, counterparts of ``mmr_tpu/infer/evaluator.py``:

- :func:`run_inference` (the reference's ``SegModel.run_inference``,
  ``Main_MMR_SegModel.py:1205-1367``): sliding-window prediction over
  whole-video frame batches, per-video FPS, and per-frame per-class IoU
  with the background dropped by the ``preds-1 / masks-1 /
  ignore_index=-1`` shift; with ``save_plots`` a numbered
  ``test_plots_<i>`` directory holding the run's ``config.yaml``
  (``:1249-1256``) and one triptych per video;
- :func:`evaluate_checkpoint` (Path A's standalone evaluation): whole-image
  eval forwards and the streaming :class:`~mmr_tpu_torch.metrics.Evaluate`
  metrics.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from mmr_tpu_torch.config.config import create_config
from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.infer.sliding_window import make_sliding_window_fn
from mmr_tpu_torch.metrics.confusion import segmentation_stats
from mmr_tpu_torch.metrics.evaluate import Evaluate
from mmr_tpu_torch.metrics.iou import iou_score
from mmr_tpu_torch.monitor.plots import save_triptychs


def _next_test_plots_dir(results_path: Path) -> Path:
    i = 0
    while (results_path / f"test_plots_{i}").exists():
        i += 1
    out = results_path / f"test_plots_{i}"
    out.mkdir(parents=True)
    return out


def _report(per_frame_iou: np.ndarray, indent: str) -> float:
    mean_per_class = per_frame_iou.mean(axis=0)
    parts = [f"C{i + 1}: {v * 100:.2f}" for i, v in enumerate(mean_per_class)]
    parts.append(f"AVG: {mean_per_class.mean() * 100:.2f}")
    print(f"{indent}IoU scores per class: ")
    print(f"{indent}    " + " - ".join(parts))
    return float(mean_per_class.mean())


def run_inference(model, dataset, config: dict, preprocess=None,
                  save_plots: bool = True, device=None) -> dict:
    """Predict every item of ``dataset`` (an iterable of ``{"id", "t0",
    "t1", "image" (T, H, W, 3), "mask" (T, H, W)}`` frame chunks in video
    order, with ``infer_batch_size``) and report per-video FPS and IoU.

    ``config``: ``n_classes`` (without background), ``patch_size`` (the
    roi), optional ``sw_batch_size``, ``sw_overlap``, ``sw_chunked`` (chunked
    window stream instead of the per-frame fused blend), ``sw_fp32_blend``
    (f32 window logits instead of bf16); with ``save_plots``,
    ``results_path``: the run writes ``config`` as
    ``<results_path>/test_plots_<i>/config.yaml`` (the first free ``i``)
    and, per video, the triptych of its first frame chunk as
    ``<id>_<t0>-<t1>.png`` there. Returns ``{"overall_mean_iou",
    "per_class_iou", "videos": {id: {"fps", "mean_iou"}}, "total_time_s"}``.
    """
    if save_plots and "results_path" not in config:
        raise KeyError("save_plots writes under config['results_path'], "
                       "which the config lacks; add it or pass save_plots=False")
    dev = resolve_device(device)
    n_classes = int(config["n_classes"])
    plot_dir = _next_test_plots_dir(Path(config["results_path"])) if save_plots else None
    if plot_dir is not None:
        create_config(config, plot_dir)
    sw = make_sliding_window_fn(
        model, config["patch_size"], n_classes + 1,
        sw_batch_size=int(config.get("sw_batch_size", 24)),
        overlap=float(config.get("sw_overlap", 0.5)),
        preprocess=preprocess,
        compute_dtype=(torch.float32 if config.get("sw_fp32_blend")
                       else torch.bfloat16),
        fuse_blend=not config.get("sw_chunked"), device=dev)

    all_iou, video_stats = [], {}
    current: list[np.ndarray] = []
    seen: list[str] = []
    video_start = start = time.time()
    n_frames = 0
    plot_item = None

    def flush_video(name: str):
        nonlocal current, video_start, n_frames, plot_item
        dt = time.time() - video_start
        fps = n_frames / dt if dt > 0 else 0.0
        print(f"    Inference time: {time.strftime('%H:%M:%S', time.gmtime(dt))}"
              f" ({fps:.2f} fps)")
        vid_iou = np.concatenate(current, axis=0)
        all_iou.append(vid_iou)
        video_stats[name] = {"fps": fps, "mean_iou": _report(vid_iou, "        ")}
        if plot_item is not None:
            save_triptychs(*plot_item[:3], plot_dir / f"{plot_item[3]}.png")
        current, n_frames, plot_item = [], 0, None
        video_start = time.time()

    with torch.inference_mode():
        for item in dataset:
            name = item["id"]
            if not seen or name != seen[-1]:
                if seen:
                    flush_video(seen[-1])
                seen.append(name)
                print(f"Processing video: {name}")
            logits = sw(item["image"])
            masks = torch.as_tensor(np.asarray(item["mask"], np.int64)).to(dev)
            preds = logits.argmax(dim=-1)
            tp, fp, fn, tn = segmentation_stats(preds - 1, masks - 1, n_classes,
                                                ignore_index=-1)
            current.append(iou_score(tp, fp, fn, tn).cpu().numpy())
            n_frames += preds.shape[0]
            if plot_dir is not None and plot_item is None:
                img = np.asarray(item["image"])
                plot_item = (img.astype(np.float32) / (255.0 if img.dtype == np.uint8
                                                       else 1.0),
                             np.asarray(item["mask"]).astype(np.int32),
                             preds.cpu().numpy(), f"{name}_{item['t0']}-{item['t1']}")
        if seen:
            flush_video(seen[-1])

    total = time.time() - start
    print(f"\nTotal inference time: {time.strftime('%H:%M:%S', time.gmtime(total))}")
    overall = (np.concatenate(all_iou, axis=0) if all_iou
               else np.zeros((0, n_classes)))
    print("Overall IoU scores per class: ")
    overall_mean = _report(overall, "") if len(overall) else 0.0
    return {
        "overall_mean_iou": overall_mean,
        "per_class_iou": overall.mean(axis=0).tolist() if len(overall) else [],
        "videos": video_stats,
        "total_time_s": total,
    }


def evaluate_checkpoint(model, batches, num_classes: int, loss_fn=None,
                        preprocess=None, device=None) -> dict:
    """Path-A standalone evaluation of ``model`` (which holds the weights of
    the checkpoint): whole-image eval-mode forwards and streaming metrics.

    ``batches``: iterable of (images NHWC f32, masks NHW int), tensors or
    numpy arrays, moved to ``device`` (``None``: CUDA). The losses and the
    confusion counts stay on the device until the last batch and are read
    back once. Prints the class-wise IoU, precision, recall and F1 and
    returns ``{"loss" (mean of ``loss_fn`` over the batches, in f64 of
    their f32 values, or None), "iou_per_class", "mean_iou", "precision",
    "recall", "f1", "mean_f1"}``."""
    dev = resolve_device(device)
    ev = Evaluate(num_classes)
    losses = []
    model.eval()
    with torch.inference_mode():
        for images, masks in batches:
            imgs = torch.as_tensor(images).to(dev)
            msk = torch.as_tensor(masks).to(dev)
            if preprocess is not None:
                imgs = preprocess(imgs)
            logits = model(imgs)
            if loss_fn is not None:
                losses.append(loss_fn(logits, msk))
            ev.add_batch(logits, msk)
    losses = torch.stack(losses).double().cpu().numpy() if losses else []
    per_class_iou, miou = ev.iou()
    p, r, f1 = ev.precision_recall_f1()
    print("Class-wise metrics:")
    for c in range(num_classes):
        print(f"  class {c}: IoU {per_class_iou[c]:.4f} P {p[c]:.4f} "
              f"R {r[c]:.4f} F1 {f1[c]:.4f}")
    print(f"Mean IoU: {miou:.4f}  Mean F1: {float(f1.mean()):.4f}")
    return {
        "loss": float(np.mean(losses)) if len(losses) else None,
        "iou_per_class": per_class_iou.tolist(),
        "mean_iou": miou,
        "precision": p.tolist(),
        "recall": r.tolist(),
        "f1": f1.tolist(),
        "mean_f1": float(f1.mean()),
    }
