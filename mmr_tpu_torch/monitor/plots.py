"""Plot files of a Path-A run, counterpart of ``mmr_tpu/monitor/plots.py``
(``save_losses``, ``save_accuracy_curves``, ``save_triptychs``), drawn
with numpy into RGB arrays and written by :mod:`mmr_tpu_torch.data.png`.

Pixel equality with matplotlib is not a goal. A curve plot is a raster
line plot: white ground, the plot box, each series a line with a 5×5
square at each point (series in the order given, matplotlib's first two
colours). Its ``tEXt`` chunk ``plot`` holds, as JSON, the series, the
plot box (left, top, width, height in pixels) and the y range, so a
reader gets the numbers back and finds each point at
:func:`point_pixel`. A triptych has one row per sample: the image, the
mask and the prediction, the two id maps coloured by the class key,
``GAP`` white pixels between panels.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import png
from mmr_tpu_torch.data.classes import sarrarp50_key

CANVAS = (400, 640)              # height, width of a curve plot
BOX = (48, 20, 572, 340)         # plot box: left, top, width, height
COLOURS = [(31, 119, 180), (255, 127, 14)]
GAP = 4


def point_pixel(x: float, y: float, xr: tuple[float, float],
                yr: tuple[float, float], log: bool = False) -> tuple[int, int]:
    """(row, column) of the point (x, y) in a curve plot whose axes span
    ``xr`` and ``yr`` (``yr`` in log10 when ``log``)."""
    left, top, w, h = BOX
    if log:
        y = float(np.log10(y))
    fx = 0.5 if xr[1] == xr[0] else (x - xr[0]) / (xr[1] - xr[0])
    fy = 0.5 if yr[1] == yr[0] else (y - yr[0]) / (yr[1] - yr[0])
    return (top + int(round((1.0 - fy) * (h - 1))),
            left + int(round(fx * (w - 1))))


def _line(img, p0, p1, colour):
    n = max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) + 1
    rows = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    cols = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    img[rows, cols] = colour


def _curves(out: Path, xs, series: dict[str, list[float]], ylabel: str,
            log: bool = False) -> Path:
    xs = [float(x) for x in xs]
    series = {k: [float(v) for v in vals] for k, vals in series.items() if vals}
    ys = [np.log10(v) if log else v for vals in series.values() for v in vals]
    xr = (min(xs), max(xs)) if xs else (0.0, 1.0)
    yr = (float(min(ys)), float(max(ys))) if ys else (0.0, 1.0)
    img = np.full((*CANVAS, 3), 255, np.uint8)
    left, top, w, h = BOX
    img[top - 1, left - 1:left + w + 1] = img[top + h, left - 1:left + w + 1] = 0
    img[top - 1:top + h + 1, left - 1] = img[top - 1:top + h + 1, left + w] = 0
    pts = {k: [point_pixel(x, y, xr, yr, log) for x, y in zip(xs, vals)]
           for k, vals in series.items()}
    for (k, ps), colour in zip(pts.items(), COLOURS):
        for a, b in zip(ps, ps[1:]):
            _line(img, a, b, colour)
    for (k, ps), colour in zip(pts.items(), COLOURS):
        for r, c in ps:
            img[r - 2:r + 3, c - 2:c + 3] = colour
    meta = {"x": xs, "series": series, "ylabel": ylabel, "box": list(BOX),
            "x_range": list(xr), "y_range": list(yr), "log": log}
    return png.write(out, img, {"plot": json.dumps(meta)})


def save_losses(train_losses, val_losses, out_dir: str | Path,
                loss_name: str = "DiceCELoss", log_scale: bool = False) -> Path:
    """``<out_dir>/loss.png``: train and validation loss by epoch."""
    series = {f"Train {loss_name}": list(train_losses)}
    if val_losses:
        series[f"Val {loss_name}"] = list(val_losses)[:len(train_losses)]
    xs = np.arange(1, len(train_losses) + 1)
    return _curves(Path(out_dir) / "loss.png", xs, series, loss_name, log_scale)


def save_accuracy_curves(history: dict, out_dir: str | Path) -> Path:
    """``<out_dir>/accuracy.png``: train and validation IoU by epoch
    (``ModelTraining.py:500-523``)."""
    series = {label: history.get(key, []) for key, label in
              (("train_iou", "Train IoU"), ("val_iou", "Val IoU"))}
    return _curves(Path(out_dir) / "accuracy.png", history.get("epoch", []),
                   series, "IoU")


def save_triptychs(images, masks, preds, out_path: str | Path,
                   max_samples: int = 4, key: np.ndarray | None = None) -> Path:
    """[image | ground truth | prediction] rows (``save_plots`` /
    ``displaySamples``). ``images`` (N, H, W, 3) in [0, 1]; ``masks`` and
    ``preds`` (N, H, W) int ids, coloured by ``key`` ((C, 3) uint8, the
    SAR-RARP50 key by default; ids beyond it take its last colour)."""
    key = sarrarp50_key() if key is None else np.asarray(key, np.uint8)
    images = np.asarray(images, np.float32)
    n = min(len(images), max_samples)
    h, w = images.shape[1:3]
    img = np.full((n * h + (n - 1) * GAP, 3 * w + 2 * GAP, 3), 255, np.uint8)
    colour = lambda ids: key[np.clip(np.asarray(ids), 0, len(key) - 1)]
    for i in range(n):
        r = i * (h + GAP)
        panels = (np.floor(np.clip(images[i], 0, 1) * 255 + 0.5).astype(np.uint8),
                  colour(masks[i]), colour(preds[i]))
        for j, p in enumerate(panels):
            img[r:r + h, j * (w + GAP):j * (w + GAP) + w] = p
    meta = {"rows": n, "panels": ["input", "ground truth", "prediction"], "gap": GAP}
    return png.write(out_path, img, {"triptych": json.dumps(meta)})
