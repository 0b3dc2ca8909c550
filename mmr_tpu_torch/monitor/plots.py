"""Plot files of a training run, counterpart of ``mmr_tpu/monitor/plots.py``
(``save_losses``, ``save_accuracy_curves``, ``save_dashboard``,
``save_triptychs``) and of the visualizer's ``--legend`` and
``--architecture`` (:func:`save_class_legend`,
:func:`save_architecture_diagram`; ``mmr_tpu/cli/visualize.py``), drawn
with numpy into RGB arrays and written by :mod:`mmr_tpu_torch.data.png`.
Text is drawn from :data:`FONT`, a 5×7 bitmap font of printable ASCII
written out below.

Pixel equality with matplotlib is not a goal. A curve plot is a raster
line plot: white ground, the plot box, each series a line with a 5×5
square at each point (series in the order given, matplotlib's first two
colours). Its ``tEXt`` chunk ``plot`` holds, as JSON, the series, the
plot box (left, top, width, height in pixels) and the y range, so a
reader gets the numbers back and finds each point at
:func:`point_pixel`. A triptych has one row per sample: the image, the
mask and the prediction, the two id maps coloured by the class key,
``GAP`` white pixels between panels. The legend and the diagram keep,
as JSON in a ``tEXt`` chunk, where each bar, box and arrow lies.
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


def _panel(xs, series: dict[str, list[float]], ylabel: str,
           log: bool = False) -> tuple[np.ndarray, dict]:
    """One curve plot: its RGB image and its ``plot`` metadata."""
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
    return img, meta


def _curves(out: Path, xs, series: dict[str, list[float]], ylabel: str,
            log: bool = False) -> Path:
    img, meta = _panel(xs, series, ylabel, log)
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


DASHBOARD = [  # title, [(history key, label)], log y
    ("Loss", [("train_loss", "train"), ("val_loss", "val")], False),
    ("IoU", [("train_iou", "train"), ("val_iou", "val")], False),
    ("Learning rate", [("lr", "lr")], True),
    ("Epoch time (s)", [("epoch_time_s", "time")], False),
    ("Device memory (MB)", [("device_mem_mb", "HBM")], False),
    ("Throughput (samples/s)", [("samples_per_sec", "samples/s")], False),
]


def save_dashboard(history: dict, out_dir: str | Path) -> Path:
    """``<out_dir>/training_dashboard.png`` (``Main_MMR_SegModel.py:
    379-480``): six curve plots by epoch in two rows of three, ``GAP``
    white pixels apart — loss, IoU, learning rate (log y), epoch time,
    device memory, samples/s. Its ``tEXt`` chunk ``dashboard`` holds each
    panel's title and ``plot`` metadata in that order; panel ``i`` starts at
    row ``(i // 3)·(H + GAP)``, column ``(i % 3)·(W + GAP)`` of the
    ``CANVAS`` size (H, W)."""
    ep = history.get("epoch", [])
    h, w = CANVAS
    img = np.full((2 * h + GAP, 3 * w + 2 * GAP, 3), 255, np.uint8)
    panels = []
    for i, (title, keys, log) in enumerate(DASHBOARD):
        series = {label: history.get(key, []) for key, label in keys}
        if log:
            series = {k: v for k, v in series.items() if all(x > 0 for x in v)}
        tile, meta = _panel(ep, series, title, log)
        r, c = (i // 3) * (h + GAP), (i % 3) * (w + GAP)
        img[r:r + h, c:c + w] = tile
        panels.append({"title": title, **meta})
    return png.write(Path(out_dir) / "training_dashboard.png", img,
                     {"dashboard": json.dumps({"panels": panels, "gap": GAP})})


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


# ------------------------------------------------------------------- text

# 5×7 glyphs of printable ASCII, rows top to bottom, "#" a lit pixel
FONT = {
    " ": "..... ..... ..... ..... ..... ..... .....",
    "!": "..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..",
    '"': ".#.#. .#.#. ..... ..... ..... ..... .....",
    "#": ".#.#. .#.#. ##### .#.#. ##### .#.#. .#.#.",
    "$": "..#.. .#### #.#.. .###. ..#.# ####. ..#..",
    "%": "##... ##..# ...#. ..#.. .#... #..## ...##",
    "&": ".##.. #..#. #.#.. .#... #.#.# #..#. .##.#",
    "'": "..#.. ..#.. ..... ..... ..... ..... .....",
    "(": "...#. ..#.. .#... .#... .#... ..#.. ...#.",
    ")": ".#... ..#.. ...#. ...#. ...#. ..#.. .#...",
    "*": "..... ..#.. #.#.# .###. #.#.# ..#.. .....",
    "+": "..... ..#.. ..#.. ##### ..#.. ..#.. .....",
    ",": "..... ..... ..... ..... .##.. ..#.. .#...",
    "-": "..... ..... ..... ##### ..... ..... .....",
    ".": "..... ..... ..... ..... ..... .##.. .##..",
    "/": "..... ....# ...#. ..#.. .#... #.... .....",
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": "##### ...#. ..#.. ...#. ....# #...# .###.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
    ":": "..... .##.. .##.. ..... .##.. .##.. .....",
    ";": "..... .##.. .##.. ..... .##.. ..#.. .#...",
    "<": "...#. ..#.. .#... #.... .#... ..#.. ...#.",
    "=": "..... ..... ##### ..... ##### ..... .....",
    ">": ".#... ..#.. ...#. ....# ...#. ..#.. .#...",
    "?": ".###. #...# ....# ...#. ..#.. ..... ..#..",
    "@": ".###. #...# ....# .##.# #.#.# #.#.# .###.",
    "A": ".###. #...# #...# ##### #...# #...# #...#",
    "B": "####. #...# #...# ####. #...# #...# ####.",
    "C": ".###. #...# #.... #.... #.... #...# .###.",
    "D": "###.. #..#. #...# #...# #...# #..#. ###..",
    "E": "##### #.... #.... ####. #.... #.... #####",
    "F": "##### #.... #.... ####. #.... #.... #....",
    "G": ".###. #...# #.... #.### #...# #...# .####",
    "H": "#...# #...# #...# ##### #...# #...# #...#",
    "I": ".###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "J": "..### ...#. ...#. ...#. ...#. #..#. .##..",
    "K": "#...# #..#. #.#.. ##... #.#.. #..#. #...#",
    "L": "#.... #.... #.... #.... #.... #.... #####",
    "M": "#...# ##.## #.#.# #.#.# #...# #...# #...#",
    "N": "#...# #...# ##..# #.#.# #..## #...# #...#",
    "O": ".###. #...# #...# #...# #...# #...# .###.",
    "P": "####. #...# #...# ####. #.... #.... #....",
    "Q": ".###. #...# #...# #...# #.#.# #..#. .##.#",
    "R": "####. #...# #...# ####. #.#.. #..#. #...#",
    "S": ".#### #.... #.... .###. ....# ....# ####.",
    "T": "##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "U": "#...# #...# #...# #...# #...# #...# .###.",
    "V": "#...# #...# #...# #...# #...# .#.#. ..#..",
    "W": "#...# #...# #...# #.#.# #.#.# #.#.# .#.#.",
    "X": "#...# #...# .#.#. ..#.. .#.#. #...# #...#",
    "Y": "#...# #...# .#.#. ..#.. ..#.. ..#.. ..#..",
    "Z": "##### ....# ...#. ..#.. .#... #.... #####",
    "[": ".###. .#... .#... .#... .#... .#... .###.",
    "\\": "..... #.... .#... ..#.. ...#. ....# .....",
    "]": ".###. ...#. ...#. ...#. ...#. ...#. .###.",
    "^": "..#.. .#.#. #...# ..... ..... ..... .....",
    "_": "..... ..... ..... ..... ..... ..... #####",
    "`": ".#... ..#.. ..... ..... ..... ..... .....",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "b": "#.... #.... #.##. ##..# #...# #...# ####.",
    "c": "..... ..... .###. #.... #.... #...# .###.",
    "d": "....# ....# .##.# #..## #...# #...# .####",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    "f": "..##. .#..# .#... ###.. .#... .#... .#...",
    "g": "..... .#### #...# #...# .#### ....# .###.",
    "h": "#.... #.... #.##. ##..# #...# #...# #...#",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###.",
    "j": "...#. ..... ..##. ...#. ...#. #..#. .##..",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#.",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "m": "..... ..... ##.#. #.#.# #.#.# #...# #...#",
    "n": "..... ..... #.##. ##..# #...# #...# #...#",
    "o": "..... ..... .###. #...# #...# #...# .###.",
    "p": "..... ..... ####. #...# ####. #.... #....",
    "q": "..... ..... .##.# #..## .#### ....# ....#",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "s": "..... ..... .###. #.... .###. ....# ####.",
    "t": ".#... .#... ###.. .#... .#... .#..# ..##.",
    "u": "..... ..... #...# #...# #...# #..## .##.#",
    "v": "..... ..... #...# #...# #...# .#.#. ..#..",
    "w": "..... ..... #...# #...# #.#.# #.#.# .#.#.",
    "x": "..... ..... #...# .#.#. ..#.. .#.#. #...#",
    "y": "..... ..... #...# #...# .#### ....# .###.",
    "z": "..... ..... ##### ...#. ..#.. .#... #####",
    "{": "...#. ..#.. ..#.. .#... ..#.. ..#.. ...#.",
    "|": "..#.. ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "}": ".#... ..#.. ..#.. ...#. ..#.. ..#.. .#...",
    "~": "..... ..... .#... #.#.# ...#. ..... .....",
}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6   # pixels at scale 1


def _glyph(ch: str) -> np.ndarray:
    rows = FONT.get(ch, FONT["?"]).split()
    return np.array([[c == "#" for c in r] for r in rows])


def text_size(text: str, scale: int = 1) -> tuple[int, int]:
    """(height, width) in pixels of one line of ``text``."""
    return GLYPH_H * scale, max(len(text) * ADVANCE - 1, 0) * scale


def draw_text(img: np.ndarray, text: str, top: int, left: int,
              colour=(0, 0, 0), scale: int = 1) -> None:
    """Draw one line of ``text`` into the RGB array ``img`` with its top
    left at (``top``, ``left``), each font pixel a ``scale`` × ``scale``
    square; characters outside :data:`FONT` draw as "?", pixels outside
    ``img`` are dropped."""
    for i, ch in enumerate(text):
        g = np.kron(_glyph(ch), np.ones((scale, scale), bool))
        r0, c0 = top, left + i * ADVANCE * scale
        rs, cs = np.nonzero(g)
        keep = ((rs + r0 >= 0) & (rs + r0 < img.shape[0])
                & (cs + c0 >= 0) & (cs + c0 < img.shape[1]))
        img[rs[keep] + r0, cs[keep] + c0] = colour


def _text_centred(img, lines: list[str], row: int, col: int, scale: int) -> None:
    """Lines of text centred on (row, col), 3 scaled pixels between lines."""
    h = len(lines) * (GLYPH_H + 3) * scale - 3 * scale
    for k, line in enumerate(lines):
        w = text_size(line, scale)[1]
        draw_text(img, line, row - h // 2 + k * (GLYPH_H + 3) * scale,
                  col - w // 2, scale=scale)


# ----------------------------------------------------------------- legend

# matplotlib's ``hot`` colour map (``_cm.py::_hot_data``): per channel the
# (x, value) points it interpolates between
_HOT = {"red": ((0.0, 0.0416), (0.365079, 1.0), (1.0, 1.0)),
        "green": ((0.0, 0.0), (0.365079, 0.0), (0.746032, 1.0), (1.0, 1.0)),
        "blue": ((0.0, 0.0), (0.746032, 0.0), (1.0, 1.0))}


def hot(x: float) -> tuple[int, int, int]:
    """``matplotlib.cm.hot(x)`` as uint8 RGB: the map's 256-entry table,
    each entry its channels interpolated at ``k / 255``, indexed by
    ``min(int(x · 256), 255)``; each channel rounded to 0-255."""
    k = min(max(int(x * 256), 0), 255)
    return tuple(int(np.floor(np.interp(k / 255, *zip(*_HOT[c])) * 255 + 0.5))
                 for c in ("red", "green", "blue"))


LEGEND_BAND, LEGEND_W = 60, 480   # pixels a class, legend width


def save_class_legend(names: list[str], out_dir: str | Path) -> Path:
    """``<out_dir>/class_legend.png`` (``cli/visualize.py:78-100``): a bar
    per class, class 0 at the bottom, in ``cm.hot(i / (n − 1))``, with
    ``"{i}: {name}"`` to its right. Its ``tEXt`` chunk ``legend`` holds
    each class's label, colour and bar (top, left, height, width)."""
    n = len(names)
    img = np.full((LEGEND_BAND * n, LEGEND_W, 3), 255, np.uint8)
    bars = []
    for i, name in enumerate(names):
        colour = hot(i / max(n - 1, 1))
        top = (n - 1 - i) * LEGEND_BAND + LEGEND_BAND // 10
        bar = [top, 16, LEGEND_BAND * 8 // 10, LEGEND_W // 2 - 32]
        img[bar[0]:bar[0] + bar[2], bar[1]:bar[1] + bar[3]] = colour
        label = f"{i}: {name}"
        scale = 2 if text_size(label, 2)[1] <= LEGEND_W // 2 - 24 else 1
        draw_text(img, label, top + bar[2] // 2 - text_size(label, scale)[0] // 2,
                  LEGEND_W // 2 - 8, scale=scale)
        bars.append({"label": label, "colour": list(colour), "bar": bar})
    return png.write(Path(out_dir) / "class_legend.png", img,
                     {"legend": json.dumps({"classes": bars})})


# ---------------------------------------------------------------- diagram

DIAGRAM = (720, 1440)   # height, width: JAX's 12 × 6 in at 120 dpi


def save_architecture_diagram(arch: str, encoder: str | None, n_classes: int,
                              n_params: int, out_dir: str | Path) -> Path:
    """``<out_dir>/architecture_diagram.png`` (``cli/visualize.py:103-153
    save_architecture_diagram``): the six labelled boxes (input, encoder,
    decoder, output, skip connections, parameter count) and the five
    arrows, on JAX's 8 × 5.5 axes, titled ``"{arch} architecture"``. Its
    ``tEXt`` chunk ``diagram`` holds each box's label, colour and (top,
    left, height, width) and each arrow's end points (row, column)."""
    h, w = DIAGRAM
    img = np.full((h, w, 3), 255, np.uint8)
    px = lambda x, y: (int(round(60 + (5.5 - y) / 5.5 * (h - 90))),
                       int(round(40 + x / 8 * (w - 80))))
    comps = [
        ("Input Image\n(H, W, 3)", (1, 4), "#FFE5B4"),
        (f"Encoder\n{encoder or 'built-in'}", (3, 4), "#87CEEB"),
        (f"Decoder\n{arch}", (5, 4), "#98FB98"),
        (f"Output\n(H, W, {n_classes})", (7, 4), "#FFB6C1"),
        ("Skip Connections", (4, 2.5), "#DDA0DD"),
        (f"{n_params:,} parameters", (4, 1.2), "#F0E68C"),
    ]
    boxes = []
    for label, (cx, cy), hexc in comps:
        colour = tuple(int(hexc[k:k + 2], 16) for k in (1, 3, 5))
        (r0, c0), (r1, c1) = px(cx - 0.6, cy + 0.4), px(cx + 0.6, cy - 0.4)
        img[r0:r1, c0:c1] = 0
        img[r0 + 2:r1 - 2, c0 + 2:c1 - 2] = colour
        lines = label.split("\n")
        scale = 2 if max(text_size(t, 2)[1] for t in lines) < c1 - c0 - 8 else 1
        _text_centred(img, lines, (r0 + r1) // 2, (c0 + c1) // 2, scale)
        boxes.append({"label": label, "colour": list(colour),
                      "box": [r0, c0, r1 - r0, c1 - c0]})
    arrows = []
    for p0, p1 in [((1.6, 4), (2.4, 4)), ((3.6, 4), (4.4, 4)),
                   ((5.6, 4), (6.4, 4)), ((3.4, 3.7), (4, 2.9)),
                   ((4, 2.9), (4.8, 3.7))]:
        a, b = px(*p0), px(*p1)
        for d in ((0, 0), (0, 1), (1, 0)):   # a line 2 pixels wide
            _line(img, (a[0] + d[0], a[1] + d[1]), (b[0] + d[0], b[1] + d[1]), (0, 0, 0))
        v = np.subtract(b, a) / max(np.hypot(*np.subtract(b, a)), 1)
        for side in (1, -1):   # the head: two strokes back from the tip
            back = np.array(b) - 14 * v + side * 7 * np.array([-v[1], v[0]])
            _line(img, b, tuple(int(round(t)) for t in back), (0, 0, 0))
        arrows.append([list(a), list(b)])
    title = f"{arch} architecture"
    draw_text(img, title, 16, (w - text_size(title, 3)[1]) // 2, scale=3)
    meta = {"title": title, "boxes": boxes, "arrows": arrows}
    return png.write(Path(out_dir) / "architecture_diagram.png", img,
                     {"diagram": json.dumps(meta)})
