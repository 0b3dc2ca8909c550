"""Per-shape dispatch of the standalone 3×3 conv: K6a / K6b or the library
conv (counterpart of ``mmr_tpu/ops/pallas/dispatch.py``).

``chip_probe.py --only conv_table --write`` times the op
(``conv3x3_packed.conv3x3p_bias_act``, ReLU on) with the kernels and with
the library conv, forward and forward + backward, in alternated pairs on
the card, and writes ``conv_table.json`` next to this file: one entry a
shape key ``"{h}x{w}x{cin}->{cout}"`` (``batch``, ``kernel_fwd_ms``,
``kernel_fwdbwd_ms``, ``library_fwd_ms``, ``library_fwdbwd_ms``,
``fwdbwd_gain_ms`` and ``fwdbwd_spread_ms``: the median and the
interquartile range over the pairs of the library's forward + backward less
the kernel's; ``kernel_wins``: the kernel's forward + backward median below
the library's, by more than that spread), and beside the entries the
card's name and power limit and the commit measured. Each direction of a conv asks at its own key: the
forward at ``(h, w, cin, cout)``, the backward's dx and dW at the
cotangent's shape with the flipped taps, ``(h, w, cout, cin)``
(``conv3x3_packed.py::_bwd``).

A shape missing from the table falls back to the size clause of JAX's
heuristic (H·W ≥ 64·64). Its packing-waste clause measures the TPU's
p-pixel lane packing, which the port does not have, and stays dropped.
K6a and K6b take every channel count, so no entry refuses a shape (JAX's
``plan is None``); a failed launch stops the tuner.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

TABLE_PATH = Path(__file__).with_name("conv_table.json")
MIN_HW = 64 * 64

# ``benchmarks/bench_conv_kernel.py:24-30``: (H = W, Cin, Cout)
BENCH_SHAPES = [
    (256, 32, 32), (256, 112, 32), (256, 144, 32), (256, 176, 32),
    (128, 40, 64), (128, 208, 64), (128, 272, 64), (128, 64, 64),
    (64, 72, 128), (64, 408, 128), (64, 128, 128),
    (32, 144, 256), (32, 256, 256),
    (512, 32, 16), (512, 16, 16), (512, 16, 10),
]


@functools.lru_cache(maxsize=1)
def table() -> dict:
    """The committed table: {"card", "commit", ..., "shapes": {key: entry}};
    ``{"shapes": {}}`` when there is none."""
    if TABLE_PATH.exists():
        return json.loads(TABLE_PATH.read_text())
    return {"shapes": {}}


def shape_key(h: int, w: int, cin: int, cout: int) -> str:
    return f"{h}x{w}x{cin}->{cout}"


def use_kernel(h: int, w: int, cin: int, cout: int) -> bool:
    """Whether a bf16 3×3 conv of (h, w, cin) to cout channels runs on K6:
    the table's verdict where it has the key, else H·W ≥ 64·64."""
    entry = table()["shapes"].get(shape_key(h, w, cin, cout))
    if entry is not None:
        return bool(entry["kernel_wins"])
    return h * w >= MIN_HW


def record(results: dict, **meta) -> None:
    """Merge tuner results ({key: entry}) and the table's ``meta`` fields
    (card, commit, ...) into the table, and clear the cache."""
    old = table()
    new = {**old, **meta, "shapes": {**old["shapes"], **results}}
    TABLE_PATH.write_text(json.dumps(new, indent=1, sort_keys=True) + "\n")
    table.cache_clear()
