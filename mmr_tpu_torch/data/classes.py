"""Class-definition registry, the port's copy of ``mmr_tpu/data/classes.py``
(the reference's ``SurgicalDataClass/classes/*.json`` capability: id ↔
name ↔ RGB color, ``SegNetDataLoaderV1_SAR.py:77-95`` ``disentangleKey``).
The SAR-RARP50 key (10 classes: background + 9 tool classes) is built in;
arbitrary keys load from the same JSON schema (``{"classes": [{"id": "0",
"name": ..., "color": "[r, g, b]"}, ...]}``)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np

SARRARP50_CLASSES = [
    ("Background", (0, 0, 0), "misc"),
    ("Tool clasper", (255, 0, 0), "instrument"),
    ("Tool wrist", (0, 255, 0), "instrument"),
    ("Tool shaft", (0, 0, 255), "instrument"),
    ("Suturing needle", (255, 255, 0), "tool"),
    ("Thread", (255, 0, 255), "tool"),
    ("Suction tool", (0, 255, 255), "instrument"),
    ("Needle Holder", (128, 128, 0), "instrument"),
    ("Clamps", (128, 0, 128), "instrument"),
    ("Catheter", (0, 128, 128), "instrument"),
]


def sarrarp50_key() -> np.ndarray:
    """(10, 3) uint8 color key ordered by class id."""
    return np.asarray([c for _, c, _ in SARRARP50_CLASSES], np.uint8)


def sarrarp50_names() -> list[str]:
    return [n for n, _, _ in SARRARP50_CLASSES]


def write_class_json(path: str | Path, classes=SARRARP50_CLASSES) -> Path:
    path = Path(path)
    path.write_text(json.dumps({
        "classes": [
            {"id": str(i), "name": name, "color": str(list(color)),
             "super-category": cat}
            for i, (name, color, cat) in enumerate(classes)
        ]
    }, indent=2))
    return path


def load_class_json(path: str | Path) -> tuple[np.ndarray, list[str]]:
    """Parse the reference JSON schema → (color key (C,3) uint8, names).
    Color strings are ``"[r, g, b]"`` literals (``disentangleKey`` parsing,
    ``utils.py:299-339``)."""
    data = json.loads(Path(path).read_text())
    entries = sorted(data["classes"], key=lambda c: int(c["id"]))
    key = np.asarray([ast.literal_eval(c["color"]) for c in entries], np.uint8)
    names = [c["name"] for c in entries]
    return key, names
