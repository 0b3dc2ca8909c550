"""Pretrained-encoder weight manifests (counterpart of
``mmr_tpu/models/weight_manifest.py``).

The ImageNet encoder weights the reference pulls at run time cannot be
fetched here; the converter (:mod:`~mmr_tpu_torch.models.pretrained`)
runs wherever the torch checkpoints exist. This module pins down what the
conversion must produce, offline:

- :func:`build_manifest` derives the expected store tree (every leaf
  path, shape and dtype, and the parameter count) of an encoder from the
  port's module itself, built on the meta device (no weights), named and
  laid out as :func:`~mmr_tpu_torch.models.convert.to_jax_variables`
  gives them: the committed ``weights_manifest.json`` at the repo root,
  which the JAX package writes too, holds for both.
- :func:`verify_store` checks a converted ``<encoder>.<tag>.npz`` leaf by
  leaf against the manifest and returns its sha256.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from mmr_tpu_torch.models.convert import jax_leaf

MANIFEST_PATH = Path(__file__).resolve().parents[2] / "weights_manifest.json"


def build_manifest(encoder_name: str) -> dict:
    """Expected converted-weight tree of one encoder: per leaf its shape
    and dtype, flat keys under ``params/`` and ``batch_stats/``, exactly
    ``pretrained.save_weight_store``'s layout."""
    from mmr_tpu_torch.models.encoders import get_encoder

    with torch.device("meta"):
        enc = get_encoder(encoder_name).build()
    leaves = {}
    for name, v in enc.state_dict().items():
        coll, path, leaf, a = jax_leaf(name, np.broadcast_to(np.float32(0), v.shape))
        leaves["/".join([coll, *path, leaf])] = {"shape": list(a.shape),
                                                "dtype": "float32"}
    n_params = sum(int(np.prod(v["shape"]))
                   for k, v in leaves.items() if k.startswith("params/"))
    return {"encoder": encoder_name, "n_params": n_params,
            "leaves": dict(sorted(leaves.items()))}


def write_manifest(encoders: list[str], path: Path = MANIFEST_PATH) -> dict:
    manifest = {"format": 1,
                "encoders": {e: build_manifest(e) for e in encoders}}
    path.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def load_manifest(path: Path = MANIFEST_PATH) -> dict:
    return json.loads(Path(path).read_text())


def sha256_file(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_store(encoder_name: str, npz_path: str | Path,
                 manifest: dict | None = None) -> dict:
    """Check a converted ``.npz`` store leaf by leaf against the manifest.

    Returns ``{"sha256": ..., "n_leaves": ...}``; raises ``ValueError``
    listing every missing, extra or mis-shaped leaf otherwise."""
    manifest = manifest or load_manifest()
    want = manifest["encoders"][encoder_name]["leaves"]
    with np.load(npz_path) as z:
        have = {k: {"shape": list(z[k].shape), "dtype": str(z[k].dtype)}
                for k in z.files}
    errors = []
    for k, v in want.items():
        if k not in have:
            errors.append(f"missing leaf {k} {v['shape']}")
        elif have[k]["shape"] != v["shape"]:
            errors.append(f"shape mismatch {k}: store {have[k]['shape']} "
                          f"vs manifest {v['shape']}")
    errors += [f"unexpected leaf {k}" for k in have if k not in want]
    if errors:
        raise ValueError(f"{npz_path} does not match the "
                         f"{encoder_name} manifest:\n  " + "\n  ".join(errors))
    return {"sha256": sha256_file(npz_path), "n_leaves": len(have)}
