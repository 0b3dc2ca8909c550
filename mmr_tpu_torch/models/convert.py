"""Carry weights between the JAX package and the port.

:func:`from_jax_variables` maps flax variables ``{"params": ...,
"batch_stats": ...}`` — nested dicts of numpy arrays, as ``jax.device_get``
returns them — to the port's ``state_dict``. Module names mirror the flax
tree, so the mapping is mechanical: the path joins with ``.``, conv
``kernel`` HWIO (3×3, depthwise (k,k,1,C), 1×1) becomes ``weight`` OIHW,
BN ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
``running_mean``/``running_var``. :func:`to_jax_variables` is its inverse
(so tests can hold updated params and BN statistics against the JAX
step's). The plain and fused paths of both packages share one tree.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple[str, ...]):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
                continue
            if k not in _LEAF:
                raise KeyError(f"unknown leaf {'/'.join(prefix + (k,))}")
            a = np.asarray(v, np.float32)
            if k == "kernel":
                if a.ndim != 4:
                    raise ValueError(f"{'/'.join(prefix)}: kernel must be HWIO")
                a = a.transpose(3, 2, 0, 1)
            name = ".".join(prefix + (_LEAF[k],))
            if name in out:
                raise KeyError(f"duplicate target key {name}")
            out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    return out


def to_jax_variables(state_dict: Mapping) -> dict:
    """The port's ``state_dict`` -> flax ``{"params", "batch_stats"}`` as
    nested dicts of f32 numpy arrays: OIHW ``weight`` becomes HWIO
    ``kernel``, a 1-D ``weight`` a BN ``scale``, ``running_mean``/
    ``running_var`` the ``batch_stats`` ``mean``/``var``."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, v in state_dict.items():
        *path, leaf = name.split(".")
        a = v.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, a = ("kernel", a.transpose(2, 3, 1, 0)) if a.ndim == 4 \
                else ("scale", a)
            tree = out["params"]
        elif leaf == "bias":
            tree = out["params"]
        elif leaf in ("running_mean", "running_var"):
            leaf, tree = leaf[len("running_"):], out["batch_stats"]
        else:
            raise KeyError(f"unknown state_dict entry {name}")
        for k in path:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.ascontiguousarray(a)
    return out
