"""Carry weights between the JAX package and the port.

:func:`from_jax_variables` maps flax variables ``{"params": ...,
"batch_stats": ...}`` — nested dicts of numpy arrays, as ``jax.device_get``
returns them — to the port's ``state_dict``. Module names mirror the flax
tree (``bn``, ``*_bn``, ``*_conv`` included), so the mapping is mechanical:
the path joins with ``.``, a conv ``kernel`` HWIO (3×3, dilated, depthwise
(k,k,1,C), 1×1) becomes ``weight`` OIHW (depthwise (C,1,k,k)), a flax
``Dense`` ``kernel`` (in, out) an ``nn.Linear`` ``weight`` (out, in), BN
and LayerNorm ``scale``/``bias`` become ``weight``/``bias``, BN
``mean``/``var`` ``running_mean``/``running_var``; GRN's ``gamma`` /
``beta`` and ConvNeXt's LayerScale ``gamma`` keep their names. A flax
``ConvTranspose`` kernel (kh, kw, in, out) correlates the dilated input as
it is, where torch's ``ConvTranspose2d`` convolves: its ``weight`` (in,
out, kh, kw) is the kernel flipped in both spatial axes. Which kernels are
transposed the tree does not say: pass the port's ``model`` (its
``ConvTranspose2d`` modules). :func:`to_jax_variables` is the inverse (so
tests can hold updated params and BN statistics against the JAX step's).
The plain and fused paths of both packages share one tree.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "gamma": "gamma", "beta": "beta"}


def transposed_convs(model: nn.Module | None) -> set[str]:
    """Names of the ``ConvTranspose2d`` modules of ``model``."""
    if model is None:
        return set()
    return {n for n, m in model.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def from_jax_variables(variables: Mapping,
                       model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    transposed = transposed_convs(model)
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
                if a.ndim == 2:      # Dense (in, out) -> Linear (out, in)
                    a = a.T
                elif a.ndim != 4:
                    raise ValueError(f"{'/'.join(prefix)}: kernel must be "
                                     "HWIO or a Dense (in, out)")
                elif ".".join(prefix) in transposed:
                    a = a[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(3, 2, 0, 1)
            name = ".".join(prefix + (_LEAF[k],))
            if name in out:
                raise KeyError(f"duplicate target key {name}")
            out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    return out


def jax_leaf(name: str, a, transposed: set[str] = frozenset()):
    """One ``state_dict`` entry -> (collection, path, flax leaf, array in
    the flax layout): ``a`` is a numpy array (or any view of one's shape)."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        if a.ndim == 4 and ".".join(path) in transposed:
            return "params", path, "kernel", a.transpose(2, 3, 0, 1)[::-1, ::-1]
        if a.ndim == 4:
            return "params", path, "kernel", a.transpose(2, 3, 1, 0)
        if a.ndim == 2:
            return "params", path, "kernel", a.T
        return "params", path, "scale", a
    if leaf in ("bias", "gamma", "beta"):
        return "params", path, leaf, a
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", path, leaf[len("running_"):], a
    raise KeyError(f"unknown state_dict entry {name}")


def to_jax_variables(state_dict: Mapping,
                     model: nn.Module | None = None) -> dict:
    """The port's ``state_dict`` (or any dict of its names, gradients
    included) -> flax ``{"params", "batch_stats"}`` as nested dicts of f32
    numpy arrays: OIHW ``weight`` becomes HWIO ``kernel`` (a transposed
    conv's of ``model``, flipped back), a 2-D ``weight`` a Dense (in, out)
    ``kernel``, a 1-D ``weight`` a BN / LayerNorm ``scale``,
    ``running_mean``/``running_var`` the ``batch_stats`` ``mean``/``var``;
    ``bias``, ``gamma`` and ``beta`` keep their names."""
    transposed = transposed_convs(model)
    out: dict = {"params": {}, "batch_stats": {}}
    for name, v in state_dict.items():
        coll, path, leaf, a = jax_leaf(
            name, v.detach().cpu().float().numpy(), transposed)
        tree = out[coll]
        for k in path:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.ascontiguousarray(a)
    return out
