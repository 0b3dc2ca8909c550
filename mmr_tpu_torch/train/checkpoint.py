"""Checkpoints of Path A, counterpart of ``mmr_tpu/train/checkpoint.py``
(its best-by-F1 scheme, ``ModelTraining.py:477-489``, and the ``.pth``
import and export; Path B's last / best-by-loss scheme waits, ROADMAP).

:class:`CheckpointManager` stores each checkpoint as one ``torch.save``
file named as JAX names its orbax directory (``best_f1``), holding the
model's ``state_dict``, the optimizer state and the step, with the same
``<name>.json`` meta beside it (``{"epoch", "mean_f1"}``).

:func:`export_torch_checkpoint` and :func:`import_torch_checkpoint` read
and write the reference's ``.pth`` layout (``checkpoint.py:158-255``):
``epoch``, ``network_state_dict`` (flax names joined by ``.``, conv
kernels OIHW), ``batch_stats``, ``validation_loss``. Names map through
:mod:`mmr_tpu_torch.models.convert`, so a ``.pth`` written by the JAX
package loads into the port, and the port's into JAX.
"""

from __future__ import annotations

import json
import logging
import os
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.train.state import TrainState


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _load_tolerant(model: torch.nn.Module, sd: Mapping) -> list[str]:
    """Copy the entries of ``sd`` whose name and shape match ``model``'s;
    returns the names of the model's entries left as they were."""
    own = model.state_dict()
    take = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict({**own, **take})
    return sorted(set(own) - set(take))


class CheckpointManager:
    """Best-by-F1 checkpoints under ``directory``."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _write(self, name: str, state: TrainState, meta: dict) -> None:
        tmp = self.dir / f".{name}.tmp"
        torch.save({"model": state.model.state_dict(),
                    "opt_state": state.opt_state, "step": int(state.step)}, tmp)
        os.replace(tmp, self.dir / name)
        (self.dir / f"{name}.json").write_text(json.dumps(meta))

    def save_best_by_f1(self, state: TrainState, epoch: int, mean_f1: float) -> bool:
        """Checkpoint only when mean F1 improves (``ModelTraining.py:477-489``);
        True when a new best was written."""
        meta_path = self.dir / "best_f1.json"
        prev = json.loads(meta_path.read_text()) if meta_path.exists() else None
        if prev is None or mean_f1 > prev["mean_f1"]:
            self._write("best_f1", state, {"epoch": int(epoch), "mean_f1": float(mean_f1)})
            return True
        return False

    def load(self, template: TrainState, which: str = "best_f1",
             weights_only: bool = False) -> tuple[TrainState, dict]:
        """Load ``which`` into ``template`` (its model in place) and return
        it with the meta. ``weights_only=True`` restores the model's
        parameters and BN statistics only, so an evaluation's optimizer
        need not match the one trained with. An optimizer state of another
        form (another optimizer, other sizes) is reset with a warning, as
        the JAX manager does."""
        raw = torch.load(self.dir / which, map_location=_device(template),
                         weights_only=True)
        meta = json.loads((self.dir / f"{which}.json").read_text())
        template.model.load_state_dict(raw["model"])
        if weights_only:
            return template, meta
        want, got = template.opt_state, raw["opt_state"]
        same = want.keys() == got.keys() and all(
            (torch.is_tensor(want[k]) and torch.is_tensor(got[k])
             and want[k].shape == got[k].shape)
            or (not torch.is_tensor(want[k]) and not torch.is_tensor(got[k]))
            for k in want)
        if same:
            template.opt_state, template.step = got, int(raw["step"])
        else:
            logging.getLogger("mmr_tpu_torch").warning(
                "checkpoint %s has an incompatible optimizer state; restoring "
                "weights and resetting the optimizer", self.dir / which)
            template.step = int(raw["step"])
        return template, meta

    def exists(self, which: str = "best_f1") -> bool:
        return (self.dir / which).exists()


def load_checkpoint_path(path: str | Path,
                         template: TrainState) -> tuple[TrainState, dict]:
    """Load a checkpoint from an explicit path, tolerantly — Path A's
    ``--resume <file>`` (``ModelTraining.py:308-337``: possibly from another
    run or another head). ``path`` is a ``.pth`` in the reference's layout
    (or a raw dict of flax names), a checkpoint file of
    :class:`CheckpointManager` (its ``<name>.json`` meta read when present),
    or a run directory holding ``checkpoints/best_f1``. Entries missing
    from the file or of another shape keep the template's values and are
    listed in ``meta["skipped"]``. Returns ``(template, meta)``."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no checkpoint found at '{p}'")
    if p.is_dir():
        if not (p / "checkpoints" / "best_f1").is_file():
            raise FileNotFoundError(f"{p}/checkpoints holds no best_f1 checkpoint")
        p = p / "checkpoints" / "best_f1"
    raw = torch.load(p, map_location="cpu", weights_only=True)
    if not (isinstance(raw, dict) and "model" in raw and "opt_state" in raw):
        return import_torch_checkpoint(p, template, strict=False)
    meta_file = p.parent / f"{p.name}.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    skipped = _load_tolerant(template.model, raw["model"])
    return template, dict(meta, skipped=skipped) if skipped else meta


# ------------------------------------------------------------- torch export

def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def export_torch_checkpoint(path: str | Path, state: TrainState, epoch: int,
                            validation_loss: float | None = None) -> None:
    """Write a ``.pth`` in the reference's layout (``Main_MMR_SegModel.py:
    919-943``, as JAX writes it): ``epoch``, ``network_state_dict`` (flax
    ``a.b.c`` names → f32 tensors, 4-D kernels HWIO → OIHW),
    ``batch_stats``, ``validation_loss``."""
    v = to_jax_variables(state.model.state_dict(), state.model)
    flat = {}
    for name, a in _flatten(v["params"]).items():
        if name.endswith(".kernel") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        flat[name] = torch.from_numpy(np.ascontiguousarray(a))
    ckpt = {"epoch": int(epoch), "network_state_dict": flat}
    if v["batch_stats"]:
        ckpt["batch_stats"] = {k: torch.from_numpy(np.ascontiguousarray(a))
                               for k, a in _flatten(v["batch_stats"]).items()}
    if validation_loss is not None:
        ckpt["validation_loss"] = float(validation_loss)
    torch.save(ckpt, str(path))


def import_torch_checkpoint(path: str | Path, template: TrainState,
                            strict: bool = True) -> tuple[TrainState, dict]:
    """Load a ``.pth`` of :func:`export_torch_checkpoint`'s layout (the JAX
    package's or the port's, wrapped or a raw dict of flax names) into
    ``template``'s model, in place. Kernels convert OIHW → HWIO; the
    optimizer state stays the template's. ``strict=False`` keeps the
    template's values for missing or mismatched entries and lists them in
    ``meta["skipped"]``. Returns ``(template, meta)``."""
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "network_state_dict" in raw:
        sd, stats_sd = raw["network_state_dict"], raw.get("batch_stats", {})
        meta = {k: raw[k] for k in ("epoch", "validation_loss") if k in raw}
    else:
        sd, stats_sd, meta = raw, {}, {}
    model = template.model
    tree = to_jax_variables(model.state_dict(), model)
    skipped: list[str] = []

    def fill(sub: dict, flat: Mapping, prefix: str = "") -> None:
        for k, v in sub.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                fill(v, flat, name)
                continue
            if name not in flat:
                if strict:
                    raise KeyError(f"checkpoint missing parameter {name!r}")
                skipped.append(name)
                continue
            a = flat[name].float().numpy()
            if name.endswith(".kernel") and a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            if a.shape != v.shape:
                if strict:
                    raise ValueError(f"shape mismatch for {name}: checkpoint "
                                     f"{a.shape} vs model {v.shape}")
                skipped.append(name)
                continue
            sub[k] = a

    fill(tree["params"], sd)
    if stats_sd:
        fill(tree["batch_stats"], stats_sd)
    model.load_state_dict(from_jax_variables(tree, model))
    if skipped:
        meta = dict(meta, skipped=skipped)
    return template, meta
