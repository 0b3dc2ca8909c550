"""Training monitors, counterparts of ``mmr_tpu/monitor/monitor.py``.

- :func:`get_logger`: Path A's file logger (``utils.py:185-216``),
  ``<log_dir>/<name>.log`` with ``asctime levelname message`` lines and
  the bare message on the console.
- :class:`TrainingMonitor`: Path B's (``Main_MMR_SegModel.py:116-480``) —
  the timestamped ``[ts] [LEVEL]`` console and file log, the per-epoch
  history (losses, IoU, LR, epoch time, samples/s, host CPU %, device
  memory, ETA) and ``training_metrics.json``. The host CPU % is the
  ``/proc/stat`` delta since the monitor's previous sample (psutil's
  ``cpu_percent()`` without an interval), the device memory
  ``torch.cuda``'s allocator's.
- :class:`ProfilerTrace`: ``torch.profiler`` for the listed epochs, one
  Chrome trace each under ``<results>/profile``.
- :func:`model_summary`: the parameter count of each top-level module,
  named as the flax tree names it, and the total.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch


def get_logger(log_dir: str | Path, name: str = "train") -> logging.Logger:
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"mmr_tpu_torch.{name}.{log_dir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(log_dir / f"{name}.log")
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    return logger


def device_memory_stats() -> dict:
    """Each CUDA device's allocated and peak allocated memory in MB (empty
    without CUDA)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"device{i}_bytes_in_use_mb"] = torch.cuda.memory_allocated(i) / 1e6
        out[f"device{i}_peak_bytes_mb"] = torch.cuda.max_memory_allocated(i) / 1e6
    return out


def _cpu_times() -> tuple[int, int] | None:
    """(busy, total) jiffies of all CPUs from ``/proc/stat`` (busy: all but
    idle and iowait, as psutil counts them), or None."""
    try:
        with open("/proc/stat") as f:
            fields = [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    total = sum(fields)
    return total - fields[3] - (fields[4] if len(fields) > 4 else 0), total


def _cpu_percent(last, now) -> float:
    """Host CPU use in % between two ``_cpu_times`` samples; 0.0 where one
    is missing or no time passed."""
    if now is None or last is None or now[1] <= last[1]:
        return 0.0
    return round(100.0 * (now[0] - last[0]) / (now[1] - last[1]), 1)


class TrainingMonitor:
    def __init__(self, results_path: str | Path, n_epochs: int):
        self.results_path = Path(results_path)
        self.results_path.mkdir(parents=True, exist_ok=True)
        self.n_epochs = n_epochs
        self.log_file = self.results_path / f"training_log_{time.strftime('%Y%m%d_%H%M%S')}.log"
        self.history: dict[str, list] = {
            "epoch": [], "train_loss": [], "val_loss": [], "train_iou": [],
            "val_iou": [], "lr": [], "epoch_time_s": [], "samples_per_sec": [],
            "cpu_percent": [], "device_mem_mb": [], "eta_min": [],
        }
        self._train_start = None
        self._epoch_start = None
        self._cpu = _cpu_times()

    def log_message(self, message: str, level: str = "INFO") -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] [{level}] {message}"
        print(line, flush=True)
        with open(self.log_file, "a") as f:
            f.write(line + "\n")

    def start_training(self) -> None:
        self._train_start = time.time()
        self.log_message(f"Training started — {self.n_epochs} epochs planned")

    def start_epoch(self, epoch: int) -> None:
        self._epoch_start = time.time()

    def end_epoch(self, epoch: int, train_loss: float, val_loss: float,
                  train_iou: float, val_iou: float, lr: float,
                  samples_seen: int) -> None:
        dt = time.time() - (self._epoch_start or time.time())
        done = len(self.history["epoch"]) + 1
        eta = (self.n_epochs - done) * (
            (time.time() - self._train_start) / done if self._train_start else dt)
        mem = device_memory_stats()
        mem_mb = max(mem.values()) if mem else 0.0
        self.history["epoch"].append(epoch)
        self.history["train_loss"].append(float(train_loss))
        self.history["val_loss"].append(float(val_loss))
        self.history["train_iou"].append(float(train_iou))
        self.history["val_iou"].append(float(val_iou))
        self.history["lr"].append(float(lr))
        self.history["epoch_time_s"].append(dt)
        self.history["samples_per_sec"].append(samples_seen / dt if dt > 0 else 0.0)
        cpu, self._cpu = self._cpu, _cpu_times()
        self.history["cpu_percent"].append(_cpu_percent(cpu, self._cpu))
        self.history["device_mem_mb"].append(mem_mb)
        self.history["eta_min"].append(eta / 60.0)
        self.log_message(
            f"Epoch {epoch}/{self.n_epochs} — train {train_loss:.4f} "
            f"val {val_loss:.4f} | IoU train {train_iou:.4f} val {val_iou:.4f} "
            f"| lr {lr:.2e} | {dt:.1f}s ({self.history['samples_per_sec'][-1]:.1f} samples/s) "
            f"| HBM {mem_mb:.0f}MB | ETA {eta / 60:.1f}min")

    def save_metrics(self) -> Path:
        out = self.results_path / "training_metrics.json"
        out.write_text(json.dumps(self.history, indent=2))
        return out


# ------------------------------------------------------------ profiler trace

class ProfilerTrace:
    """Flag-gated ``torch.profiler`` capture of whole epochs (the
    reference's resource sampling, ``Main_MMR_SegModel.py:203-251``): CPU
    and, with CUDA, device activity, written as
    ``<results>/profile/epoch_<n>.trace.json`` (Chrome trace format).

        tracer = ProfilerTrace(results_path, epochs=(1,))
        tracer.maybe_start(epoch); ...train...; tracer.maybe_stop(epoch)
    """

    def __init__(self, results_path, epochs=(1,), enabled: bool = True):
        self.dir = Path(results_path) / "profile"
        self.epochs = set(int(e) for e in epochs)
        self.enabled = bool(enabled) and bool(self.epochs)
        self._prof = None
        self._epoch = None

    def maybe_start(self, epoch: int) -> bool:
        if not self.enabled or epoch not in self.epochs or self._prof is not None:
            return False
        from torch.profiler import ProfilerActivity, profile

        self.dir.mkdir(parents=True, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof, self._epoch = profile(activities=acts), epoch
        self._prof.start()
        return True

    def maybe_stop(self, epoch: int) -> bool:
        if self._prof is None:
            return False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(str(self.dir / f"epoch_{self._epoch}.trace.json"))
        self._prof = None
        return True


def model_summary(model: torch.nn.Module) -> str:
    """Parameter table of ``model`` — the reference's torchinfo surface
    (``Main_MMR_SegModel.py:1130-1132``): each top-level module's
    parameter count, named as the flax tree names it
    (:func:`~mmr_tpu_torch.models.convert.to_jax_variables`), and the
    total. The same rows and total as JAX's ``model_summary`` on the same
    model."""
    from mmr_tpu_torch.models.convert import to_jax_variables

    variables = to_jax_variables(model.state_dict(), model)
    rows = []

    def walk(tree, prefix, depth):
        total = 0
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                total += walk(v, f"{prefix}/{k}" if prefix else k, depth + 1)
            else:
                total += int(np.prod(np.shape(v)))
        if depth <= 2 and prefix:
            rows.append((prefix, total))
        return total

    total = walk(variables["params"], "", 0)
    width = max([len(r[0]) for r in rows] + [20])
    lines = ["=" * (width + 16),
             f"{'Layer':<{width}}  {'Param #':>12}",
             "=" * (width + 16)]
    for name, n in rows:
        if "/" not in name:  # top-level modules after their children
            lines.append(f"{name:<{width}}  {n:>12,}")
    lines.append("=" * (width + 16))
    lines.append(f"{'Total params':<{width}}  {total:>12,}")
    lines.append("=" * (width + 16))
    return "\n".join(lines)
