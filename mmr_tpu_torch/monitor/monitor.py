"""Path A's file logger (``utils.py:185-216``), counterpart of
``mmr_tpu/monitor/monitor.py::get_logger``: ``<log_dir>/<name>.log`` with
``asctime levelname message`` lines, and the bare message on the console.
Path B's ``TrainingMonitor`` waits (ROADMAP)."""

from __future__ import annotations

import logging
from pathlib import Path


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
