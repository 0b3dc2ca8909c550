"""Learning-rate schedules with torch semantics, stepped per epoch
(counterpart of ``mmr_tpu/train/schedules.py``): a schedule is a function
``epoch -> lr`` whose value the caller passes to the train step."""

from __future__ import annotations

import math
from typing import Callable


def step_lr(base_lr: float, epochs: int, lr_steps: int,
            gamma: float = 0.1) -> Callable[[int], float]:
    """``base · gamma^(epoch // step_size)``, ``step_size = epochs //
    (lr_steps + 1)``."""
    if lr_steps <= 0:
        raise ValueError("lr_steps must be > 0")
    step_size = max(1, int(epochs // (lr_steps + 1)))
    return lambda epoch: float(base_lr * gamma ** (int(epoch) // step_size))


def polynomial_lr(base_lr: float, total_iters: int,
                  power: float = 0.9) -> Callable[[int], float]:
    """torch ``PolynomialLR``: ``base · (1 − epoch/total_iters)^power``."""
    def sched(epoch: int) -> float:
        if total_iters <= 0:
            return base_lr
        e = min(int(epoch), total_iters)
        return float(base_lr * (1.0 - e / total_iters) ** power)

    return sched


def cosine_lr(base_lr: float, total_epochs: int,
              min_lr: float = 0.0) -> Callable[[int], float]:
    def sched(epoch: int) -> float:
        e = min(int(epoch), total_epochs)
        return float(min_lr + 0.5 * (base_lr - min_lr)
                     * (1 + math.cos(math.pi * e / max(total_epochs, 1))))

    return sched


def constant_lr(base_lr: float) -> Callable[[int], float]:
    return lambda epoch: float(base_lr)


def build_lr_schedule(config: dict, base_lr: float,
                      n_epochs: int) -> Callable[[int], float]:
    """From a config's ``lr_scheduler`` group (torch names)."""
    if not config:
        return constant_lr(base_lr)
    name = config.get("name", "PolynomialLR")
    if name == "PolynomialLR":
        return polynomial_lr(base_lr, int(config.get("total_iters", n_epochs)),
                             float(config.get("power", 0.9)))
    if name == "StepLR":
        gamma = float(config.get("gamma", 0.1))
        if "step_size" in config:
            step = int(config["step_size"])
            return lambda epoch: float(base_lr * gamma ** (int(epoch) // step))
        return step_lr(base_lr, n_epochs, int(config.get("lr_steps", 2)), gamma)
    if name == "CosineAnnealingLR":
        return cosine_lr(base_lr, int(config.get("T_max", n_epochs)),
                         float(config.get("eta_min", 0.0)))
    if name in ("none", "None", "ConstantLR"):
        return constant_lr(base_lr)
    raise ValueError(f"unknown lr scheduler {name!r}")
