"""Train state (counterpart of ``mmr_tpu/train/state.py``). The model
module holds the parameters and the BN running statistics; the train step
updates them and ``opt_state`` in place."""

from __future__ import annotations

import dataclasses

from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: dict
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer) -> "TrainState":
        return cls(model, optimizer.init(list(model.parameters())))
