"""Mixed-precision policy (counterpart of ``mmr_tpu/core/precision.py``):
bf16 compute with f32 parameters and optimizer state, and logits and the
loss in f32. bf16 keeps f32's exponent range, so no loss scaling is
needed; the reference's AMP and fp16 names map to this policy."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_compute(self, tree):
        return _cast(tree, self.compute_dtype)

    def cast_output(self, tree):
        return _cast(tree, self.output_dtype)


def _cast(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict / list / tuple to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


DEFAULT_PRECISION = Precision()
FP32_PRECISION = Precision(compute_dtype=torch.float32)


def resolve(name: str | None) -> Precision:
    """Map config strings (``bf16``/``fp32``/``amp``/``fp16``) to a policy."""
    if name in (None, "bf16", "bfloat16", "amp", "fp16", "half", "mixed"):
        return DEFAULT_PRECISION
    if name in ("fp32", "float32", "full"):
        return FP32_PRECISION
    raise ValueError(f"unknown precision {name!r}")
