"""Optimizers over one flat f32 buffer (counterpart of
``mmr_tpu/train/optim.py``: ``FusedAdamW`` and ``build_optimizer`` for
"adamw", "adam", "sgd" and "rmsprop").

Every update flattens the gradients into one f32 vector, clips it when
asked, forms the ascent direction, scales it by the per-element LR factor
and subtracts ``lr`` times it from the parameters, in place.

- AdamW is exactly ``optim.py:130-156``: the global norm of all gradients,
  the clip factor ``min(1, clip / max(gn, 1e-12))`` (not torch's
  ``max_norm / (norm + 1e-6)``), Adam moments, and the decoupled decay
  inside the direction, ``p −= lr·(m̂/(√v̂ + eps) + wd·p)`` (torch AdamW).
- The others are the optax chains of ``optim.py:46-80`` behind
  ``clip_by_global_norm`` (only when asked: ``g`` if ``gn < clip``, else
  ``g / gn · clip``): Adam is ``add_decayed_weights`` →
  ``scale_by_adam`` (torch Adam's coupled L2: the decay added to the
  clipped gradient before the moments); SGD is ``add_decayed_weights`` →
  ``trace(decay=momentum)`` (heavy ball, not Nesterov: ``t = g + m·t``);
  RMSprop is ``add_decayed_weights`` → ``scale_by_rms(decay=alpha, eps)``
  as this optax defines it (``ν = α·ν + (1 − α)·g²``, ``g · rsqrt(ν +
  eps)``: eps inside the root, no bias correction; ``torch.optim.RMSprop``
  divides by ``√ν + eps``).

``differential_lr`` scales the direction of every parameter outside the
encoder by 0.1 (``optim.py:182-193``).

On a multi-rank :class:`~mmr_tpu_torch.core.mesh.Mesh` the flat gradient
is averaged over the ranks in one all-reduce before the clip (JAX's
``pmean`` of the gradients, ``steps.py:181-184``), so every rank takes the
same update.
"""

from __future__ import annotations

import dataclasses

import torch

from mmr_tpu_torch.core.mesh import psum_if_sharded


def _flat(params: list[torch.Tensor], grads: list[torch.Tensor | None]):
    """(gradients, parameters) as flat f32 vectors; a None gradient counts
    as zeros."""
    g = torch.cat([torch.zeros(p.numel(), device=p.device) if d is None
                   else d.reshape(-1).float() for p, d in zip(params, grads)])
    return g, torch.cat([x.reshape(-1).float() for x in params])


def _zeros(params: list[torch.Tensor]) -> torch.Tensor:
    """A flat f32 state buffer of the parameters' size."""
    return torch.zeros(sum(p.numel() for p in params), device=params[0].device)


def _write(params: list[torch.Tensor], flat: torch.Tensor) -> None:
    off = 0
    for x in params:
        x.copy_(flat[off:off + x.numel()].view_as(x))
        off += x.numel()


@dataclasses.dataclass(frozen=True)
class _Flat:
    """What every flat optimizer shares: the per-element LR factor and the
    update around the subclass's ``direction``."""

    weight_decay: float = 0.0
    clip: float | None = None
    differential_lr: bool = False

    def lr_mult(self, names: list[str], params: list[torch.Tensor]):
        """Per-element LR factor (1 in the encoder, 0.1 elsewhere), or None."""
        if not self.differential_lr:
            return None
        return torch.cat([torch.full((p.numel(),),
                                     1.0 if n.split(".")[0] == "encoder" else 0.1,
                                     device=p.device)
                          for n, p in zip(names, params)])

    def _clipped(self, g: torch.Tensor) -> torch.Tensor:
        """optax ``clip_by_global_norm``."""
        if not self.clip:
            return g
        gn = torch.sqrt((g * g).sum())
        return torch.where(gn < self.clip, g, g / gn * self.clip)

    @torch.no_grad()
    def apply_updates(self, params: list[torch.Tensor], opt_state: dict,
                      grads: list[torch.Tensor | None], lr: float,
                      mult: torch.Tensor | None = None, mesh=None) -> dict:
        """Update ``params`` in place; returns the new optimizer state. A
        None gradient counts as zeros; ``mesh``: average the gradient over
        its ranks first."""
        g, p = _flat(params, grads)
        if mesh is not None and mesh.size > 1:
            g = psum_if_sharded(g, mesh) / mesh.size
        d, state = self.direction(self._clipped(g), p, opt_state)
        if mult is not None:
            d = d * mult
        _write(params, p - lr * d)
        return state


@dataclasses.dataclass(frozen=True)
class FusedAdamW(_Flat):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    # False: torch Adam's coupled L2 (g += wd·p before the moments)
    decoupled_decay: bool = True

    def init(self, params: list[torch.Tensor]) -> dict:
        return {"mu": _zeros(params), "nu": _zeros(params), "count": 0}

    def _clipped(self, g: torch.Tensor) -> torch.Tensor:
        """``optim.py:140-142``: the factor min(1, clip / max(gn, 1e-12))."""
        if not self.clip:
            return g
        gn = torch.sqrt((g * g).sum())
        return g * torch.clamp_max(self.clip / torch.clamp_min(gn, 1e-12), 1.0)

    def direction(self, g, p, opt_state):
        if not self.decoupled_decay:
            g = g + self.weight_decay * p
        c = opt_state["count"] + 1
        mu = self.b1 * opt_state["mu"] + (1.0 - self.b1) * g
        nu = self.b2 * opt_state["nu"] + (1.0 - self.b2) * g * g
        mhat = mu / (1.0 - self.b1 ** c)
        nhat = nu / (1.0 - self.b2 ** c)
        d = mhat / (torch.sqrt(nhat) + self.eps)
        if self.decoupled_decay:
            d = d + self.weight_decay * p
        return d, {"mu": mu, "nu": nu, "count": c}


@dataclasses.dataclass(frozen=True)
class FlatSGD(_Flat):
    momentum: float = 0.9

    def init(self, params: list[torch.Tensor]) -> dict:
        return {"trace": _zeros(params)} if self.momentum else {}

    def direction(self, g, p, opt_state):
        if self.weight_decay:
            g = g + self.weight_decay * p
        if not self.momentum:
            return g, opt_state
        t = g + self.momentum * opt_state["trace"]
        return t, {"trace": t}


@dataclasses.dataclass(frozen=True)
class FlatRMSprop(_Flat):
    alpha: float = 0.99
    eps: float = 1e-8

    def init(self, params: list[torch.Tensor]) -> dict:
        return {"nu": _zeros(params)}

    def direction(self, g, p, opt_state):
        if self.weight_decay:
            g = g + self.weight_decay * p
        nu = self.alpha * opt_state["nu"] + (1.0 - self.alpha) * g * g
        return g * torch.rsqrt(nu + self.eps), {"nu": nu}


def build_optimizer(name: str, clip_grad_norm: float | None = None,
                    differential_lr: bool = False, **kw) -> _Flat:
    """``"adamw"`` (Path B's default, ``config.py:85-88``; weight decay
    default 1e-2), ``"adam"`` (Path A's, coupled L2; weight decay default
    0), ``"sgd"`` (``momentum``, default 0.9) or ``"rmsprop"`` (``alpha``,
    default 0.99); ``eps`` and ``betas`` as in JAX. Any other name raises
    ``ValueError``."""
    name = name.lower()
    clip = float(clip_grad_norm) if clip_grad_norm else None
    eps = float(kw.get("eps", 1e-8))
    if name in ("adamw", "adam"):
        betas = tuple(kw.get("betas", (0.9, 0.999)))
        wd = kw.get("weight_decay", 1e-2 if name == "adamw" else 0.0)
        return FusedAdamW(b1=betas[0], b2=betas[1], eps=eps,
                          weight_decay=float(wd or 0.0), clip=clip,
                          differential_lr=differential_lr,
                          decoupled_decay=name == "adamw")
    wd = float(kw.get("weight_decay", 0.0) or 0.0)
    if name == "sgd":
        return FlatSGD(momentum=float(kw.get("momentum", 0.9) or 0.0),
                       weight_decay=wd, clip=clip, differential_lr=differential_lr)
    if name == "rmsprop":
        return FlatRMSprop(alpha=float(kw.get("alpha", 0.99)), eps=eps,
                           weight_decay=wd, clip=clip,
                           differential_lr=differential_lr)
    raise ValueError(f"unknown optimizer {name!r}")
