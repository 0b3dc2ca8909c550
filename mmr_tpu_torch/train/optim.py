"""Clip + Adam(W) over one flat f32 buffer (counterpart of
``mmr_tpu/train/optim.py::FusedAdamW`` and of ``build_optimizer`` for
"adamw" and "adam").

AdamW is exactly ``optim.py:130-156``: the global norm of all gradients,
the clip factor ``min(1, clip / max(gn, 1e-12))`` (not torch's ``max_norm /
(norm + 1e-6)``), Adam moments, and the decoupled decay inside the
direction, ``p −= lr·(m̂/(√v̂ + eps) + wd·p)`` (torch AdamW). Adam is the
optax chain ``clip_by_global_norm`` (only when asked) →
``add_decayed_weights`` → ``scale_by_adam`` (``optim.py:53-58``): torch
Adam's coupled L2, the decay added to the clipped gradient before the
moments. ``differential_lr`` scales the direction of every parameter
outside the encoder by 0.1. SGD and RMSprop are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FusedAdamW:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    clip: float | None = None
    differential_lr: bool = False
    # False: torch Adam's coupled L2 (g += wd·p before the moments)
    decoupled_decay: bool = True

    def init(self, params: list[torch.Tensor]) -> dict:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return {"mu": torch.zeros(n, device=dev), "nu": torch.zeros(n, device=dev),
                "count": 0}

    def lr_mult(self, names: list[str], params: list[torch.Tensor]):
        """Per-element LR factor (1 in the encoder, 0.1 elsewhere), or None."""
        if not self.differential_lr:
            return None
        return torch.cat([torch.full((p.numel(),),
                                     1.0 if n.split(".")[0] == "encoder" else 0.1,
                                     device=p.device)
                          for n, p in zip(names, params)])

    @torch.no_grad()
    def apply_updates(self, params: list[torch.Tensor], opt_state: dict,
                      grads: list[torch.Tensor | None], lr: float,
                      mult: torch.Tensor | None = None) -> dict:
        """Update ``params`` in place; returns the new optimizer state. A
        None gradient counts as zeros."""
        g = torch.cat([torch.zeros(p.numel(), device=p.device) if d is None
                       else d.reshape(-1).float() for p, d in zip(params, grads)])
        p = torch.cat([x.reshape(-1).float() for x in params])
        if self.clip:
            gn = torch.sqrt((g * g).sum())
            g = g * torch.clamp_max(self.clip / torch.clamp_min(gn, 1e-12), 1.0)
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
        if mult is not None:
            d = d * mult
        newp = p - lr * d
        off = 0
        for x in params:
            x.copy_(newp[off:off + x.numel()].view_as(x))
            off += x.numel()
        return {"mu": mu, "nu": nu, "count": c}


def build_optimizer(name: str, clip_grad_norm: float | None = None,
                    differential_lr: bool = False, **kw) -> FusedAdamW:
    """``"adamw"`` (Path B's default, ``config.py:85-88``; weight decay
    default 1e-2) or ``"adam"`` (Path A's, coupled L2; weight decay default
    0) as :class:`FusedAdamW`; any other name raises."""
    name = name.lower()
    if name not in ("adamw", "adam"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ported: adamw, adam; the "
            "others are listed in ROADMAP.md)")
    betas = tuple(kw.get("betas", (0.9, 0.999)))
    wd = kw.get("weight_decay", 1e-2 if name == "adamw" else 0.0)
    return FusedAdamW(b1=betas[0], b2=betas[1], eps=float(kw.get("eps", 1e-8)),
                      weight_decay=float(wd or 0.0),
                      clip=float(clip_grad_norm) if clip_grad_norm else None,
                      differential_lr=differential_lr,
                      decoupled_decay=name == "adamw")
