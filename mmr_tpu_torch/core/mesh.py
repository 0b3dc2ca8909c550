"""Data-parallel mesh over ``torch.distributed`` — counterpart of
``mmr_tpu/core/mesh.py``.

One process per rank (``torchrun --nproc_per_node N``), one device per
rank. The JAX mesh's ``data`` axis is the ranks of one process group; its
``model`` axis (reserved in JAX, 1 by default, used by no step) must be 1
here. What JAX's GSPMD and ``shard_map`` do for a data-parallel step, the
port's steps do by hand on a :class:`Mesh`:

- each rank takes its slice of the global batch (:func:`shard_batch`,
  :func:`local_batch_slice`);
- train-mode BN sums its moments over the ranks (:func:`all_reduce_moments`:
  forward a sum and the count times the rank count, backward a sum of the
  cotangent, as JAX transposes ``psum``); the modules ask for it only
  while a step has made its mesh the active one (:meth:`Mesh.active`);
- statistics that feed a nonlinear divide (IoU) are summed before it
  (:func:`psum_if_sharded`), and the gradients are averaged once, flat,
  before the clip and the optimizer.

Backends: NCCL with one card per local rank by default; gloo on the CPU,
and on CUDA only where it is asked for (two ranks on one card: NCCL refuses
a card that another rank holds). Nothing falls back from one to the other.
Every process group gets a timeout, so a collective that one rank never
joins fails the run instead of waiting forever.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)   # every process group's


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description (config-level object).

    ``data=-1`` means "all remaining devices on the data axis".
    """

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"MeshSpec(data={self.data}, model={self.model}) does not tile "
                f"{n_devices} devices"
            )
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel mesh: its ``rank`` of
    ``size`` ranks, the process ``group`` (None on a one-rank mesh) and
    its ``device``."""

    rank: int
    size: int
    group: dist.ProcessGroup | None
    device: torch.device

    @contextlib.contextmanager
    def active(self):
        """Make this the mesh that BN and :func:`psum_if_sharded` reduce
        over, for the body of the ``with`` (a train or eval step)."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def barrier(self) -> None:
        """Wait until every rank gets here (a one-element all-reduce on
        this rank's device, so it is the same call for every backend)."""
        if self.size > 1:
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)


_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "mmr_tpu_torch_mesh", default=None)


def active_mesh() -> Mesh | None:
    """The mesh a running step reduces over, if it has more than one rank."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.size > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; its transpose is the same sum of
    the cotangent (``jax.lax.psum``'s)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` (default: the active one),
    differentiably; ``x`` itself without a multi-rank mesh."""
    mesh = mesh or active_mesh()
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_moments(moments: torch.Tensor, count: int):
    """Sync-BN: the (2, C) moment sums over the active mesh's ranks and
    the count times its size; ``(moments, count)`` unchanged without one.
    Gradients flow back into every rank's moments."""
    mesh = active_mesh()
    if mesh is None:
        return moments, count
    return all_reduce_sum(moments, mesh), count * mesh.size


def psum_if_sharded(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` (default: the active one),
    without a gradient; ``x`` itself without a multi-rank mesh."""
    mesh = mesh or active_mesh()
    if mesh is None or mesh.size == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def initialize_multihost(backend: str | None = None,
                         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    A single process (no ``WORLD_SIZE``, or 1) and a process already in a
    group do nothing. ``backend`` defaults to NCCL."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch "
                           "with torchrun")
    backend = backend or "nccl"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = _local_card(_local_rank())
    dist.init_process_group(backend, init_method="env://", timeout=timeout, **kw)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _local_card(local_rank: int, shared: bool = False) -> torch.device:
    """The card of ``local_rank``: one card a local rank, or, ``shared``
    (gloo), the local ranks dealt round the cards."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (gloo "
                           "ranks on the CPU) to run there")
    n = torch.cuda.device_count()
    if shared:
        return torch.device("cuda", local_rank % n)
    if local_rank >= n:
        raise RuntimeError(f"local rank {local_rank} has no card: {n} cards "
                           "for more local ranks (NCCL needs one card a rank; "
                           "ask for gloo to share one)")
    return torch.device("cuda", local_rank)


def create_mesh(spec: MeshSpec | None = None,
                devices: Sequence[torch.device | str] | None = None,
                backend: str | None = None) -> Mesh:
    """This process's :class:`Mesh`.

    ``devices``: every rank's device in rank order (default: the card of
    each local rank). A CPU device means gloo; ``backend="gloo"`` with
    cards lets ranks share one (the local ranks dealt round the cards). Under ``torchrun`` the process group
    is joined here (:func:`initialize_multihost`); a process that is in
    one already keeps it; a single process gets a one-rank mesh, which the
    steps treat as one device. Raises where the ranks do not tile
    ``spec``, where ``spec.model`` > 1 (no step shards a model axis),
    where ``devices`` does not give one device a rank, or where a rank's
    card is missing."""
    spec = spec or MeshSpec()
    devs = None if devices is None else [torch.device(d) for d in devices]
    if backend is None:
        backend = "gloo" if devs is not None and devs[0].type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and devs is not None and any(d.type != "cuda" for d in devs):
        raise ValueError("NCCL takes cards only; gloo runs ranks on the CPU")
    initialize_multihost(backend)
    rank = dist.get_rank() if dist.is_initialized() else 0
    size = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized() and dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend}")
    data, model = spec.resolve(size)
    if model != 1:
        raise NotImplementedError("the port's mesh is data-parallel only "
                                  "(model axis 1)")
    if devs is not None:
        if len(devs) != size:
            raise ValueError(f"{len(devs)} devices for {size} ranks")
        device = devs[rank]
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass CPU devices "
                                   "to run there")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = _local_card(_local_rank(), shared=backend == "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, size, dist.group.WORLD if size > 1 else None, device)


def launch_mesh(device: str | torch.device | None = None,
                backend: str | None = None) -> Mesh:
    """The mesh of an entry point run alone or under ``torchrun``:
    ``device="cpu"`` gives gloo ranks on the CPU; anything else (default
    CUDA) one card a local rank over NCCL, or over ``backend="gloo"``
    ranks that may share a card."""
    if device is not None and torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"{backend} does not run on the CPU: gloo does")
        return create_mesh(devices=["cpu"] * int(os.environ.get("WORLD_SIZE", "1")))
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"unknown device {device!r}")
    return create_mesh(backend=backend)


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def host_shard(mesh: Mesh, batch, axis: int = 0):
    """This rank's slice of a host batch (a tuple, list or dict of numpy
    arrays or tensors, nested), split on ``axis`` (0 for plain batches; 1
    for the train step's stacked ``(n_accum, B, ...)`` microbatches),
    still on the host. A size that does not divide by the rank count
    raises JAX's ``ValueError`` (a one-rank mesh takes any size)."""

    def part(x):
        if mesh.size == 1:
            return x
        if x.shape[axis] % mesh.size != 0:
            raise ValueError(
                f"batch axis {axis} has size {x.shape[axis]}, not divisible by "
                f"the data-parallel mesh size {mesh.size}; choose batch_size as a "
                f"multiple of {mesh.size} (shape {tuple(x.shape)})")
        return x[(slice(None),) * axis + (local_batch_slice(x.shape[axis], mesh),)]

    return _map(part, batch)


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """:func:`host_shard`'s slice as tensors on the rank's device."""
    return _map(lambda x: torch.as_tensor(x).to(mesh.device, non_blocking=True),
                host_shard(mesh, batch, axis))


def local_batch_slice(global_batch_size: int, mesh: Mesh | None = None) -> slice:
    """The slice of the global batch this rank is responsible for loading
    (``mesh`` default: the default process group, else one rank)."""
    if mesh is not None:
        rank, size = mesh.rank, mesh.size
    elif dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    per_host = global_batch_size // size
    start = rank * per_host
    return slice(start, start + per_host)


def broadcast_module(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (JAX's replicated
    state), in place."""
    if mesh.size > 1:
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    return box[0]


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on axis 0 in rank
    order: the global batch of a sharded result."""
    if mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)
