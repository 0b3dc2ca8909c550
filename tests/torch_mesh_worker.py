"""One gloo rank of ``tests/test_torch_mesh.py``'s data-parallel runs (no
JAX here): ``python tests/torch_mesh_worker.py RANK WORLD DIR``.

Joins a process group through a ``FileStore`` under ``DIR`` (with a
timeout), reads ``DIR/inputs.pt``, runs each case on this rank's slice of
its global batch through the port's mesh, writes ``DIR/rank<RANK>.pt``.
"""

import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mmr_tpu_torch.core.mesh import create_mesh, gather_batch, shard_batch  # noqa: E402


class Sampler:
    """JAX's ``PatchSampler`` interface over a fixed pool (as
    ``tests/test_torch_engine.py``'s): ``epoch(seed)`` yields ``n``
    global batches of ``batch`` uint8 frames and masks picked by the seed."""

    def __init__(self, images, masks, batch, n):
        self.images, self.masks, self.batch, self.n = images, masks, batch, n

    def __len__(self):
        return self.n

    def epoch(self, epoch_seed):
        rng = np.random.RandomState(epoch_seed)
        for _ in range(self.n):
            idx = rng.randint(0, len(self.images), self.batch)
            yield self.images[idx], self.masks[idx]


def samplers(pool):
    """Two train batches and one validation batch of 2 frames."""
    return Sampler(*pool, 2, 2), Sampler(*pool, 2, 1)


def tiny(state_dict):
    """``tests/test_multichip.py::Tiny``: a 3×3 SAME conv, NHWC in and out,
    with the weights ``state_dict`` (``weight``, ``bias``)."""
    conv = torch.nn.Conv2d(3, state_dict["weight"].shape[0], 3, padding=1)
    conv.load_state_dict(state_dict)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = conv

        def forward(self, x):
            return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()

    return Tiny()


def step_case(mesh, inp, **model_kw):
    """One train step of the UNet++/mbv3 on this rank's half of the batch:
    loss, IoU, the averaged clipped gradient (AdamW's first moment over
    1 − b1) by parameter, and the model's state after the step."""
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    model = create_model(classes=inp["nc"], device="cpu", **model_kw)
    model.load_state_dict(inp["state_dict"])
    opt = build_optimizer("adamw", clip_grad_norm=inp["clip"], weight_decay=1e-2)
    step = make_train_step(model, opt, dice_ce_loss, inp["nc"], mesh=mesh,
                           preprocess=get_preprocessing("tu-mobilenetv3_small_100"))
    images, masks = shard_batch(mesh, (inp["images"], inp["masks"]), axis=1)
    state, m = step(TrainState.create(model, opt), images, masks, inp["lr"])
    g, off = state.opt_state["mu"] / (1.0 - opt.b1), 0
    grads = {}
    for n, p in model.named_parameters():
        grads[n] = g[off:off + p.numel()].view_as(p).clone()
        off += p.numel()
    return {"loss": float(m["loss"]), "iou": float(m["iou"]), "grads": grads,
            "state_dict": model.state_dict()}


def eval_case(mesh, inp):
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.train.steps import make_eval_step

    model = tiny(inp["tiny4"])
    step = make_eval_step(model, dice_ce_loss, 4, mesh=mesh)
    images, masks = shard_batch(mesh, (inp["eval_images"], inp["eval_masks"]))
    return {k: v.clone() for k, v in step(None, images, masks).items()}


def evaluate_case(mesh, inp):
    from mmr_tpu_torch.metrics.evaluate import Evaluate

    ev = Evaluate(5, mesh=mesh)
    for pred, gt in zip(inp["ev_pred"], inp["ev_gt"]):
        ev.add_batch(*shard_batch(mesh, (pred, gt)))
    return {"tp": ev.tp.copy(), "fp": ev.fp.copy(), "fn": ev.fn.copy(),
            "miou": ev.iou()[1]}


def window_case(mesh, inp):
    from mmr_tpu_torch.infer.sliding_window import make_sliding_window_fn

    model = tiny(inp["tiny3"])
    sw = make_sliding_window_fn(model, (16, 16), 3, sw_batch_size=4, mesh=mesh)
    local = sw(inp["frames"])
    return {"local": local.clone(), "all": gather_batch(mesh, local)}


def trainer_case(mesh, inp, out: Path):
    from mmr_tpu_torch.train.engine import Trainer

    cfg = dict(inp["trainer_config"], results_path=str(out / f"run{mesh.size}"))
    tr = Trainer(cfg, mesh=mesh)
    history = tr.train(*samplers(inp["pool"]))
    return {"history": history, "state_dict": tr.model.state_dict()}


def main(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(str(out / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = create_mesh(devices=["cpu"] * world)
        inp = torch.load(out / "inputs.pt", weights_only=False)
        res = {"plain": step_case(mesh, inp, dtype=torch.float32),
               "fused": step_case(mesh, inp, fused=True, fused_frontend=True,
                                  packed_min_hw=0),
               "eval": eval_case(mesh, inp),
               "evaluate": evaluate_case(mesh, inp),
               "window": window_case(mesh, inp),
               "trainer": trainer_case(mesh, inp, out)}
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
