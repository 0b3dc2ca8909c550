"""Training engine, counterpart of ``mmr_tpu/train/engine.py``: the
reference's ``SegModel`` orchestrator (``Main_MMR_SegModel.py:520-1203``)
on one device or on a data-parallel mesh (one process a rank, ``torchrun``).

The epoch loop (``train()``, ``:1076-1203``): train epoch → validation →
monitor (throughput, ETA, memory) → loss curves, metrics JSON and
dashboard → last / best checkpoints → ``loss_dict.pkl`` → prediction
triptychs every ``val_plot_interval`` epochs. The LR schedule steps per
epoch. :meth:`Trainer.maybe_resume` restores the weights, the optimizer
state, the epoch and the loss history from ``last_model``
(``:596-604,958-1001``).

On the card: a background thread stages each batch through pinned memory
on a side stream (:mod:`mmr_tpu_torch.data.pipeline`); the augmentation
runs on the device inside the train step; the per-step losses, IoUs and
the validation's confusion counts stay on the device and are read once an
epoch. Each step's draws come from a generator of (seed, epoch, step), so
a resumed run draws what an uninterrupted one does.

On a multi-rank :class:`~mmr_tpu_torch.core.mesh.Mesh` every rank draws the
same global batches from the same epoch seeds and transfers only its slice
(``engine.py:195-220``); a :class:`~mmr_tpu_torch.data.patch_dataset.
PatchSampler` reads only that slice's windows. The steps run on the mesh.
Rank 0 alone writes the log, checkpoints, metrics JSON, plots, triptychs
(of its own slice's samples) and profiler traces, once, while the other
ranks wait at a barrier; a resume reads ``last_model`` on every rank.
"""

from __future__ import annotations

import pickle
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.core.mesh import (Mesh, broadcast_module, host_shard,
                                    local_batch_slice)
from mmr_tpu_torch.core.precision import resolve as resolve_precision
from mmr_tpu_torch.core.prng import RngStream, seed_everything
from mmr_tpu_torch.data.augment import AugmentConfig
from mmr_tpu_torch.data.patch_dataset import PatchSampler
from mmr_tpu_torch.data.pipeline import (DeviceTransfer, PrefetchIterator,
                                         microbatch_stacker)
from mmr_tpu_torch.losses import dice_ce_loss
from mmr_tpu_torch.models import create_model, get_preprocessing
from mmr_tpu_torch.models.convert import from_jax_variables
from mmr_tpu_torch.models.encoders import get_encoder
from mmr_tpu_torch.monitor import (ProfilerTrace, TrainingMonitor, model_summary,
                                   save_dashboard, save_losses, save_triptychs)
from mmr_tpu_torch.train.checkpoint import CheckpointManager
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.schedules import build_lr_schedule
from mmr_tpu_torch.train.state import TrainState
from mmr_tpu_torch.train.steps import make_eval_step, make_train_step


def _is_unetpp(arch: str) -> bool:
    a = arch.lower()
    return (a.replace("_", "").replace("+", "p") in ("unetplusplus", "unetpp", "smpunetpp")
            or a in ("unetplusplus", "unet++"))


class Trainer:
    """Path B's trainer over ``config`` (:func:`~mmr_tpu_torch.config.
    get_default_config`'s schema, ``results_path`` added) on ``device``
    (``None``: CUDA; ``"cpu"`` to run there), or on ``mesh`` (its rank's
    device; see the module's docstring). As in JAX, ``config["mesh"]`` is
    not read.

    On CUDA, a UNet++ at bf16 with patches of at least 128 over a
    five-level encoder turns ``fused`` on, and over an mbv3 encoder with
    ``w % 128 == 0`` and ``h % 4 == 0`` ``fused_frontend`` too (JAX's
    ``packed`` / ``packed_frontend`` gate, ``engine.py:62-83``, which
    also packs a UNet++ over ConvNeXt or MiT and then returns its logits
    at stride 2: the port leaves that one plain). The config's
    ``model.packed`` / ``model.packed_frontend`` / ``model.packed_min_hw``
    set them, for the smp Unet too (JAX's ``packed=True``); elsewhere the
    plain model runs. ``model.encoder_weights`` (the default config's
    ``imagenet``) loads through ``create_model``: from the offline weight
    store, or, where it holds none, a warning and the random init.
    The samplers have JAX's ``PatchSampler`` interface: ``epoch(epoch_seed)``
    yields (images (B, H, W, 3) uint8 or f32 in [0, 1], masks (B, H, W)
    ints) and ``len()`` counts its batches."""

    def __init__(self, config: dict, mesh: Mesh | None = None, loss_fn=None,
                 device=None):
        self.config = config
        if mesh is not None and device is not None:
            raise ValueError("pass device or mesh, not both")
        self.mesh = mesh or Mesh(0, 1, None, resolve_device(device))
        self.device = self.mesh.device
        self.is_main = self.mesh.rank == 0
        self.results_path = Path(config["results_path"])
        self.results_path.mkdir(parents=True, exist_ok=True)
        self.n_classes = int(config["n_classes"]) + 1  # + background (common_utils.py:236)
        self.n_epochs = int(config["n_epochs"])
        self.patch_size = tuple(config["patch_size"])
        self.n_accum = int(config.get("grad_accumulate_step", 1))

        model_cfg = dict(config["model"])
        arch = model_cfg.pop("arch")
        self.encoder_name = model_cfg.pop("encoder_name", None)
        self.encoder_weights = model_cfg.pop("encoder_weights", None)
        model_cfg.pop("in_channels", None)
        model_cfg.pop("classes", None)
        for jax_name, name in (("packed", "fused"), ("packed_frontend", "fused_frontend")):
            if jax_name in model_cfg:
                model_cfg[name] = model_cfg.pop(jax_name)
        precision = resolve_precision(config.get("precision"))
        # the fused kernels compute in bf16 and exist on the card only
        five_levels = self.encoder_name is None or all(
            get_encoder(self.encoder_name).channels)
        if (_is_unetpp(arch) and self.device.type == "cuda" and five_levels
                and precision.compute_dtype == torch.bfloat16
                and min(self.patch_size) >= 128):
            model_cfg.setdefault("fused", True)
            if (model_cfg.get("fused") and "mobilenetv3" in str(self.encoder_name)
                    and self.patch_size[1] % 128 == 0 and self.patch_size[0] % 4 == 0):
                model_cfg.setdefault("fused_frontend", True)
        self.rng = RngStream(seed_everything(int(config.get("seed", 6210))))
        self.model = create_model(arch, encoder_name=self.encoder_name,
                                  classes=self.n_classes,
                                  dtype=precision.compute_dtype, device=self.device,
                                  generator=self.rng.named("init"),
                                  encoder_weights=self.encoder_weights, **model_cfg)
        self.preprocess = (get_preprocessing(self.encoder_name)
                           if self.encoder_name else None)

        self.loss_fn = loss_fn or dice_ce_loss
        opt_cfg = dict(config.get("optimizer", {"name": "AdamW", "lr": 1e-4}))
        opt_name = opt_cfg.pop("name", "AdamW")
        self.base_lr = float(opt_cfg.pop("lr", 1e-4))
        self.optimizer = build_optimizer(
            opt_name, clip_grad_norm=float(config.get("grad_clip_max_norm", 12.0)),
            differential_lr=bool(config.get("differential_lr", False)), **opt_cfg)
        self.lr_schedule = build_lr_schedule(config.get("lr_scheduler"), self.base_lr,
                                             self.n_epochs)

        aug_cfg = config.get("transformations", {})
        self.augment = AugmentConfig(
            patch_size=self.patch_size,
            rotation=aug_cfg.get("rotation", True),
            scaling=aug_cfg.get("scaling", True),
            gaussian_noise=aug_cfg.get("gaussian_noise", True),
            gaussian_blur=aug_cfg.get("gaussian_blur", True),
            brightness=aug_cfg.get("brightness", True),
            contrast=aug_cfg.get("contrast", True),
            low_resolution=aug_cfg.get("low_resolution", True),
            gamma=aug_cfg.get("gamma", True),
            mirror=aug_cfg.get("mirror", True),
            heavy=aug_cfg.get("heavy_augmentation", False),
            per_sample_spatial=aug_cfg.get("per_sample_spatial", False),
        )

        self.monitor = TrainingMonitor(self.results_path, self.n_epochs,
                                       write=self.is_main)
        if aug_cfg.get("heavy_augmentation") and not aug_cfg.get("per_sample_spatial"):
            # the batch-shared spatial draws differ from the reference's
            # per-sample ones (Pre_Process.py:278-463); say so
            self.monitor.log_message(
                "transformations.heavy_augmentation=True with the default "
                "batch-shared spatial draws — for the reference's exact "
                "per-sample spatial distribution add "
                "--transformations_per_sample_spatial true (slower)",
                level="WARNING")
        if aug_cfg.get("dummy_2d"):
            # the reference's Convert3DTo2D wrapping (Pre_Process.py:339-366)
            # is met by construction on this 2D pipeline
            self.monitor.log_message(
                "transformations.dummy_2d=True: in-plane spatial transforms "
                "are native on this 2D pipeline (no-op by construction)")
        self.checkpoints = CheckpointManager(self.results_path / "checkpoints")
        self.loss_dict: dict[str, list] = {"train": [], "val": []}
        self.start_epoch = 1
        self.state: TrainState | None = None
        self._transfer = DeviceTransfer(self.device)

        self._train_step = make_train_step(
            self.model, self.optimizer, self.loss_fn, self.n_classes,
            n_accum=self.n_accum, augment=self.augment, preprocess=self.preprocess,
            mesh=self.mesh)
        self._eval_step = make_eval_step(self.model, self.loss_fn, self.n_classes,
                                         preprocess=self.preprocess, mesh=self.mesh)

    # ----------------------------------------------------------------- setup
    @torch.no_grad()
    def init_state(self, variables: Mapping | None = None) -> TrainState:
        """The state over the model's weights: those ``create_model`` made
        (the seed's ``init`` stream, the encoder's pretrained weights where
        the store has them), or, given ``variables`` (flax ``{"params",
        "batch_stats"}`` as numpy, e.g. a JAX ``TrainState``'s), those; the
        optimizer state at zero."""
        if variables is not None:
            self.model.load_state_dict(from_jax_variables(variables, self.model))
        broadcast_module(self.mesh, self.model)
        self.state = TrainState.create(self.model, self.optimizer)
        return self.state

    def maybe_resume(self) -> bool:
        """continue_training: restore ``last_model`` and the loss history."""
        if not self.checkpoints.exists("last_model"):
            return False
        if self.state is None:
            self.init_state()
        self.state, meta = self.checkpoints.load(self.state, "last_model")
        self.start_epoch = meta["epoch"] + 1
        pkl = self.results_path / "loss_dict.pkl"
        if pkl.exists():
            self.loss_dict = pickle.loads(pkl.read_bytes())
        self.monitor.log_message(f"Resumed from epoch {meta['epoch']}")
        return True

    # ----------------------------------------------------------------- train
    def _device_batches(self, sampler, epoch: int, train: bool) -> PrefetchIterator:
        """The epoch's batches on the device, staged ahead: images as uint8
        (float images are k/255 values, so the copy is lossless and 4×
        smaller; the steps convert back), masks as uint8 (int32 past 255
        classes); train batches stacked (n_accum, B, ...). On a multi-rank
        mesh, this rank's slice of each (a ``PatchSampler`` yields only
        that)."""
        mask_dtype = np.uint8 if self.n_classes <= 255 else np.int32
        seed = epoch * 7919 + 1 if train else epoch * 104729 + 2
        local = self.mesh.size > 1 and isinstance(sampler, PatchSampler)
        if local:
            if sampler.batch_size % self.mesh.size:
                raise ValueError(
                    f"batch_size {sampler.batch_size} is not divisible by the "
                    f"data-parallel mesh size {self.mesh.size}")
            source = sampler.epoch(epoch_seed=seed, part=local_batch_slice(
                sampler.batch_size, self.mesh))
        else:
            source = sampler.epoch(epoch_seed=seed)

        def transfer(item):
            imgs, masks = item if local else host_shard(self.mesh, item,
                                                        axis=1 if train else 0)
            if imgs.dtype != np.uint8:
                imgs = np.round(np.asarray(imgs) * 255.0).astype(np.uint8)
            return self._transfer((imgs, np.asarray(masks).astype(mask_dtype)))

        if train:
            source = microbatch_stacker(source, self.n_accum)
        return PrefetchIterator(source, transfer, depth=2, ready=self._transfer.ready)

    def train_one_epoch(self, sampler, epoch: int, lr: float):
        losses, ious = [], []
        n_samples = 0
        total = len(sampler) // max(self.n_accum, 1)
        batches = self._device_batches(sampler, epoch, train=True)
        try:
            for images, masks in batches:
                self.state, met = self._train_step(
                    self.state, images, masks, lr, self.rng.step("train", epoch, len(losses)))
                losses.append(met["loss"])
                ious.append(met["iou"])
                n_samples += images.shape[0] * images.shape[1] * self.mesh.size
                if self.config.get("progress_bar") and self.is_main:
                    print(f"\repoch {epoch}: {len(losses)}/{total}", end="",
                          file=sys.stderr, flush=True)
        finally:
            batches.close()
        if self.config.get("progress_bar") and self.is_main:
            print(file=sys.stderr)
        vals = torch.stack([torch.stack(losses), torch.stack(ious)]).double().cpu().numpy()
        return float(np.mean(vals[0])), float(np.mean(vals[1])), n_samples

    def validate_one_epoch(self, sampler, epoch: int, want_samples: bool = False):
        losses, ious, counts, sample = [], [], None, None
        batches = self._device_batches(sampler, epoch, train=False)
        try:
            for images, masks in batches:
                met = self._eval_step(self.state, images, masks)
                losses.append(met["loss"])
                ious.append(met["iou"])
                stats = torch.stack([met["tp"], met["fp"], met["fn"]])
                counts = stats if counts is None else counts + stats
                if want_samples and sample is None:
                    sample = (images, masks, self.predict(images).argmax(-1))
        finally:
            batches.close()
        vals = torch.stack([torch.stack(losses), torch.stack(ious)]).double().cpu().numpy()
        tp, fp, fn = counts.double().cpu().numpy()
        per_class_iou = tp / np.maximum(tp + fp + fn, 1e-15)
        if sample is not None:
            imgs = sample[0].cpu().numpy()
            sample = (imgs.astype(np.float32) / (255.0 if imgs.dtype == np.uint8 else 1.0),
                      sample[1].cpu().numpy(), sample[2].cpu().numpy())
        return float(np.mean(vals[0])), float(np.mean(vals[1])), per_class_iou, sample

    @torch.no_grad()
    def predict(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode logits of an image batch (uint8, or f32 in [0, 1])."""
        self.model.eval()
        img = images.to(self.device)
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        return self.model(self.preprocess(img) if self.preprocess else img)

    def train(self, train_sampler, val_sampler) -> dict:
        if self.state is None:
            self.init_state()
        n_params = sum(p.numel() for p in self.model.parameters())
        self.monitor.log_message(
            f"Model: {self.config['model']} — {n_params / 1e6:.2f}M params")
        # the reference's torchinfo surface (Main_MMR_SegModel.py:1130-1132)
        self.monitor.log_message("Model Architecture Summary:\n"
                                 + model_summary(self.model))
        profile_epochs = self.config.get("profile_epochs") or ()
        self._tracer = ProfilerTrace(self.results_path, epochs=profile_epochs,
                                     enabled=bool(profile_epochs) and self.is_main)
        self.monitor.start_training()
        val_plot_interval = int(self.config.get("val_plot_interval", 5))
        plots_dir = self.results_path / "plots"

        for epoch in range(self.start_epoch, self.n_epochs + 1):
            self.monitor.start_epoch(epoch)
            if self._tracer.maybe_start(epoch):
                self.monitor.log_message(
                    f"torch.profiler trace capturing epoch {epoch} -> {self._tracer.dir}")
            lr = self.lr_schedule(epoch - 1)
            train_loss, train_iou, n_samples = self.train_one_epoch(train_sampler, epoch, lr)
            self._tracer.maybe_stop(epoch)
            want_plot = val_plot_interval > 0 and epoch % val_plot_interval == 0
            val_loss, val_iou, per_class_iou, sample = self.validate_one_epoch(
                val_sampler, epoch, want_samples=want_plot and self.is_main)

            self.loss_dict["train"].append(train_loss)
            self.loss_dict["val"].append(val_loss)
            self.monitor.end_epoch(epoch, train_loss, val_loss, train_iou, val_iou, lr,
                                   n_samples)
            if self.is_main:
                save_losses(self.loss_dict["train"], self.loss_dict["val"], plots_dir)
                self.monitor.save_metrics()
                save_dashboard(self.monitor.history, self.results_path)
                if sample is not None:
                    save_triptychs(*sample, plots_dir / f"epoch_{epoch}.png")
                is_best = self.checkpoints.save(self.state, epoch, val_loss)
                (self.results_path / "loss_dict.pkl").write_bytes(
                    pickle.dumps(self.loss_dict))
                if is_best:
                    self.monitor.log_message(f"New best model (val loss {val_loss:.4f})")
            self.mesh.barrier()
        self.monitor.log_message("Training complete")
        return self.monitor.history
