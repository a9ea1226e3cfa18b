"""Training loop (port of ``fourierdiffusion_tpu/training/trainer.py``).

``Trainer.fit(datamodule)`` trains a score network (``ScoreTransformer``,
``ScoreMLP`` or ``ScoreLSTM``) in place:

* each epoch draws a wrap-around permutation of the training split
  (``ceil(n / B)`` steps of ``B`` series);
* each step draws ``t`` and ``z``, takes the DSM loss through the score
  network in training mode, clips the gradient to global norm
  ``gradient_clip_val`` and applies AdamW with the warmup-cosine schedule
  (``training/optim.py``), then the EMA. A ``ScoreTransformer`` runs one
  of two paths, chosen as JAX's ``_use_fused_train`` does from
  ``FDIFF_FUSED_TRAIN``: unset or ``1``, the fused path
  (``fused_score_training_forward``, one dropout seed per layer drawn per
  step; on the card every layer runs the training kernels B3 forward and
  B4 backward); ``0``, the unfused path (the module's own forward in
  training mode, drawing its dropout from the step's generator; on the
  card its attention runs B6 forward and backward, or B2 and B5 at rate 0).
  The MLP and LSTM, which have no fused layer, always take the unfused
  path (the MLP's dropouts draw from the step's generator; no kernel);
* after each epoch the validation loss is the mean over ``val_noise_draws``
  fixed draws of ``(t, z)``, drawn once per ``fit`` and reused every epoch,
  of the loss over the batches ``arange(ceil(n / B) * B) % n``, computed by
  the module's own forward with the EMA weights when EMA is on (on the card
  its attention runs the kernel B2);
* the loss-spike rollback guard of the JAX trainer: when an epoch's train
  loss is not finite or exceeds ``spike_rollback_factor`` times the median
  of the last (up to 10) epochs, with at least 5 recorded, the state
  rewinds to the older of two snapshots and training continues under a
  perturbed random stream, at most ``spike_rollback_retries`` times;
* each epoch's ``steps_per_sec`` is its steps over the seconds from the
  start of the epoch through validation and the guard, as in JAX;
  ``train_seconds`` and ``val_seconds``, the two parts, stay in the
  history ``fit`` returns;
* after each epoch its record goes to ``metrics_writer`` with the JAX
  trainer's keys (rollbacks too),
  the ``callbacks`` are called with the eval weights, and the full training
  state is written to ``save_last_dir/last`` every ``save_last_every_n``
  epochs and at the final one; ``fit(resume_from=<last dir>)`` continues
  from it;
* ``accumulate_grad_batches`` averages the gradients of that many steps
  before each optimiser update (``training/optim.py::MultiSteps``); the
  step count and the EMA advance on every step, as in JAX;
* ``perm_salt`` changes only the epoch order.

Random draws come from ``torch.Generator``s seeded with ``seed``; they
differ from ``jax.random``'s, so the parity tests hand the JAX draws in
through ``loss_and_grads``/``train_step``. Each epoch's streams are set by
``(seed, epoch, stream salt)`` and the validation draws by ``seed`` alone,
so a run resumed from ``last`` continues bit for bit as the uninterrupted
run would have (on the CPU; on the card as far as its kernels repeat).

A model of ``dtype`` bfloat16 trains as JAX's does: its parameters, the
clip, AdamW, the EMA, the rollback guard and the all-reduced gradients
stay fp32, the DSM loss takes the score in fp32, and the score network
computes in bf16 on every path: on the fused path B3 and B4 in bf16; on
the unfused path (``FDIFF_FUSED_TRAIN=0``) the module's attention through
B6 in bf16, or B2's fast form and B5 in bf16 at a rate of 0; the MLP in
plain PyTorch and the LSTM on ``torch.lstm`` (cuDNN on the card), neither
with a kernel, as in JAX; the validation forward's attention through B2's
fast bf16 form.

With ``mesh=`` (``parallel/mesh.py``) the run is data-parallel over the
ranks of the process group and computes what the one-process run computes:
every rank holds the whole state and data, draws every batch-led tensor at
the global batch and keeps its rows (``B / W`` of each training and
validation batch), shifts each layer's dropout seed to its first chain, and
averages the gradients over the ranks in one all-reduce per step before
``MultiSteps``, the clip and AdamW. The epoch's train and validation losses
are averaged over the ranks before the rollback guard, so every rank takes
the same branch; the metrics writer, the best checkpoint and ``last`` are
written by the primary rank, which all ranks wait for after ``last``.
"""

from __future__ import annotations

import logging
import math
import os
import statistics
import time
from collections import deque
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from fourierdiffusion_tpu_torch import resolve_device
from fourierdiffusion_tpu_torch.data.batch import DiffusableBatch
from fourierdiffusion_tpu_torch.data.datamodules import Datamodule
from fourierdiffusion_tpu_torch.losses import draw_loss_noise, sde_loss
from fourierdiffusion_tpu_torch.models.attention import SEED_MAX
from fourierdiffusion_tpu_torch.models.fused import fused_score_training_forward
from fourierdiffusion_tpu_torch.models.score_models import ScoreNetwork, ScoreTransformer
from fourierdiffusion_tpu_torch.parallel import distributed
from fourierdiffusion_tpu_torch.parallel.mesh import DataMesh, ShardedGenerator, Stream
from fourierdiffusion_tpu_torch.schedulers.sde import SDE
from fourierdiffusion_tpu_torch.training.optim import (
    MultiSteps,
    cosine_warmup_schedule,
    make_optimizer,
)
from fourierdiffusion_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

logger = logging.getLogger(__name__)

# Epoch-record keys the JAX trainer does not write: kept in ``fit``'s
# history, left out of the metrics writer's records.
HISTORY_ONLY = ("train_seconds", "val_seconds")


def use_fused_train() -> bool:
    """The fused training path unless ``FDIFF_FUSED_TRAIN=0`` (JAX's
    ``_use_fused_train``; the port takes the fused path on any device)."""
    return os.environ.get("FDIFF_FUSED_TRAIN") != "0"


class Trainer:
    """Fits a score network (moved to ``device``) on a datamodule.

    ``plain=True`` runs the plain PyTorch versions instead of the kernels,
    with the same seeds, masks and draws: a check of the kernels on the card
    (each training layer's plain version on the fused path, the attention's
    on the unfused path).

    Callbacks are called after each epoch as ``cb(trainer, epoch, params,
    constants, metrics)``: ``params`` the eval weights (the EMA where it is
    on) and ``constants`` the buffers, both name -> tensor. Under a ``mesh`` every
    rank calls them. The device defaults to the mesh's, else CUDA.
    """

    def __init__(
        self,
        model: ScoreNetwork,
        scheduler: SDE,
        *,
        max_epochs: int = 200,
        lr_max: float = 1e-3,
        gradient_clip_val: float = 1.0,
        likelihood_weighting: bool = False,
        seed: int = 42,
        ema_decay: float = 0.0,
        spike_rollback_factor: float = 2.5,
        spike_rollback_retries: int = 2,
        val_noise_draws: int = 4,
        callbacks: tuple = (),
        metrics_writer=None,
        save_last_dir: Optional[Path] = None,
        save_last_every_n: int = 1,
        accumulate_grad_batches: int = 1,
        perm_salt: int = 0,
        device: str | torch.device | None = None,
        plain: bool = False,
        mesh: Optional[DataMesh] = None,
    ) -> None:
        self.device = mesh.place(device) if mesh is not None else resolve_device(device or "cuda")
        self.mesh = mesh
        self.model = model.to(self.device)
        self.scheduler = scheduler
        self.max_epochs = max_epochs
        self.lr_max = lr_max
        self.gradient_clip_val = gradient_clip_val
        self.likelihood_weighting = likelihood_weighting
        self.seed = seed
        self.ema_decay = float(ema_decay)
        self.spike_rollback_factor = float(spike_rollback_factor)
        self.spike_rollback_retries = int(spike_rollback_retries)
        self.val_noise_draws = max(1, int(val_noise_draws))
        self.callbacks = tuple(callbacks)
        self.metrics_writer = metrics_writer
        self.save_last_dir = save_last_dir
        self.save_last_every_n = max(1, int(save_last_every_n))
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.perm_salt = int(perm_salt)
        self.plain = plain
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.num_training_steps = 0
        self.step = 0
        self.optimizer = None
        self.ema: dict[str, torch.Tensor] = {}
        self.history: list[dict] = []

    # -- one step ---------------------------------------------------------------
    def fused(self) -> bool:
        """Whether steps take the fused path: a ``ScoreTransformer`` unless
        ``FDIFF_FUSED_TRAIN=0``."""
        return use_fused_train() and isinstance(self.model, ScoreTransformer)

    def start(self, num_training_steps: int) -> None:
        """Fresh optimiser state, EMA and step count for a run of this length."""
        self.num_training_steps = num_training_steps
        self.optimizer = make_optimizer(
            self.params, self.lr_max, num_training_steps,
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
        )
        self.step = 0
        self.ema = (
            {n: p.detach().clone() for n, p in zip(self.names, self.params)}
            if self.ema_decay > 0.0 else {}
        )

    def train_loss(
        self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
        layer_seeds: list[int] | None = None, *, generator: Stream = None,
    ) -> torch.Tensor:
        """DSM loss of one batch in training mode: on the fused path with one
        dropout seed per layer (``layer_seeds``), on the unfused path with
        the dropout drawn from ``generator`` (on the model's device)."""
        if self.fused():
            if layer_seeds is None:
                raise ValueError("the fused training path needs layer_seeds")

            def score_fn(b: DiffusableBatch) -> torch.Tensor:
                return fused_score_training_forward(
                    self.model, b.X, b.timesteps, layer_seeds, plain=self.plain
                )
        else:
            self.model.train()

            def score_fn(b: DiffusableBatch) -> torch.Tensor:
                return self.model(b.X, b.timesteps, generator, plain=self.plain)

        return sde_loss(
            score_fn, self.scheduler, DiffusableBatch(X=x, timesteps=t), z=z,
            likelihood_weighting=self.likelihood_weighting,
        )

    def loss_and_grads(
        self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
        layer_seeds: list[int] | None = None, *, generator: Stream = None,
    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        loss = self.train_loss(x, t, z, layer_seeds, generator=generator)
        return loss.detach(), list(torch.autograd.grad(loss, self.params))

    def train_step(
        self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
        layer_seeds: list[int] | None = None, *, generator: Stream = None,
    ) -> torch.Tensor:
        """Loss, gradients, clipped AdamW update (on every
        ``accumulate_grad_batches``-th step) and EMA; returns the loss.
        Under a mesh ``x``, ``t``, ``z`` are this rank's rows and
        ``layer_seeds`` its shifted seeds (``draw_layer_seeds``); the gradients
        are averaged over the ranks and the loss is this rank's."""
        loss, grads = self.loss_and_grads(x, t, z, layer_seeds, generator=generator)
        if self.mesh is not None:
            grads = distributed.all_reduce_mean(grads)
        self.optimizer.step(grads)
        if self.ema_decay > 0.0:
            t_ema = float(self.step + 1)
            d = min(self.ema_decay, (1.0 + t_ema) / (10.0 + t_ema))
            with torch.no_grad():
                for n, p in zip(self.names, self.params):
                    self.ema[n].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        return loss

    def eval_params(self) -> dict[str, torch.Tensor]:
        """The weights validation uses: the EMA when it is on."""
        if self.ema_decay > 0.0:
            return dict(self.ema)
        return {n: p.detach() for n, p in zip(self.names, self.params)}

    @torch.no_grad()
    def val_loss(self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """DSM loss of one batch through the module's forward in eval mode
        (no dropout)."""
        state = {**self.eval_params(), **dict(self.model.named_buffers())}
        self.model.eval()

        def score_fn(b: DiffusableBatch) -> torch.Tensor:
            return torch.func.functional_call(self.model, state, (b.X, b.timesteps))

        return sde_loss(
            score_fn, self.scheduler, DiffusableBatch(X=x, timesteps=t), z=z,
            likelihood_weighting=self.likelihood_weighting,
        )

    # -- state snapshots for the rollback guard ------------------------------------------
    def _snapshot(self) -> dict:
        return {
            "params": [p.detach().clone() for p in self.params],
            "opt": self.optimizer.state_dict(),
            "ema": {n: e.clone() for n, e in self.ema.items()},
            "step": self.step,
        }

    @torch.no_grad()
    def _restore(self, snap: dict) -> None:
        for p, s in zip(self.params, snap["params"]):
            p.copy_(s)
        self.optimizer.load_state_dict(snap["opt"])
        self.ema = {n: e.clone() for n, e in snap["ema"].items()}
        self.step = snap["step"]

    # -- the full training state, for the ``last`` checkpoint --------------------------
    def _named(self, tensors: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, tensors))

    def _ordered(self, named: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
        return [named[n] for n in self.names]

    def train_state(self) -> dict[str, Any]:
        """Params, buffers, EMA, optimiser state and step, name-keyed (the
        layout of ``utils/checkpoint.py``)."""
        opt = self.optimizer.state_dict()
        accumulating = isinstance(self.optimizer, MultiSteps)
        adam = opt["inner"] if accumulating else opt
        adam = {"count": adam["count"], "mu": self._named(adam["mu"]),
                "nu": self._named(adam["nu"])}
        opt_state = {"mini_step": opt["mini_step"], "gradient_step": opt["gradient_step"],
                     "acc": self._named(opt["acc"]), "inner": adam} if accumulating else adam
        return {
            "params": {n: p.detach() for n, p in zip(self.names, self.params)},
            "constants": dict(self.model.named_buffers()),
            "ema_params": dict(self.ema),
            "opt_state": opt_state,
            "step": self.step,
        }

    @torch.no_grad()
    def load_train_state(self, state: Mapping[str, Any]) -> None:
        """Put a ``train_state()`` back (after ``start``)."""
        for p, src in zip(self.params, self._ordered(state["params"])):
            p.copy_(src)
        for name, buf in self.model.named_buffers():
            buf.copy_(state["constants"][name])
        opt = state["opt_state"]
        accumulating = isinstance(self.optimizer, MultiSteps)
        if accumulating != ("acc" in opt):
            raise ValueError(
                "the saved optimiser state and accumulate_grad_batches="
                f"{self.accumulate_grad_batches} disagree"
            )
        adam = opt["inner"] if accumulating else opt
        adam = {"count": adam["count"], "mu": self._ordered(adam["mu"]),
                "nu": self._ordered(adam["nu"])}
        self.optimizer.load_state_dict({
            "mini_step": opt["mini_step"], "gradient_step": opt["gradient_step"],
            "acc": self._ordered(opt["acc"]), "inner": adam} if accumulating else adam)
        if self.ema_decay > 0.0:
            if not state["ema_params"]:
                raise ValueError("the saved state has no EMA, but ema_decay is on")
            self.ema = {n: state["ema_params"][n].to(self.device).clone() for n in self.names}
        self.step = int(state["step"])

    # -- fit ------------------------------------------------------------------------------
    @staticmethod
    def epoch_permutation(n: int, batch_size: int, generator: torch.Generator,
                          salt_seed: Optional[int] = None) -> torch.Tensor:
        """(steps, B) wrap-around permutation covering every sample. With
        ``salt_seed`` the order is permuted again by a generator of that
        seed, and ``generator`` advances as it does without it."""
        steps = -(-n // batch_size)
        perm = torch.randperm(n, generator=generator)
        if salt_seed is not None:
            perm = perm[torch.randperm(n, generator=torch.Generator().manual_seed(salt_seed))]
        pad = steps * batch_size - n
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        return perm.reshape(steps, batch_size)

    @staticmethod
    def val_batches(n: int, batch_size: int) -> torch.Tensor:
        """Validation batches ``arange(ceil(n / B) * B) % n``, (steps, B)."""
        return (torch.arange(-(-n // batch_size) * batch_size) % n).reshape(-1, batch_size)

    def draw_layer_seeds(self, generator: torch.Generator, batch: int) -> list[int]:
        """One dropout seed per layer from ``generator`` (the fused path's
        draw); under a mesh shifted to this rank's first chain of its
        ``batch`` rows, so the hashed masks are those of the global chains."""
        seeds = torch.randint(0, SEED_MAX, (self.model.num_layers,), generator=generator)
        if self.mesh is not None:
            seeds = self.mesh.chain_seed(seeds, batch)
        return seeds.tolist()

    def _rows(self, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """This rank's rows of each global-batch tensor (all of them without
        a mesh)."""
        if self.mesh is None:
            return tensors
        rows = self.mesh.rows(tensors[0].shape[0])
        return tuple(t[rows] for t in tensors)

    def _mean_over_ranks(self, *values: torch.Tensor) -> list[float]:
        """Each scalar averaged over the ranks (as it is without a mesh), in
        one all-reduce: the same floats on every rank."""
        stacked = torch.stack([v.double() for v in values])
        if self.mesh is not None:
            stacked = distributed.all_reduce_mean([stacked])[0]
        return stacked.tolist()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _epoch_seed(self, epoch: int, stream_salt: int) -> int:
        # Each epoch's streams are set by (seed, epoch, salt), so a rewound
        # epoch under a new salt sees fresh draws, and a resumed run the
        # draws it would have seen.
        return self.seed + 1_000_003 * (epoch + 1) + 7_919 * stream_salt

    def fit(self, datamodule: Datamodule, *, resume_from: Optional[Path] = None) -> list[dict]:
        """Train for ``max_epochs``; returns the per-epoch metrics.

        ``resume_from`` (a ``last`` directory) restores the whole training
        state and continues at the epoch after the saved one.
        """
        x_train = datamodule.train_arrays().standardized().to(self.device)
        x_val = datamodule.val_arrays().standardized().to(self.device)
        n, bsz = x_train.shape[0], datamodule.batch_size
        steps_per_epoch = datamodule.steps_per_epoch
        # The schedule's length counts optimiser updates, not steps.
        self.start(steps_per_epoch * self.max_epochs // self.accumulate_grad_batches)
        schedule = cosine_warmup_schedule(self.lr_max, self.num_training_steps)
        start_epoch = 0
        if resume_from is not None:
            state, start_epoch = restore_train_state(resume_from)
            self.load_train_state(state)
            logger.info("Resumed training state from %s (epoch %d)", resume_from, start_epoch)

        host_gen = torch.Generator().manual_seed(self.seed)
        dev_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # The unfused path's dropouts: at the global batch, cut to the rows.
        stream = dev_gen if self.mesh is None else ShardedGenerator(dev_gen, self.mesh)
        val_idx = self.val_batches(x_val.shape[0], bsz).to(self.device)
        val_draws = [
            [self._rows(x_val[idx], *draw_loss_noise(self.scheduler, x_val[idx], dev_gen))
             for idx in val_idx]
            for _ in range(self.val_noise_draws)
        ]

        history: list[dict] = []
        guard_on = self.spike_rollback_factor > 0.0
        snapshots: deque = deque(maxlen=2)
        recent: deque = deque(maxlen=10)
        stream_salt = rollbacks_used = 0
        epoch = start_epoch
        while epoch < self.max_epochs:
            epoch_seed = self._epoch_seed(epoch, stream_salt)
            host_gen.manual_seed(epoch_seed)
            dev_gen.manual_seed(epoch_seed + 1)
            salt_seed = epoch_seed + 104_729 * self.perm_salt if self.perm_salt else None
            perm = self.epoch_permutation(n, bsz, host_gen, salt_seed).to(self.device)
            if guard_on:
                snapshots.append((epoch, self._snapshot()))
            t0 = time.perf_counter()
            losses = []
            fused = self.fused()
            for idx in perm:
                x = x_train[idx]
                x, t, z = self._rows(x, *draw_loss_noise(self.scheduler, x, dev_gen))
                if fused:
                    seeds = self.draw_layer_seeds(host_gen, len(x))
                    losses.append(self.train_step(x, t, z, seeds))
                else:
                    losses.append(self.train_step(x, t, z, generator=stream))
            train_loss = torch.stack(losses).mean()
            self._sync()
            train_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            val_loss = torch.stack([
                torch.stack([self.val_loss(x, t, z) for x, t, z in draws]).mean()
                for draws in val_draws
            ]).mean()
            train_loss, val_loss = self._mean_over_ranks(train_loss, val_loss)
            val_s = time.perf_counter() - t1
            if (
                guard_on
                and len(recent) >= 5
                and (
                    not math.isfinite(train_loss)
                    or train_loss > self.spike_rollback_factor * statistics.median(recent)
                )
            ):
                if rollbacks_used < self.spike_rollback_retries:
                    rollbacks_used += 1
                    stream_salt += 1
                    rewind_epoch, snap = snapshots.popleft()
                    snapshots.clear()
                    logger.warning(
                        "loss spike at epoch %d (train/loss=%.4g vs recent median %.4g): "
                        "rolling back to epoch %d with a perturbed random stream "
                        "(rollback %d/%d)", epoch, train_loss, statistics.median(recent),
                        rewind_epoch, rollbacks_used, self.spike_rollback_retries,
                    )
                    if self.metrics_writer is not None and distributed.is_primary():
                        self.metrics_writer.log(
                            {"rollback_from_epoch": epoch, "rollback_to_epoch": rewind_epoch,
                             "spike_train_loss": train_loss},
                            step=int(snap["step"]),
                        )
                    self._restore(snap)
                    history = [h for h in history if h["epoch"] < rewind_epoch]
                    epoch = rewind_epoch
                    continue
                logger.warning(
                    "loss spike at epoch %d persists after %d rollbacks; continuing "
                    "without intervention", epoch, rollbacks_used,
                )
            recent.append(train_loss)
            epoch_s = time.perf_counter() - t0
            metrics = {
                "train/loss": train_loss,
                "val/loss": val_loss,
                "lr": schedule(self.step),
                "epoch": epoch,
                "step": self.step,
                "train_seconds": train_s,
                "val_seconds": val_s,
                "steps_per_sec": steps_per_epoch / epoch_s,
            }
            if stream_salt:
                metrics["stream_salt"] = stream_salt
            history.append(metrics)
            if self.metrics_writer is not None and distributed.is_primary():
                self.metrics_writer.log(
                    {k: v for k, v in metrics.items() if k not in HISTORY_ONLY}, step=self.step)
            if epoch % 10 == 0 or epoch + 1 == self.max_epochs:
                logger.info(
                    "epoch %d: train/loss=%.4f val/loss=%.4f lr=%.2e (%.2fs)",
                    epoch, train_loss, val_loss, metrics["lr"], epoch_s,
                )
            if self.callbacks:
                params = self.eval_params()
                constants = dict(self.model.named_buffers())
                for cb in self.callbacks:
                    cb(self, epoch, params, constants, metrics)
            if self.save_last_dir is not None and (
                epoch % self.save_last_every_n == 0 or epoch + 1 == self.max_epochs
            ):
                if distributed.is_primary():
                    save_train_state(self.save_last_dir, self.train_state(), epoch)
                distributed.barrier()
            epoch += 1
        self.history = history
        return history


__all__ = ["SEED_MAX", "Trainer", "use_fused_train"]
