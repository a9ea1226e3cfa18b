"""Training CLI (port of ``fourierdiffusion_tpu/cli/train.py``).

Usage::

    fdiff-torch-train [group=option | key=value ...]
    e.g. fdiff-torch-train datamodule=synthetic fourier_transform=true
    fdiff-torch-train resume=<run_id> [run_dir=<dir>]

It composes the config (``configs/train.yaml`` and its groups), builds the
datamodule, scheduler and score network, writes the resolved config to
``<run_dir>/<run_id>/train_config.yaml``, asserts that noise scaling
implies the Fourier transform, and fits with the best checkpoint, the
``last`` training state, ``metrics.jsonl`` and the sampling callback.
``resume=<run_id>`` reloads that run's ``train_config.yaml`` as it is and
continues from its ``last`` state. The initial weights are drawn from
``trainer.init_seed``, or else ``random_seed``, which alone sets the
trainer's draws. Everything runs on
``device`` (``cuda`` unless the config says ``cpu``). It prints
``run_id=<id>``.

Several ranks (``torchrun --nproc-per-node=N -m
fourierdiffusion_tpu_torch.cli.train ...``, or the ``FDIFF_*`` variables of
``parallel/distributed.py``) train one run data-parallel, each rank on its
card (``device: cuda`` becomes ``cuda:LOCAL_RANK``), when the batch divides
over them (else each trains the whole batch). They agree on the run id
without talking (``FDIFF_RUN_ID``, else ``mh-<seed>``; no wandb), and the
primary rank writes the run directory, its config, metrics and checkpoints.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Any, Optional

from fourierdiffusion_tpu_torch import resolve_device
from fourierdiffusion_tpu_torch.parallel import auto_data_mesh, distributed
from fourierdiffusion_tpu_torch.training.callbacks import SamplingCallback
from fourierdiffusion_tpu_torch.training.trainer import Trainer
from fourierdiffusion_tpu_torch.utils.checkpoint import BestCheckpointCallback
from fourierdiffusion_tpu_torch.utils.config import (
    compose,
    dict_to_str,
    load_config,
    save_config,
)
from fourierdiffusion_tpu_torch.utils.instantiate import (
    build_datamodule,
    build_model_config,
    build_scheduler,
)
from fourierdiffusion_tpu_torch.utils.logging import (
    JsonlWriter,
    MultiWriter,
    maybe_initialize_wandb,
)
from fourierdiffusion_tpu_torch.utils.profiling import trace_if_enabled

logger = logging.getLogger(__name__)


class TrainingRunner:
    def __init__(self, cfg: dict, run_id: Optional[str] = None) -> None:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
        logger.info("Training config:\n%s", dict_to_str(cfg))
        self.cfg = cfg
        self.device = distributed.rank_device() or resolve_device(cfg.get("device", "cuda"))
        primary = distributed.is_primary()
        seed = int(cfg.get("random_seed", 42))

        wandb_writer = None
        if run_id is None:
            if distributed.world_size() > 1:
                # Every rank derives the same id; wandb stays off.
                run_id = os.environ.get("FDIFF_RUN_ID", f"mh-{seed:06d}")
            else:
                wandb_writer, run_id = maybe_initialize_wandb(cfg)
        self.run_id = run_id
        self.run_dir = Path(cfg.get("run_dir", "runs")) / run_id
        if primary:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            save_config(cfg, self.run_dir / "train_config.yaml")
            logger.info("Run directory: %s", self.run_dir)

        self.datamodule = build_datamodule(cfg["datamodule"])
        self.datamodule.prepare_data()
        self.datamodule.setup("fit")

        self.scheduler = build_scheduler(cfg["score_model"]["noise_scheduler"])
        params = self.datamodule.dataset_parameters
        trainer_cfg = cfg["trainer"]
        # trainer.init_seed changes only the initial weights.
        init_seed = trainer_cfg.get("init_seed")
        self.model = build_model_config(cfg["score_model"]).build(
            n_channels=params["n_channels"], max_len=params["max_len"],
            seed=seed if init_seed is None else int(init_seed),
        )

        mesh = auto_data_mesh(self.datamodule.batch_size)
        if mesh is not None:
            logger.info("Data-parallel over %d ranks", mesh.size)
        writer = MultiWriter(JsonlWriter(self.run_dir), wandb_writer) if primary else None
        max_epochs = int(trainer_cfg["max_epochs"])
        callbacks: list = [BestCheckpointCallback(self.run_dir / "checkpoints")]
        sampling_cfg = trainer_cfg.get("callbacks", {}).get("sampling", {})
        if sampling_cfg.get("enabled", False):
            callbacks.append(
                SamplingCallback(
                    self.model,
                    self.scheduler,
                    self.datamodule,
                    every_n_epochs=int(sampling_cfg.get("every_n_epochs", 10)),
                    sample_batch_size=int(sampling_cfg.get("sample_batch_size", 64)),
                    num_samples=int(sampling_cfg.get("num_samples", 200)),
                    num_diffusion_steps=int(sampling_cfg.get("num_diffusion_steps", 1000)),
                    num_directions=int(sampling_cfg.get("num_directions", 200)),
                    random_seed=seed,
                    metrics_writer=writer,
                    device=self.device,
                    mesh=mesh,
                )
            )

        self.trainer = Trainer(
            self.model,
            self.scheduler,
            max_epochs=max_epochs,
            lr_max=float(cfg["score_model"]["lr_max"]),
            gradient_clip_val=float(trainer_cfg.get("gradient_clip_val", 1.0)),
            likelihood_weighting=bool(cfg["score_model"].get("likelihood_weighting", False)),
            seed=seed,
            ema_decay=float(trainer_cfg.get("ema_decay", 0.0)),
            spike_rollback_factor=float(trainer_cfg.get("spike_rollback_factor", 2.5)),
            spike_rollback_retries=int(trainer_cfg.get("spike_rollback_retries", 2)),
            val_noise_draws=int(trainer_cfg.get("val_noise_draws", 4)),
            callbacks=tuple(callbacks),
            metrics_writer=writer,
            save_last_dir=self.run_dir / "checkpoints",
            save_last_every_n=int(trainer_cfg.get("save_last_every_n", 1)),
            accumulate_grad_batches=int(trainer_cfg.get("accumulate_grad_batches", 1)),
            perm_salt=int(trainer_cfg.get("perm_salt", 0)),
            device=self.device,
            mesh=mesh,
        )

    def train(self, resume_from: Optional[Path] = None) -> Any:
        # Noise scaling without the Fourier transform would whiten the
        # wrong domain (the reference's guard).
        assert not (
            self.cfg["score_model"]["fourier_noise_scaling"]
            and not self.datamodule.fourier_transform
        ), "You cannot use noise scaling without the Fourier transform."
        with trace_if_enabled("train"):
            return self.trainer.fit(self.datamodule, resume_from=resume_from)


def init_distributed(cfg: dict) -> bool:
    """Join the process group the environment describes, before anything
    touches a device: ``device: cuda`` puts each rank on its own card, any
    other value on that device."""
    device = str(cfg.get("device", "cuda"))
    return distributed.maybe_initialize_distributed(device=None if device == "cuda" else device)


def main(argv: Optional[list[str]] = None) -> None:
    overrides = list(sys.argv[1:] if argv is None else argv)
    # `resume=<run_id>` continues a run from its saved training state, with
    # the config reloaded from the run directory as it is.
    resume_id = None
    for ov in list(overrides):
        if ov.startswith("resume="):
            resume_id = ov.split("=", 1)[1]
            overrides.remove(ov)
    if resume_id is not None:
        run_dir_root = "runs"
        for ov in overrides:
            if ov.startswith("run_dir="):
                run_dir_root = ov.split("=", 1)[1]
        cfg = load_config(Path(run_dir_root) / resume_id / "train_config.yaml")
        init_distributed(cfg)
        runner = TrainingRunner(cfg, run_id=resume_id)
        last = runner.run_dir / "checkpoints" / "last"
        runner.train(resume_from=last if last.exists() else None)
    else:
        cfg = compose("train", overrides)
        init_distributed(cfg)
        runner = TrainingRunner(cfg)
        runner.train()
    print(f"run_id={runner.run_id}")


if __name__ == "__main__":
    main()
