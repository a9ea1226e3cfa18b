"""Sampling and evaluation CLI (port of ``fourierdiffusion_tpu/cli/sample.py``).

Usage::

    fdiff-torch-sample model_id=<run_id> [num_samples=10000 num_diffusion_steps=1000 ...]

It reloads the run's ``train_config.yaml`` as the source of truth,
rebuilds the datamodule and the score network (its compute dtype from the
run's ``score_model.dtype``), restores the best checkpoint (lowest recorded
validation loss) or, with ``checkpoint=last``, the final training state's
eval weights, samples with ``DiffusionSampler`` (on CUDA every layer of
every step runs the kernel B1, or B7/B8 under ``FDIFF_FUSED_INT8``),
un-standardises, maps frequency-domain samples back with ``idft``, scores
them with the metric collection (baselines and spectral density as the
``metrics`` group says) and the divergent-chain census, and writes
``sample_config.yaml``, ``results.yaml`` and ``samples.npy`` into the run
directory. It runs on ``device`` (``cuda`` unless the config says ``cpu``).

Several ranks (launched as for ``fdiff-torch-train``) split the chains of
each batch between them when ``sampler.sample_batch_size`` divides over
them, and the primary rank writes the files.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fourierdiffusion_tpu_torch import resolve_device
from fourierdiffusion_tpu_torch.cli.train import init_distributed
from fourierdiffusion_tpu_torch.parallel import auto_data_mesh, distributed
from fourierdiffusion_tpu_torch.sampling.metrics import (
    MarginalWasserstein,
    MetricCollection,
    SlicedWasserstein,
)
from fourierdiffusion_tpu_torch.sampling.sampler import DiffusionSampler
from fourierdiffusion_tpu_torch.utils import yamlio
from fourierdiffusion_tpu_torch.utils.census import census_fields
from fourierdiffusion_tpu_torch.utils.checkpoint import (
    get_best_checkpoint,
    load_checkpoint,
    load_last_checkpoint,
)
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
from fourierdiffusion_tpu_torch.utils.profiling import trace_if_enabled

logger = logging.getLogger(__name__)


def _optional_float(value) -> Optional[float]:
    return float(value) if value not in (None, "null") else None


class SamplingRunner:
    def __init__(self, cfg: dict) -> None:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
        logger.info("Sampling config:\n%s", dict_to_str(cfg))
        self.cfg = cfg
        self.device = distributed.rank_device() or resolve_device(cfg.get("device", "cuda"))
        self.save_dir = Path(cfg["model_path"]) / str(cfg["model_id"])
        if not self.save_dir.exists():
            raise FileNotFoundError(f"Run directory {self.save_dir} not found")
        if distributed.is_primary():
            save_config(cfg, self.save_dir / "sample_config.yaml")

        train_cfg = load_config(self.save_dir / "train_config.yaml")
        self.datamodule = build_datamodule(train_cfg["datamodule"])
        self.datamodule.prepare_data()
        self.datamodule.setup()

        self.num_samples = int(cfg["num_samples"])
        self.num_diffusion_steps = int(cfg["num_diffusion_steps"])

        # best: the lowest recorded validation loss; last: the final epoch's
        # eval weights.
        which = self.checkpoint_kind = str(cfg.get("checkpoint", "best"))
        if which == "last":
            logger.info("Restoring last (final-epoch) checkpoint")
            state = load_last_checkpoint(self.save_dir / "checkpoints")
        elif which == "best":
            ckpt_path = get_best_checkpoint(self.save_dir / "checkpoints")
            logger.info("Restoring %s", ckpt_path)
            state = load_checkpoint(ckpt_path)
        else:
            raise ValueError(f"checkpoint must be 'best' or 'last', got {which!r}")

        self.scheduler = build_scheduler(train_cfg["score_model"]["noise_scheduler"])
        params = self.datamodule.dataset_parameters
        self.model = build_model_config(train_cfg["score_model"]).build(
            n_channels=params["n_channels"], max_len=params["max_len"]
        )
        self.model.load_state_dict(state)

        s_cfg = cfg["sampler"]
        batch = int(s_cfg["sample_batch_size"])
        self.sampler = DiffusionSampler(
            self.model,
            self.scheduler,
            max_len=params["max_len"],
            n_channels=params["n_channels"],
            sample_batch_size=batch,
            method=str(s_cfg.get("method", "em")),
            corrector_steps=int(s_cfg.get("corrector_steps", 1)),
            snr=float(s_cfg.get("snr", 0.16)),
            score_clip=_optional_float(s_cfg.get("score_clip")),
            divergence_threshold=_optional_float(s_cfg.get("divergence_threshold")),
            max_resample_retries=int(s_cfg.get("max_resample_retries", 2)),
            device=self.device,
            mesh=auto_data_mesh(batch),
        )

        seed = int(cfg.get("random_seed", 42))
        self.train_seed = int(train_cfg.get("random_seed", 42))
        m_cfg = cfg["metrics"]
        save_all = bool(m_cfg.get("save_all_distances", True))
        self.metrics = MetricCollection(
            metric_factories=[
                lambda o: SlicedWasserstein(
                    o, random_seed=seed, num_directions=int(m_cfg.get("num_directions", 1000)),
                    save_all_distances=save_all, device=self.device,
                ),
                lambda o: MarginalWasserstein(
                    o, random_seed=seed, save_all_distances=save_all, device=self.device,
                ),
            ],
            original_samples=self.datamodule.X_train,
            include_baselines=bool(m_cfg.get("include_baselines", True)),
            include_spectral_density=bool(m_cfg.get("include_spectral_density", True)),
            device=self.device,
        )
        self.random_seed = seed

    def sample(self) -> dict:
        """Sample, score, write ``results.yaml`` and ``samples.npy`` (the
        primary rank); returns the results (on every rank)."""
        generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        with trace_if_enabled("sample"):
            x = self.sampler.sample(
                self.num_samples, num_diffusion_steps=self.num_diffusion_steps,
                generator=generator,
            ).float()
        x = self.datamodule.samples_to_data(x)

        results = self.metrics(x)
        samples = x.cpu().numpy()
        # The divergent-chain census and its provenance, in every
        # results.yaml (FDIFF_CENSUS_ARM tags the training arm).
        guard_active = self.sampler.divergence_threshold is not None
        results.update(
            census_fields(
                samples,
                guard_active=guard_active,
                num_samples=self.num_samples,
                num_diffusion_steps=self.num_diffusion_steps,
                method=self.sampler.method,
                sampling_seed=self.random_seed,
                train_seed=self.train_seed,
                checkpoint=self.checkpoint_kind,
                arm=os.environ.get("FDIFF_CENSUS_ARM"),
            )
        )
        if guard_active:
            for k, v in self.sampler.last_resample_stats.items():
                results[f"divergence_guard_{k}"] = v
        elif results["divergence_census_count"] > 0:
            logger.warning(
                "%d chain(s) diverged (absmax > %.1f). The divergence guard redraws "
                "them in place: re-run with sampler.divergence_threshold=8 "
                "sampler.max_resample_retries=3.",
                results["divergence_census_count"], results["divergence_census_threshold"],
            )
        printable = {k: v for k, v in results.items() if not isinstance(v, list)}
        logger.info("Metrics:\n%s", dict_to_str(printable))

        if distributed.is_primary():
            logger.info("Saving samples and metrics to %s", self.save_dir)
            yamlio.dump(dict(sorted(results.items())), self.save_dir / "results.yaml")
            np.save(self.save_dir / "samples.npy", samples)
        return results


def main(argv: Optional[list[str]] = None) -> None:
    overrides = list(sys.argv[1:] if argv is None else argv)
    cfg = compose("sample", overrides)
    if cfg.get("model_id") in (None, "???"):
        raise SystemExit("model_id=<run_id> is required")
    init_distributed(cfg)
    SamplingRunner(cfg).sample()


if __name__ == "__main__":
    main()
