"""In-training sampling callback (port of
``fourierdiffusion_tpu/training/callbacks.py``).

Every ``every_n_epochs`` epochs (epoch 0 included) and at the final epoch,
the callback samples with the eval weights it is handed, un-standardises
the samples with the training statistics, takes them back to the time
domain where the run diffuses in frequency, scores them with the metric
collection (sliced and marginal W2 in time and frequency, no baselines)
and logs the scores as ``metrics/*``.

It never touches the module being trained: it keeps its own copy of the
network for sampling (``DiffusionSampler`` moves its model to the device
and puts it in eval mode) and loads the eval weights into that copy at each
call, and it draws from a ``torch.Generator`` of its own, seeded with
``random_seed`` anew at each call. A fit with the callback is therefore the
same, bit for bit, as one without it.

Under a data ``mesh`` every rank calls it: its sampler splits the chains
over the ranks and gathers them (``DiffusionSampler(mesh=)``), every rank
scores the same samples, and the primary rank writes the scores.
"""

from __future__ import annotations

import copy
import logging
from typing import Optional

import torch

from fourierdiffusion_tpu_torch.data.datamodules import Datamodule
from fourierdiffusion_tpu_torch.models.score_models import ScoreNetwork
from fourierdiffusion_tpu_torch.parallel.distributed import is_primary
from fourierdiffusion_tpu_torch.parallel.mesh import DataMesh
from fourierdiffusion_tpu_torch.sampling.metrics import (
    MarginalWasserstein,
    MetricCollection,
    SlicedWasserstein,
)
from fourierdiffusion_tpu_torch.sampling.sampler import DiffusionSampler
from fourierdiffusion_tpu_torch.schedulers.sde import SDE

logger = logging.getLogger(__name__)


class SamplingCallback:
    def __init__(
        self,
        model: ScoreNetwork,
        scheduler: SDE,
        datamodule: Datamodule,
        *,
        every_n_epochs: int = 10,
        sample_batch_size: int = 64,
        num_samples: int = 200,
        num_diffusion_steps: int = 1000,
        num_directions: int = 200,
        random_seed: int = 42,
        metrics_writer=None,
        device: str | torch.device | None = None,
        mesh: Optional[DataMesh] = None,
    ) -> None:
        self.every_n_epochs = every_n_epochs
        self.num_samples = num_samples
        self.num_diffusion_steps = num_diffusion_steps
        self.metrics_writer = metrics_writer
        self.random_seed = random_seed

        self.datamodule = datamodule
        params = datamodule.dataset_parameters
        self.sampler = DiffusionSampler(
            copy.deepcopy(model),
            scheduler,
            max_len=params["max_len"],
            n_channels=params["n_channels"],
            sample_batch_size=sample_batch_size,
            device=device,
            mesh=mesh,
        )
        self.device = device = self.sampler.device
        self.metric_collection = MetricCollection(
            metric_factories=[
                lambda o: SlicedWasserstein(
                    o, random_seed=random_seed, num_directions=num_directions, device=device
                ),
                lambda o: MarginalWasserstein(o, random_seed=random_seed, device=device),
            ],
            original_samples=datamodule.X_train,
            include_baselines=False,
            device=device,
        )

    def sample(self, params: dict, constants: dict) -> torch.Tensor:
        """Samples from the weights ``params`` and buffers ``constants``, in
        the data's scale and domain."""
        self.sampler.model.load_state_dict({**params, **constants})
        generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        x = self.sampler.sample(
            self.num_samples, num_diffusion_steps=self.num_diffusion_steps,
            generator=generator,
        ).float()
        return self.datamodule.samples_to_data(x)

    def __call__(self, trainer, epoch: int, params, constants, metrics) -> None:
        if epoch % self.every_n_epochs != 0 and epoch + 1 != trainer.max_epochs:
            return
        x = self.sample(params, constants)
        results = self.metric_collection(x)
        results = {f"metrics/{k}": v for k, v in results.items()}
        metrics.update(results)
        if self.metrics_writer is not None and is_primary():
            self.metrics_writer.log(results)
        logger.info(
            "epoch %d sampling metrics: %s",
            epoch,
            {k: round(v, 4) for k, v in results.items() if isinstance(v, float)},
        )


__all__ = ["SamplingCallback"]
