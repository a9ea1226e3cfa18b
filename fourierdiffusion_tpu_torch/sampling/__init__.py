from fourierdiffusion_tpu_torch.sampling.metrics import (
    MarginalWasserstein,
    Metric,
    MetricCollection,
    SlicedWasserstein,
)
from fourierdiffusion_tpu_torch.sampling.sampler import (
    DiffusionSampler,
    make_sample_fn,
    reverse_diffusion,
)

__all__ = [
    "DiffusionSampler",
    "MarginalWasserstein",
    "Metric",
    "MetricCollection",
    "SlicedWasserstein",
    "make_sample_fn",
    "reverse_diffusion",
]
