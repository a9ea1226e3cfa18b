from fourierdiffusion_tpu_torch.sampling.sampler import (
    DiffusionSampler,
    make_sample_fn,
    reverse_diffusion,
)

__all__ = ["DiffusionSampler", "make_sample_fn", "reverse_diffusion"]
