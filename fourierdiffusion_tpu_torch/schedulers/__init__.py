from fourierdiffusion_tpu_torch.schedulers.sde import (
    SDE,
    SamplingOutput,
    VEScheduler,
    VPScheduler,
    g_vector,
)

__all__ = ["SDE", "SamplingOutput", "VEScheduler", "VPScheduler", "g_vector"]
