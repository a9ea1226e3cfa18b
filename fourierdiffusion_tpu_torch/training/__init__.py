from fourierdiffusion_tpu_torch.training.optim import (
    AdamW,
    MultiSteps,
    cosine_warmup_schedule,
    make_optimizer,
)
from fourierdiffusion_tpu_torch.training.trainer import Trainer

__all__ = ["AdamW", "MultiSteps", "Trainer", "cosine_warmup_schedule", "make_optimizer"]
