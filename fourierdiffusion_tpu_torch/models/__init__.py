from fourierdiffusion_tpu_torch.models.score_models import (
    ScoreModelConfig,
    ScoreTransformer,
)

__all__ = ["ScoreModelConfig", "ScoreTransformer"]
