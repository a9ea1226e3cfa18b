from fourierdiffusion_tpu_torch.models.score_models import (
    MODEL_REGISTRY,
    ScoreLSTM,
    ScoreMLP,
    ScoreModelConfig,
    ScoreNetwork,
    ScoreTransformer,
)

__all__ = [
    "MODEL_REGISTRY",
    "ScoreLSTM",
    "ScoreMLP",
    "ScoreModelConfig",
    "ScoreNetwork",
    "ScoreTransformer",
]
