"""Config -> object builders (port of ``fourierdiffusion_tpu/utils/instantiate.py``)."""

from __future__ import annotations

from fourierdiffusion_tpu_torch.data.datamodules import DATAMODULE_REGISTRY, Datamodule
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.schedulers import SDE, VEScheduler, VPScheduler


def build_scheduler(cfg: dict) -> SDE:
    """``cfg`` is the ``noise_scheduler`` node (vpsde/vesde)."""
    kind = cfg["kind"]
    if kind == "vpsde":
        return VPScheduler(
            beta_min=float(cfg.get("beta_min", 0.1)),
            beta_max=float(cfg.get("beta_max", 20.0)),
            fourier_noise_scaling=bool(cfg.get("fourier_noise_scaling", False)),
            eps=float(cfg.get("eps", 1e-5)),
        )
    if kind == "vesde":
        return VEScheduler(
            sigma_min=float(cfg.get("sigma_min", 0.01)),
            sigma_max=float(cfg.get("sigma_max", 50.0)),
            fourier_noise_scaling=bool(cfg.get("fourier_noise_scaling", False)),
            eps=float(cfg.get("eps", 1e-5)),
        )
    raise ValueError(f"Unknown noise scheduler kind: {kind!r}")


def build_model_config(cfg: dict) -> ScoreModelConfig:
    """``cfg`` is the ``score_model`` node. ``use_pallas`` selects the JAX
    package's Pallas kernels; it means nothing here (the port picks its
    kernels by device) and is ignored."""
    return ScoreModelConfig(
        model_type=cfg["model_type"],
        d_model=int(cfg.get("d_model", 72)),
        num_layers=int(cfg.get("num_layers", 10)),
        n_head=int(cfg.get("n_head", 12)),
        dim_feedforward=int(cfg.get("dim_feedforward", 2048)),
        d_mlp=int(cfg.get("d_mlp", 1024)),
        dropout_rate=float(cfg.get("dropout_rate", 0.1)),
        dtype=str(cfg.get("dtype", "float32")),
    )


def build_datamodule(cfg: dict) -> Datamodule:
    """``cfg`` is the ``datamodule`` node."""
    cfg = dict(cfg)
    return DATAMODULE_REGISTRY[cfg.pop("name")](**cfg)


__all__ = [
    "DATAMODULE_REGISTRY",
    "build_datamodule",
    "build_model_config",
    "build_scheduler",
]
