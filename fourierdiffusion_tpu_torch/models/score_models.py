"""Transformer score network (port of ``ScoreTransformer`` and the
transformer part of ``ScoreModelConfig`` in
``fourierdiffusion_tpu/models/score_models.py``).

Channel embed -> learned positional embedding -> Gaussian Fourier time
embedding -> post-LN encoder stack -> channel unembed. Parameters stay
fp32; ``dtype`` is the compute dtype, and the score is cast back to the
input's dtype. The MLP and LSTM score networks are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fourierdiffusion_tpu_torch.models.blocks import (
    GaussianFourierProjection,
    PositionalEncoding,
    TorchLinear,
)
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoder


class ScoreTransformer(nn.Module):
    """Flagship defaults: d_model 72, 10 layers, 12 heads, FFN 2048."""

    def __init__(
        self,
        n_channels: int,
        max_len: int,
        d_model: int = 72,
        num_layers: int = 10,
        n_head: int = 12,
        dim_feedforward: int = 2048,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_channels = n_channels
        self.max_len = max_len
        self.d_model = d_model
        self.num_layers = num_layers
        self.n_head = n_head
        self.dim_feedforward = dim_feedforward
        self.dtype = dtype
        self.embedder = TorchLinear(n_channels, d_model)
        self.pos_encoder = PositionalEncoding(d_model, max_len)
        self.time_encoder = GaussianFourierProjection(d_model)
        self.backbone = TransformerEncoder(d_model, n_head, num_layers, dim_feedforward)
        self.unembedder = TorchLinear(d_model, n_channels)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != (self.max_len, self.n_channels):
            raise ValueError(
                f"X has wrong shape, expected (*, {self.max_len}, {self.n_channels}), "
                f"got {tuple(x.shape)}"
            )
        if timesteps.shape[0] != x.shape[0]:
            raise ValueError("timesteps and x disagree on the batch size")
        in_dtype = x.dtype
        h = self.embedder(x.to(self.dtype))
        h = self.pos_encoder(h)
        h = self.time_encoder(h, timesteps, use_time_axis=True)
        h = self.backbone(h)
        return self.unembedder(h).to(in_dtype)


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    """Architecture description; only ``model_type="transformer"`` is
    ported so far."""

    model_type: str = "transformer"
    d_model: int = 72
    num_layers: int = 10
    n_head: int = 12
    dim_feedforward: int = 2048
    dtype: str = "float32"

    def build(self, n_channels: int, max_len: int) -> ScoreTransformer:
        if self.model_type != "transformer":
            raise ValueError(f"model_type {self.model_type!r} is not ported yet")
        return ScoreTransformer(
            n_channels=n_channels,
            max_len=max_len,
            d_model=self.d_model,
            num_layers=self.num_layers,
            n_head=self.n_head,
            dim_feedforward=self.dim_feedforward,
            dtype=getattr(torch, self.dtype),
        )


__all__ = ["ScoreModelConfig", "ScoreTransformer"]
