"""Embedding and encoding blocks (port of
``fourierdiffusion_tpu/models/blocks.py``).

Parameters are stored in fp32 under the reference PyTorch state-dict
names and cast to the input's dtype at use, so a bf16 input runs bf16
products with fp32 master weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class TorchLinear(nn.Linear):
    """``nn.Linear`` whose fp32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def max_norm_renorm(embedding: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Scale rows with L2 norm above ``max_norm`` down onto the ball.

    Functional: the weight is left as it is and the scale carries no
    gradient (``nn.Embedding(max_norm=...)`` would rewrite the weight in
    place on every lookup instead).
    """
    norms = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return embedding * scale.detach()


class PositionalEncoding(nn.Module):
    """Learned positional embedding, max-norm ``sqrt(d_model)`` renorm
    applied on every forward."""

    def __init__(self, d_model: int, max_len: int) -> None:
        super().__init__()
        self.d_model = d_model
        self.embedding = nn.Embedding(max_len, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = max_norm_renorm(self.embedding.weight, math.sqrt(self.d_model))
        return x + pe[None, : x.shape[1], :].to(x.dtype)


class GaussianFourierProjection(nn.Module):
    """Gaussian random features of the diffusion time through a Linear.

    ``W`` (``(d_model + 1) // 2`` frozen draws times ``scale``) is a buffer,
    so no optimizer sees it; its state-dict name is ``time_encoder.W``.
    """

    def __init__(self, d_model: int, scale: float = 30.0) -> None:
        super().__init__()
        self.d_model = d_model
        self.register_buffer("W", torch.randn((d_model + 1) // 2) * scale)
        self.dense = TorchLinear(d_model, d_model)

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor, use_time_axis: bool = True
    ) -> torch.Tensor:
        time_proj = timesteps[:, None].float() * self.W[None, :] * 2.0 * math.pi
        emb = torch.cat([torch.sin(time_proj), torch.cos(time_proj)], dim=-1)
        t_emb = emb[:, : self.d_model]
        if use_time_axis:
            t_emb = t_emb[:, None, :]
        return x + self.dense(t_emb.to(x.dtype))


__all__ = [
    "GaussianFourierProjection",
    "PositionalEncoding",
    "TorchLinear",
    "max_norm_renorm",
]
