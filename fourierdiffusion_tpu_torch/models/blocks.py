"""Embedding, encoding and MLP blocks (port of
``fourierdiffusion_tpu/models/blocks.py`` and of ``_MLPBlock`` in
``fourierdiffusion_tpu/models/score_models.py``).

Parameters are stored in fp32 under the reference PyTorch state-dict
names and cast to the input's dtype at use, so a bf16 input runs bf16
products with fp32 master weights. ``dropout`` is flax's ``nn.Dropout``
drawing from a ``torch.Generator`` passed in (or a ``ShardedGenerator``
under a data mesh), which every dropout of the score networks uses.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fourierdiffusion_tpu_torch.parallel.mesh import Stream, batch_draw


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


def dropout(x: torch.Tensor, rate: float, generator: Stream) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x / (1 - rate)`` where a Bernoulli(1 - rate)
    draw from ``generator`` keeps, else 0. From a ``ShardedGenerator`` the
    draw is made at the global batch and cut to this rank's rows."""
    keep = batch_draw(
        lambda n, g: x.new_empty((n, *x.shape[1:])).bernoulli_(1.0 - rate, generator=g),
        x.shape[0], generator,
    )
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class MLPBlock(nn.Sequential):
    """torchvision ``MLP(d_model, [d_mlp, d_model], dropout=rate)``: Linear,
    ReLU, Dropout, Linear, Dropout, no final activation, so its state-dict
    names are ``0.*`` and ``3.*``. In training mode at a rate above 0 both
    dropouts draw from the ``generator`` passed to ``forward`` (``dropout``
    above, not ``nn.Dropout``'s global stream); eval mode draws nothing."""

    def __init__(self, d_model: int, d_mlp: int, dropout_rate: float = 0.1) -> None:
        super().__init__(TorchLinear(d_model, d_mlp), nn.ReLU(), nn.Dropout(dropout_rate),
                         TorchLinear(d_mlp, d_model), nn.Dropout(dropout_rate))
        self.dropout_rate = dropout_rate

    def forward(  # type: ignore[override]
        self, x: torch.Tensor, generator: Stream = None
    ) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0.0
        h = torch.relu(self[0](x))
        if drop:
            h = dropout(h, self.dropout_rate, generator)
        h = self[3](h)
        if drop:
            h = dropout(h, self.dropout_rate, generator)
        return h


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
    "MLPBlock",
    "PositionalEncoding",
    "TorchLinear",
    "dropout",
    "max_norm_renorm",
]
