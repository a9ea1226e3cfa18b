"""Post-LN transformer encoder (port of
``fourierdiffusion_tpu/models/transformer.py``).

The computation of ``nn.TransformerEncoderLayer(d_model, n_head,
batch_first=True)``: attention, residual, LayerNorm (eps 1e-5, fp32
statistics), ReLU feed-forward, residual, LayerNorm. State-dict names
match it, so the stack loads as ``backbone.layers.{i}.*``.

Dropout at ``dropout_rate``, as in JAX, runs only in training mode with a
rate above 0: on the attention weights (``models/attention.py``), after
the out projection (``dropout1``), after the ReLU (``dropout_ff``) and
after ``linear2`` (``dropout2``). Its draws come from the ``generator``
passed to ``forward``, on the activations' device (None: PyTorch's default
generator), in the order attention seed, dropout1, dropout_ff, dropout2,
layer by layer. Eval mode draws nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fourierdiffusion_tpu_torch.models.attention import MultiHeadSelfAttention
from fourierdiffusion_tpu_torch.models.blocks import TorchLinear, dropout

LN_EPS = 1e-5


def layer_norm_fp32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 output."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self, d_model: int, n_head: int, dim_feedforward: int = 2048,
        dropout_rate: float = 0.1,
    ) -> None:
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadSelfAttention(d_model, n_head, dropout_rate)
        self.linear1 = TorchLinear(d_model, dim_feedforward)
        self.linear2 = TorchLinear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, *,
        plain: bool = False,
    ) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0.0
        dtype = x.dtype
        a = self.self_attn(x, generator, plain=plain)
        if drop:
            a = dropout(a, self.dropout_rate, generator)  # dropout1
        x = layer_norm_fp32(x + a, self.norm1).to(dtype)
        h = torch.relu(self.linear1(x))
        if drop:
            h = dropout(h, self.dropout_rate, generator)  # dropout_ff
        h = self.linear2(h)
        if drop:
            h = dropout(h, self.dropout_rate, generator)  # dropout2
        return layer_norm_fp32(x + h, self.norm2).to(dtype)


class TransformerEncoder(nn.Module):
    def __init__(
        self, d_model: int, n_head: int, num_layers: int, dim_feedforward: int = 2048,
        dropout_rate: float = 0.1,
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_head, dim_feedforward, dropout_rate)
            for _ in range(num_layers)
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, *,
        plain: bool = False,
    ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, generator, plain=plain)
        return x


__all__ = ["TransformerEncoder", "TransformerEncoderLayer", "dropout", "layer_norm_fp32"]
