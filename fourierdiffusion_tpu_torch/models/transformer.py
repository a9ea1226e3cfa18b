"""Post-LN transformer encoder (port of
``fourierdiffusion_tpu/models/transformer.py``).

The computation of ``nn.TransformerEncoderLayer(d_model, n_head,
batch_first=True)`` in eval mode: attention, residual, LayerNorm (eps
1e-5, fp32 statistics), ReLU feed-forward, residual, LayerNorm. State-dict
names match it, so the stack loads as ``backbone.layers.{i}.*``. Dropout
is training-only and waits for the training port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fourierdiffusion_tpu_torch.models.attention import MultiHeadSelfAttention
from fourierdiffusion_tpu_torch.models.blocks import TorchLinear

LN_EPS = 1e-5


def layer_norm_fp32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 output."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_head: int, dim_feedforward: int = 2048) -> None:
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, n_head)
        self.linear1 = TorchLinear(d_model, dim_feedforward)
        self.linear2 = TorchLinear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = layer_norm_fp32(x + self.self_attn(x), self.norm1).to(dtype)
        h = self.linear2(torch.relu(self.linear1(x)))
        return layer_norm_fp32(x + h, self.norm2).to(dtype)


class TransformerEncoder(nn.Module):
    def __init__(
        self, d_model: int, n_head: int, num_layers: int, dim_feedforward: int = 2048
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_head, dim_feedforward)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


__all__ = ["TransformerEncoder", "TransformerEncoderLayer", "layer_norm_fp32"]
