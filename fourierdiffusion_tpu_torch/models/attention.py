"""Multi-head self-attention, unfused reference path (port of
``fourierdiffusion_tpu/models/attention.py``).

Weights use the layout of ``nn.MultiheadAttention`` (``in_proj_weight``,
``in_proj_bias``, ``out_proj``). The scores and the softmax are fp32 and
the products take the activation dtype. Written out in plain tensor
operations; the fused sampling path runs the encoder-layer kernel
(``ops/fused_encoder.py``) instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fourierdiffusion_tpu_torch.models.blocks import TorchLinear


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Softmax attention over ``(B, H, L, dh)`` tensors, fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int) -> None:
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of n_head {n_head}")
        self.d_model = d_model
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = TorchLinear(d_model, d_model)
        bound = 1.0 / math.sqrt(d_model)
        nn.init.uniform_(self.in_proj_weight, -bound, bound)
        nn.init.uniform_(self.in_proj_bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        dh = d // self.n_head
        qkv = F.linear(
            x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype)
        )
        q, k, v = (
            t.reshape(b, l, self.n_head, dh).transpose(1, 2)
            for t in qkv.split(d, dim=-1)
        )
        out = dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


__all__ = ["MultiHeadSelfAttention", "dot_product_attention"]
