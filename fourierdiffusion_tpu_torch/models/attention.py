"""Multi-head self-attention of the unfused score network (port of
``fourierdiffusion_tpu/models/attention.py``).

Weights use the layout of ``nn.MultiheadAttention`` (``in_proj_weight``,
``in_proj_bias``, ``out_proj``). The scores and the softmax are fp32 and
the products take the activation dtype. The routes are the JAX module's
with Pallas, with "on CUDA" in place of "on TPU":

* no dropout needed (eval mode, or a rate of 0) -> ``flash_attention``:
  the kernel B2 forward and, when a gradient is taken, B5;
* training with a rate above 0 -> ``flash_attention_dropout``, the kernels
  B6 with the mask regenerated in the backward, keyed by a seed drawn per
  call in ``[0, 2**31 - 1)`` from the caller's ``generator`` on the
  activations' device, as the JAX module draws it from its dropout rng
  (under a data mesh made for this rank's chains, ``draw_seed``);
* on CPU tensors, and with ``plain=True`` on any device (the card's check
  of the kernels), the plain versions: in fp32 differentiated by autograd,
  ``dot_product_attention`` (the JAX module's route off the TPU) and
  ``flash_attention_dropout_reference``, with the same seed and the same
  hashed mask as the kernels; in bf16 the kernels' plain versions with
  their own backward (``PlainAttention``, ``PlainAttentionDropout``), so
  that the plain route rounds where the kernels and the JAX module's Pallas
  route round: the fast form forward at dh < 16 and JAX's ``_bwd_core``
  (autograd through ``dot_product_attention`` would take the exact softmax
  forward and round dP, not dS, to bf16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fourierdiffusion_tpu_torch.models.blocks import TorchLinear
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.parallel.mesh import Stream, batch_seed

SEED_MAX = 2**31 - 1  # dropout seeds are drawn from [0, SEED_MAX), as in JAX


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Softmax attention over ``(B, H, L, dh)`` tensors, fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def draw_seed(generator: Stream, device: torch.device, batch: int = 0) -> torch.Tensor:
    """One int64 seed in ``[0, SEED_MAX)`` from ``generator``, on ``device``,
    for ``batch`` chains (``batch_seed``: under a data mesh, this rank's)."""
    return batch_seed(
        lambda g: torch.randint(0, SEED_MAX, (1,), generator=g, device=device), batch, generator)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, dropout_rate: float = 0.0) -> None:
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of n_head {n_head}")
        self.d_model = d_model
        self.n_head = n_head
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = TorchLinear(d_model, d_model)
        bound = 1.0 / math.sqrt(d_model)
        nn.init.uniform_(self.in_proj_weight, -bound, bound)
        nn.init.uniform_(self.in_proj_bias, -bound, bound)

    def forward(
        self, x: torch.Tensor, generator: Stream = None, *,
        plain: bool = False,
    ) -> torch.Tensor:
        b, l, d = x.shape
        dh = d // self.n_head
        qkv = F.linear(
            x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype)
        )
        q, k, v = (
            t.reshape(b, l, self.n_head, dh).transpose(1, 2)
            for t in qkv.split(d, dim=-1)
        )
        if x.device.type == "cuda" and not plain:
            attend, attend_dropout = fa.flash_attention, fa.flash_attention_dropout
        elif x.dtype == torch.bfloat16:
            attend, attend_dropout = fa.PlainAttention.apply, fa.PlainAttentionDropout.apply
        else:
            attend, attend_dropout = dot_product_attention, fa.flash_attention_dropout_reference
        if self.training and self.dropout_rate > 0.0:
            seed = draw_seed(generator, x.device, b)
            out = attend_dropout(q, k, v, seed, self.dropout_rate)
        else:
            out = attend(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


__all__ = ["MultiHeadSelfAttention", "SEED_MAX", "dot_product_attention", "draw_seed"]
