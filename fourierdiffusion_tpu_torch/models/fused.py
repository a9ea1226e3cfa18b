"""Fused sampling-path forward of the transformer score network (port of
``pack_score_transformer`` and ``fused_score_forward`` in
``fourierdiffusion_tpu/models/fused.py``).

``pack_score_transformer`` repacks a ``ScoreTransformer``'s weights once
per sampling run: the positional embedding with its max-norm renorm
applied, and every encoder layer through ``pack_encoder_layer``.
``fused_score_forward`` then computes what ``model(x, t)`` computes, with
the encoder stack in ``ops.fused_encoder`` (one kernel launch per layer on
the card). Activations stay ``(B, L, D)``: the TPU's transposed, lane-
padded layout is not needed here. The small embed, time-embedding and
unembed products stay ``torch.matmul``.
"""

from __future__ import annotations

import math

import torch

from fourierdiffusion_tpu_torch.models.blocks import max_norm_renorm
from fourierdiffusion_tpu_torch.models.score_models import ScoreTransformer
from fourierdiffusion_tpu_torch.ops.fused_encoder import fused_encoder, pack_encoder_layer


def pack_score_transformer(model: ScoreTransformer) -> dict:
    """Repack ``model``'s weights for ``fused_score_forward`` (detached
    copies in the compute dtype; the model itself is left as it is)."""
    dtype = model.dtype
    with torch.no_grad():
        pe = max_norm_renorm(model.pos_encoder.embedding.weight, math.sqrt(model.d_model))

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.detach().to(dtype).clone()

        return {
            "embed_w": cast(model.embedder.weight.t()),  # (C, D)
            "embed_b": cast(model.embedder.bias),
            "pos": cast(pe[: model.max_len]),  # (L, D)
            "gfp_w": model.time_encoder.W.detach().float().clone(),
            "gfp_dense_w": cast(model.time_encoder.dense.weight.t()),
            "gfp_dense_b": cast(model.time_encoder.dense.bias),
            "unembed_w": cast(model.unembedder.weight.t()),  # (D, C)
            "unembed_b": cast(model.unembedder.bias),
            "layers": [
                pack_encoder_layer(layer, model.n_head, dtype)
                for layer in model.backbone.layers
            ],
        }


def fused_score_forward(
    model: ScoreTransformer, packed: dict, x: torch.Tensor, timesteps: torch.Tensor
) -> torch.Tensor:
    """Score for ``x`` ``(B, L, C)`` at times ``(B,)``, same shape and dtype
    as ``x``."""
    in_dtype = x.dtype
    dtype = model.dtype
    h = x.to(dtype) @ packed["embed_w"] + packed["embed_b"] + packed["pos"][None]
    proj = timesteps[:, None].float() * packed["gfp_w"][None] * (2.0 * math.pi)
    emb = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)[:, : model.d_model]
    t_emb = emb.to(dtype) @ packed["gfp_dense_w"] + packed["gfp_dense_b"]
    h = (h + t_emb[:, None, :]).contiguous()
    h = fused_encoder(h, packed["layers"], n_head=model.n_head)
    score = h @ packed["unembed_w"] + packed["unembed_b"]
    return score.to(in_dtype)


__all__ = ["fused_score_forward", "pack_score_transformer"]
