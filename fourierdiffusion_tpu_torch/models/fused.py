"""Fused forwards of the transformer score network (port of
``pack_score_transformer``, ``fused_score_forward`` and
``fused_score_training_forward`` in ``fourierdiffusion_tpu/models/fused.py``).

``pack_score_transformer`` repacks a ``ScoreTransformer``'s weights once
per sampling run: the positional embedding with its max-norm renorm
applied, and every encoder layer through ``pack_encoder_layer``, with int8
weights where ``FDIFF_FUSED_INT8`` (or its ``int8`` argument) asks for the
W8A8 kernels B7 (level 1) or B8 (level 2).
``fused_score_forward`` then computes what ``model(x, t)`` computes, with
the encoder stack in ``ops.fused_encoder`` (one kernel launch per layer on
the card). Activations stay ``(B, L, D)``: the TPU's transposed, lane-
padded layout is not needed here. The small embed, time-embedding and
unembed products (``rowwise_product``) are elementwise products summed per
row, in the activation dtype's accumulator: ``torch.matmul`` hands them to
cuBLAS, which picks its kernel, and with it how a row's sum is grouped, by
the number of rows, so a chain's score would depend on the batch it is in.

``fused_score_training_forward`` is the fused training path (the
trainer's default; ``FDIFF_FUSED_TRAIN=0`` selects the module's own
forward instead): the same forward with dropout, each encoder layer
through ``ops.fused_encoder_train`` (the kernels B3 and B4 on the card).
Its packing is differentiable, so autograd carries the gradients of the
packed weights (q-scale folded in, positional embedding renormalised with
a detached scale) back to the module's parameters. In bf16 (a model of
``dtype`` bfloat16, whose parameters stay fp32) the packed matrices and
embeddings are differentiable bf16 casts of the parameters, as JAX packs
them, and the layers run B3 and B4 in bf16.
"""

from __future__ import annotations

import math
import os

import torch

from fourierdiffusion_tpu_torch.models.blocks import max_norm_renorm
from fourierdiffusion_tpu_torch.models.score_models import ScoreTransformer
from fourierdiffusion_tpu_torch.ops.fused_encoder import (
    LayerFn,
    fused_encoder,
    fused_encoder_layer,
    pack_encoder_layer,
)
from fourierdiffusion_tpu_torch.ops.fused_encoder_train import (
    fused_encoder_layer_train,
    fused_encoder_layer_train_reference,
    pack_encoder_layer_train,
)


def int8_level(int8: bool | int | None = None) -> int:
    """The int8 level of the sampling path: 0 (fp32/bf16, B1), 1 (W8A8 FFN,
    B7) or 2 (also the attention's QKV, PV and out-projection, B8).
    ``None`` reads ``FDIFF_FUSED_INT8`` as JAX does: unset, "" or "0" is 0,
    "2" is 2, anything else 1."""
    if int8 is None:
        raw = os.environ.get("FDIFF_FUSED_INT8", "").strip()
        return 0 if raw in ("", "0") else (2 if raw == "2" else 1)
    return int(int8)


def pack_score_transformer(model: ScoreTransformer, int8: bool | int | None = None) -> dict:
    """Repack ``model``'s weights for ``fused_score_forward`` (detached
    copies in the compute dtype; the model itself is left as it is), at the
    int8 level ``int8_level(int8)``."""
    dtype = model.dtype
    level = int8_level(int8)
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
                pack_encoder_layer(layer, model.n_head, dtype,
                                   int8_ffn=level >= 1, int8_attn=level >= 2)
                for layer in model.backbone.layers
            ],
        }


def rowwise_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a small ``w`` (in, out), in ``a``'s dtype: the products
    in fp32 (exact for bf16 operands; fp64 stays fp64), summed over ``in``
    per row, so each row's result does not depend on how many rows ``a``
    has."""
    acc = torch.float32 if a.dtype == torch.bfloat16 else a.dtype
    return (a.unsqueeze(-1).to(acc) * w.to(acc)).sum(-2).to(a.dtype)


def fused_score_forward(
    model: ScoreTransformer, packed: dict, x: torch.Tensor, timesteps: torch.Tensor,
    *, layer_fn: LayerFn = fused_encoder_layer,
) -> torch.Tensor:
    """Score for ``x`` ``(B, L, C)`` at times ``(B,)``, same shape and dtype
    as ``x``. ``layer_fn`` runs each encoder layer: the kernel's wrapper, or
    for instance ``fused_encoder_layer_plain`` on any device (to check the
    kernels against their plain versions on the card)."""
    in_dtype = x.dtype
    h = _embed(model, packed, x, timesteps)
    h = fused_encoder(h, packed["layers"], n_head=model.n_head, layer_fn=layer_fn)
    score = rowwise_product(h, packed["unembed_w"]) + packed["unembed_b"]
    return score.to(in_dtype)


def _embed(model: ScoreTransformer, packed: dict, x: torch.Tensor, timesteps) -> torch.Tensor:
    """Channel, positional and time embedding, ``(B, L, D)``."""
    dtype = model.dtype
    h = rowwise_product(x.to(dtype), packed["embed_w"]) + packed["embed_b"] + packed["pos"][None]
    proj = timesteps[:, None].float() * packed["gfp_w"][None] * (2.0 * math.pi)
    emb = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)[:, : model.d_model]
    t_emb = rowwise_product(emb.to(dtype), packed["gfp_dense_w"]) + packed["gfp_dense_b"]
    return (h + t_emb[:, None, :]).contiguous()


#: The compute dtypes of the fused training path (fp64 only for reference
#: computations with ``plain=True``).
TRAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def pack_score_transformer_train(model: ScoreTransformer) -> dict:
    """``pack_score_transformer`` for training, in the model's compute dtype
    (fp32 or bf16; fp64 only for reference computations with
    ``plain=True``), with differentiable operations (no ``no_grad``, no
    ``detach``), so gradients reach the parameters; the positional max-norm
    scale is detached, as JAX's ``stop_gradient``. The time embedding's
    random features stay fp32."""
    dtype = model.dtype
    if dtype not in TRAIN_DTYPES:
        raise ValueError(f"the fused training path takes float32 or bfloat16, not {dtype}")
    pe = max_norm_renorm(model.pos_encoder.embedding.weight, math.sqrt(model.d_model))
    return {
        "embed_w": model.embedder.weight.t().to(dtype),
        "embed_b": model.embedder.bias.to(dtype),
        "pos": pe[: model.max_len].to(dtype),
        "gfp_w": model.time_encoder.W,
        "gfp_dense_w": model.time_encoder.dense.weight.t().to(dtype),
        "gfp_dense_b": model.time_encoder.dense.bias.to(dtype),
        "unembed_w": model.unembedder.weight.t().to(dtype),
        "unembed_b": model.unembedder.bias.to(dtype),
        "layers": [
            pack_encoder_layer_train(layer, model.n_head, dtype)
            for layer in model.backbone.layers
        ],
    }


def fused_score_training_forward(
    model: ScoreTransformer, x: torch.Tensor, timesteps: torch.Tensor,
    layer_seeds: list[int], *, plain: bool = False,
) -> torch.Tensor:
    """Training forward with dropout at ``model.dropout_rate``: the score for
    ``x`` ``(B, L, C)`` at times ``(B,)``, differentiable in the model's
    parameters, in the model's compute dtype (the embed and unembed products
    and the time embedding's dense layer in that dtype, its sines in fp32;
    the score cast back to x's dtype). ``layer_seeds`` holds one int32
    dropout seed per layer (JAX draws them as ``randint(fold_in(dropout_key,
    i), 0, 2**31 - 1)``). ``plain=True`` runs each layer's plain version on
    any device (to check the kernels against it on the card)."""
    if len(layer_seeds) != model.num_layers:
        raise ValueError(f"{len(layer_seeds)} layer seeds for {model.num_layers} layers")
    packed = pack_score_transformer_train(model)
    h = _embed(model, packed, x, timesteps)
    layer_fn = fused_encoder_layer_train_reference if plain else fused_encoder_layer_train
    for layer, seed in zip(packed["layers"], layer_seeds):
        h = layer_fn(h, layer, int(seed), n_head=model.n_head, rate=float(model.dropout_rate))
    score = rowwise_product(h, packed["unembed_w"]) + packed["unembed_b"]
    return score.to(x.dtype)


__all__ = [
    "fused_score_forward",
    "fused_score_training_forward",
    "int8_level",
    "pack_score_transformer",
    "pack_score_transformer_train",
    "rowwise_product",
]
