"""Weights in and out of the port's score networks.

``load_reference_state_dict`` reads a reference PyTorch ``model.pt`` (a
plain state dict of fp32 tensors) of a transformer, MLP or LSTM score
network: the port's modules carry the reference's names. ``state_dict_from_jax``
turns a flax variables tree of numpy arrays (``params`` + ``constants``)
of any of the three into the port's state dict, the network's kind read
from the tree (``model_type_of``); it is this package's own copy of the
mapping that ``fourierdiffusion_tpu/utils/torch_import.py::export_torch_state_dict``
applies. The same mapping carries a JAX gradient tree (``{"params":
grads}``, no ``constants``) onto the port's parameter names, and
``encoder_layer_state_from_jax`` maps one encoder layer's subtree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(
    model: nn.Module, path: str | Path
) -> nn.Module:
    """Load ``path`` into ``model`` with ``strict=True``; returns ``model``."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def _t(w) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(w).T, order="C"))


def _a(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w))


def _linear(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"])
    out[f"{prefix}.bias"] = _a(tree["bias"])


def _layernorm(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _a(tree["scale"])
    out[f"{prefix}.bias"] = _a(tree["bias"])


def encoder_layer_state_from_jax(
    layer: Mapping[str, Any], prefix: str = ""
) -> dict[str, torch.Tensor]:
    """One flax encoder layer's params (or their gradients) -> the port's
    ``TransformerEncoderLayer`` names, each under ``prefix``."""
    out: dict[str, torch.Tensor] = {}
    out[f"{prefix}self_attn.in_proj_weight"] = _t(layer["self_attn"]["in_proj"]["kernel"])
    out[f"{prefix}self_attn.in_proj_bias"] = _a(layer["self_attn"]["in_proj"]["bias"])
    _linear(layer["self_attn"]["out_proj"], f"{prefix}self_attn.out_proj", out)
    _layernorm(layer["norm1"], f"{prefix}norm1", out)
    _layernorm(layer["norm2"], f"{prefix}norm2", out)
    _linear(layer["linear1"], f"{prefix}linear1", out)
    _linear(layer["linear2"], f"{prefix}linear2", out)
    return out


def model_type_of(params: Mapping[str, Any]) -> str:
    """``transformer``, ``mlp`` or ``lstm``: which flax network ``params``
    (or a tree of its shape) belongs to."""
    if "backbone" in params:
        return "transformer"
    return "lstm" if "w_ih" in params["backbone_0"] else "mlp"


def num_layers_of(params: Mapping[str, Any]) -> int:
    """The depth of the flax network ``params`` belongs to."""
    if "backbone" in params:
        return sum(1 for k in params["backbone"] if k.startswith("layers_"))
    return sum(1 for k in params if k.startswith("backbone_"))


def state_dict_from_jax(
    variables: Mapping[str, Any], num_layers: int
) -> dict[str, torch.Tensor]:
    """Flax ``ScoreTransformer``, ``ScoreMLP`` or ``ScoreLSTM`` variables ->
    the port's state dict. Without ``constants`` (a gradient tree) the
    frozen ``time_encoder.W`` is left out."""
    params = variables["params"]
    kind = model_type_of(params)
    out: dict[str, torch.Tensor] = {}
    if kind == "transformer":
        out["pos_encoder.embedding.weight"] = _a(params["pos_encoder"]["embedding"])
    if "constants" in variables:
        out["time_encoder.W"] = _a(variables["constants"]["time_encoder"]["W"])
    _linear(params["embedder"], "embedder", out)
    _linear(params["unembedder"], "unembedder", out)
    _linear(params["time_encoder"]["dense"], "time_encoder.dense", out)
    for i in range(num_layers):
        if kind == "transformer":
            out.update(encoder_layer_state_from_jax(
                params["backbone"][f"layers_{i}"], f"backbone.layers.{i}."
            ))
            continue
        block = params[f"backbone_{i}"]
        if kind == "mlp":
            _linear(block["fc1"], f"backbone.{i}.0", out)
            _linear(block["fc2"], f"backbone.{i}.3", out)
        else:
            for jax_name, name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                   ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                out[f"backbone.{i}.{name}"] = _a(block[jax_name])
    return out


__all__ = [
    "encoder_layer_state_from_jax",
    "load_reference_state_dict",
    "model_type_of",
    "num_layers_of",
    "state_dict_from_jax",
]
