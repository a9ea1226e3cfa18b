"""Weights in and out of the port's ``ScoreTransformer``.

``load_reference_state_dict`` reads a reference PyTorch ``model.pt`` (a
plain state dict of fp32 tensors). ``state_dict_from_jax`` turns a flax
variables tree of numpy arrays (``params`` + ``constants``) into the
port's state dict; it is this package's own copy of the mapping that
``fourierdiffusion_tpu/utils/torch_import.py::export_torch_state_dict``
applies.
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


def state_dict_from_jax(
    variables: Mapping[str, Any], num_layers: int
) -> dict[str, torch.Tensor]:
    """Flax ``ScoreTransformer`` variables -> the port's state dict."""
    params = variables["params"]
    out: dict[str, torch.Tensor] = {
        "time_encoder.W": _a(variables["constants"]["time_encoder"]["W"]),
        "pos_encoder.embedding.weight": _a(params["pos_encoder"]["embedding"]),
    }
    _linear(params["embedder"], "embedder", out)
    _linear(params["unembedder"], "unembedder", out)
    _linear(params["time_encoder"]["dense"], "time_encoder.dense", out)
    for i in range(num_layers):
        layer = params["backbone"][f"layers_{i}"]
        p = f"backbone.layers.{i}"
        out[f"{p}.self_attn.in_proj_weight"] = _t(layer["self_attn"]["in_proj"]["kernel"])
        out[f"{p}.self_attn.in_proj_bias"] = _a(layer["self_attn"]["in_proj"]["bias"])
        _linear(layer["self_attn"]["out_proj"], f"{p}.self_attn.out_proj", out)
        _layernorm(layer["norm1"], f"{p}.norm1", out)
        _layernorm(layer["norm2"], f"{p}.norm2", out)
        _linear(layer["linear1"], f"{p}.linear1", out)
        _linear(layer["linear2"], f"{p}.linear2", out)
    return out


__all__ = ["load_reference_state_dict", "state_dict_from_jax"]
