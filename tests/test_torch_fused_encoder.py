"""Port parity: ``fourierdiffusion_tpu_torch.ops.fused_encoder`` and
``models/fused.py`` against the JAX fused encoder, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_fused_encoder.py`` does; the port's wrapper, given CPU
tensors, runs its plain PyTorch version. The kernel itself runs only on a
CUDA card; its tests are in ``tests/test_torch_cuda.py``.

Tolerances: fp32 2e-5 absolute and relative (same arithmetic, other
summation orders); bf16 0.1 absolute on O(1) values, because JAX and
PyTorch round bf16 at other places inside their products.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models, numpy_inputs

from fourierdiffusion_tpu.models import fused as jax_fused
from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe

FP32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
DTYPES = {"float32": (torch.float32, jnp.float32, FP32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}
N_HEAD = 4


def _jax_layer(x: np.ndarray, variables, dtype, l_valid: int) -> np.ndarray:
    """JAX fused layer 0 over (B, L, D), through its (B, D, Lp) layout."""
    params = variables["params"]["backbone"]["layers_0"]
    layer = jax_fe.pack_encoder_layer(params, N_HEAD, dtype)
    xt = jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(x).astype(dtype), 1, 2))
    out = jax_fe.fused_encoder_layer(xt, layer, n_head=N_HEAD, l_valid=l_valid)
    return np.asarray(jnp.swapaxes(out[:, :, :l_valid], 1, 2).astype(jnp.float32))


@pytest.mark.parametrize("max_len", [19, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_matches_jax(max_len: int, dtype: str) -> None:
    tdtype, jdtype, tol = DTYPES[dtype]
    _, variables, model = jax_and_port_models(max_len, 1)
    x = np.random.default_rng(2).normal(size=(3, max_len, 24)).astype(np.float32)
    packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, tdtype)
    ours = fe.fused_encoder_layer(torch.from_numpy(x).to(tdtype), packed, n_head=N_HEAD)
    assert ours.dtype == tdtype and ours.shape == x.shape
    np.testing.assert_allclose(
        ours.float().numpy(), _jax_layer(x, variables, jdtype, max_len), **tol
    )


@pytest.mark.parametrize("max_len,n_channels", [(19, 1), (16, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_score_forward_matches_jax(max_len, n_channels, dtype) -> None:
    tol = DTYPES[dtype][2]
    jmodel, variables, model = jax_and_port_models(max_len, n_channels, dtype)
    x, t = numpy_inputs(3, max_len, n_channels)
    ref = jax_fused.fused_score_forward(
        jmodel, jax_fused.pack_score_transformer(jmodel, variables),
        jnp.asarray(x), jnp.asarray(t),
    )
    with torch.no_grad():
        ours = fused_score_forward(
            model, pack_score_transformer(model), torch.from_numpy(x), torch.from_numpy(t)
        )
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("max_len,n_channels", [(19, 1), (16, 3)])
def test_fused_forward_matches_unfused_module(max_len: int, n_channels: int) -> None:
    _, _, model = jax_and_port_models(max_len, n_channels)
    x, t = (torch.from_numpy(a) for a in numpy_inputs(4, max_len, n_channels, seed=3))
    with torch.no_grad():
        torch.testing.assert_close(
            fused_score_forward(model, pack_score_transformer(model), x, t),
            model(x, t), **FP32,
        )


def test_pack_folds_q_scale() -> None:
    _, _, model = jax_and_port_models(19, 1)
    layer = model.backbone.layers[0]
    packed = fe.pack_encoder_layer(layer, N_HEAD, torch.float32)
    d = 24
    scale = 1.0 / math.sqrt(d // N_HEAD)
    w = layer.self_attn.in_proj_weight.detach()
    b = layer.self_attn.in_proj_bias.detach()
    torch.testing.assert_close(packed["w_qkv"][:, :d], w[:d].t() * scale)
    torch.testing.assert_close(packed["w_qkv"][:, d:], w[d:].t())
    torch.testing.assert_close(packed["b_qkv"][:d], b[:d] * scale)
    assert all(t.is_contiguous() for t in packed.values())


def test_pack_rejects_other_dtypes() -> None:
    _, _, model = jax_and_port_models(19, 1)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float16)


def test_layer_checks_inputs() -> None:
    _, _, model = jax_and_port_models(19, 1)
    packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32)
    with pytest.raises(ValueError, match="w_qkv"):
        fe.fused_encoder_layer(torch.zeros(2, 19, 24, dtype=torch.bfloat16), packed,
                               n_head=N_HEAD)
    with pytest.raises(ValueError, match="B, L, D"):
        fe.fused_encoder_layer(torch.zeros(19, 24), packed, n_head=N_HEAD)
    with pytest.raises(ValueError, match="w_qkv"):
        fe.fused_encoder_layer(torch.zeros(2, 19, 20), packed, n_head=N_HEAD)
