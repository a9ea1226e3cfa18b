"""Port parity of the fused layers at the long sequences of the real datasets
(NASA L=251, NASDAQ 252, USDroughts 365), where the CUDA kernels keep the
chain's K|V (B1, B3) or x1 and f2 (B4) in device memory instead of shared
memory; on the CPU.

The plain versions of the sampling layer (``ops/fused_encoder.py``) and of
the training layer (``ops/fused_encoder_train.py``, forward, backward and
its four dropout masks) run at L=365 against the JAX package's Pallas
kernels in interpret mode, at narrow widths (d_model 48, 12 heads, FFN 64,
2 chains, one layer) so that the interpreter stays quick. The masks follow
``train_group`` at Lp=384: three head groups of 4. The kernels themselves are
held to these plain versions on the card (``tests/test_torch_cuda.py``).

Tolerances: as ``tests/test_torch_fused_encoder.py`` (values fp32 2e-5,
bf16 0.1 absolute) and ``tests/test_torch_train_layer.py`` (values 1e-5,
gradients 1e-4 of each tensor's largest; masks bit for bit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models
from test_torch_train_layer import _jax_masks, assert_grads_close

from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu.ops import fused_encoder_train as jax_fet
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.utils.weights import encoder_layer_state_from_jax

L, D, H, F, B = 365, 48, 12, 64, 2
ARCH = dict(d_model=D, n_head=H, num_layers=1, dim_feedforward=F)
FP32 = dict(atol=2e-5, rtol=2e-5)
VALUE = dict(atol=1e-5, rtol=1e-5)
RATE, SEED = 0.1, 2**31 - 9


def _case():
    _, variables, model = jax_and_port_models(L, 1, **ARCH)
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(B, L, D)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(B, L, D)).astype(np.float32)
    return variables["params"]["backbone"]["layers_0"], model.backbone.layers[0], x, dy


def _to_jax(x: np.ndarray, dtype=jnp.float32):
    return jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(x).astype(dtype), 1, 2))


def _from_jax(y) -> np.ndarray:
    return np.asarray(jnp.swapaxes(y[:, :, :L], 1, 2).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sampling_layer_matches_jax_at_L365(dtype: str) -> None:
    jparams, layer, x, _ = _case()
    jdtype, tdtype = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_fe.fused_encoder_layer(
        _to_jax(x, jdtype), jax_fe.pack_encoder_layer(jparams, H, jdtype), n_head=H, l_valid=L
    )
    packed = fe.pack_encoder_layer(layer, H, tdtype)
    ours = fe.fused_encoder_layer(torch.from_numpy(x).to(tdtype), packed, n_head=H)
    tol = FP32 if dtype == "float32" else dict(atol=0.1, rtol=0.0)
    np.testing.assert_allclose(ours.float().numpy(), _from_jax(ref), **tol)


def test_training_masks_match_jax_at_L365() -> None:
    lp = 384
    group = fet.train_group(H, L)
    assert group == jax_fet._train_group(H, lp, 1) == 4
    ref = _jax_masks(B, lp, F, group, SEED, RATE, d_model=D, n_head=H)
    ours = {k: v.numpy() for k, v in fet.dropout_masks(B, L, D, F, H, SEED, RATE).items()}
    np.testing.assert_array_equal(ours["attn"], ref["attn"].reshape(B, H, lp, lp)[:, :, :L, :L])
    for key in ("out", "ff", "ff2"):
        np.testing.assert_array_equal(ours[key], ref[key][:, :, :L].transpose(0, 2, 1))


def test_training_layer_matches_jax_at_L365() -> None:
    jparams, layer, x, dy = _case()

    def jax_layer(params, xt):
        packed = jax_fe.pack_encoder_layer(params, H, jnp.float32)
        return jax_fet.fused_encoder_layer_train((H, L, RATE), xt, packed, jnp.int32(SEED))

    y, vjp = jax.vjp(jax_layer, jparams, _to_jax(x))
    g_params, g_xt = vjp(_to_jax(dy))

    xp = torch.from_numpy(x).requires_grad_(True)
    packed = fet.pack_encoder_layer_train(layer, H)
    out = fet.fused_encoder_layer_train(xp, packed, SEED, n_head=H, rate=RATE)
    np.testing.assert_allclose(out.detach().numpy(), _from_jax(y), **VALUE)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(out, [xp, *params.values()], torch.from_numpy(dy))
    assert_grads_close(grads[0], _from_jax(g_xt), "x")
    ref = encoder_layer_state_from_jax(jax.tree_util.tree_map(np.asarray, g_params))
    for (name, _), g in zip(params.items(), grads[1:]):
        assert_grads_close(g, ref[name].numpy(), name)
