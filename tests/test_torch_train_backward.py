"""The plain staged backward of the training layer
(``ops/fused_encoder_train.py::train_backward_staged``) on the CPU.

It follows the stages and sums of the kernels of B4 (``csrc/fused_encoder_train.cuh``):
the forward recomputed over all B*L rows with the FFN summed over the
tail's d_ff chunks, LN2's backward, the hidden layer and its gradient, the
weight products summed per row slice and the slices added in order, dx1
summed over d_ff chunks, LN1's backward, attention per head, and the
column sums per row slice. On the card ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold B4's stages to it; here it is held to
autograd of the plain forward and to the JAX package's backward
(``_train_bwd`` of ``fourierdiffusion_tpu/ops/fused_encoder_train.py``, run
in interpret mode as ``tests/test_torch_train_layer.py`` runs it).

Tolerances, those of ``tests/test_torch_train_layer.py``: dx 1e-5 absolute
and relative, gradients 1e-4 of each tensor's largest (the same fp32
arithmetic summed in other orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layer import VALUE, _layer_case, assert_grads_close

from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu.ops import fused_encoder_train as jax_fet
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.utils.weights import encoder_layer_state_from_jax

L, D, H, F = 19, 24, 4, 64
SEED = 987654


def autograd_of_plain(x: np.ndarray, dy: np.ndarray, packed: dict, rate: float, n_head: int):
    xt = torch.from_numpy(x).requires_grad_(True)
    lay = {k: v.detach().clone().requires_grad_(True) for k, v in packed.items()}
    out = fet.fused_encoder_layer_train_reference(xt, lay, SEED, n_head=n_head, rate=rate)
    return torch.autograd.grad(out, [xt, *lay.values()], torch.from_numpy(dy))


def staged(x: np.ndarray, dy: np.ndarray, packed: dict, rate: float, n_head: int, **kw):
    lay = {k: v.detach() for k, v in packed.items()}
    return fet.train_backward_staged(torch.from_numpy(x), torch.from_numpy(dy), lay, SEED,
                                     n_head=n_head, rate=rate, **kw)


def assert_close_to(dx, grads, ref_dx, ref_grads) -> None:
    np.testing.assert_allclose(dx.numpy(), ref_dx.numpy(), **VALUE)
    for name, got, want in zip(fet.LAYER_KEYS, grads, ref_grads):
        assert_grads_close(got, want.numpy(), name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_staged_backward_matches_autograd_of_the_plain_forward(rate: float) -> None:
    _, layer, x, dy = _layer_case(rate)
    packed = fet.pack_encoder_layer_train(layer, H)
    ref_dx, *ref_grads = autograd_of_plain(x, dy, packed, rate, H)
    dx, grads, stages = staged(x, dy, packed, rate, H)
    assert_close_to(dx, grads, ref_dx, ref_grads)
    assert set(stages) == {"df2", "dx1", "da", "dqkv", "gates"}
    assert stages["dqkv"].shape == (3, L, 3 * D) and stages["gates"].shape == (3, L, F)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_staged_backward_matches_jax(rate: float) -> None:
    """Against the JAX package's ``_train_bwd`` (its custom VJP), through the
    layer's module parameters: the port's packed gradients are carried back
    through ``pack_encoder_layer_train``."""
    jparams, layer, x, dy = _layer_case(rate)

    def jax_layer(params, xt):
        packed = jax_fe.pack_encoder_layer(params, H, jnp.float32)
        return jax_fet.fused_encoder_layer_train((H, L, rate), xt, packed, jnp.int32(SEED))

    xt = jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(x), 1, 2))
    _, vjp = jax.vjp(jax_layer, jparams, xt)
    g_params, g_xt = vjp(jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(dy), 1, 2)))
    dx_ref = np.asarray(jnp.swapaxes(g_xt[:, :, :L], 1, 2))

    packed = fet.pack_encoder_layer_train(layer, H)
    dx, grads, _ = staged(x, dy, packed, rate, H)
    np.testing.assert_allclose(dx.numpy(), dx_ref, **VALUE)
    params = dict(layer.named_parameters())
    module_grads = torch.autograd.grad(list(packed.values()), list(params.values()), grads)
    ref = encoder_layer_state_from_jax(jax.tree_util.tree_map(np.asarray, g_params))
    for (name, _), g in zip(params.items(), module_grads):
        assert_grads_close(g, ref[name].numpy(), name)


def test_staged_backward_where_tiles_straddle_chains_and_chunks_do_not_divide() -> None:
    """B=3 chains of L=19: the tail's 32-row tiles, the weight products' row
    slices and the column sums' slices straddle chains; F=300 is no multiple
    of the tail's d_ff chunk (64) nor of the dx1 product's depth step (32)."""
    b, d_ff, rate = 3, 300, 0.3
    assert fe.tail_plan(D, torch.float32)["tm"] == 32
    assert 300 % fe.tail_plan(D, torch.float32)["fc"] and 300 % fe.GEMM_BK
    torch.manual_seed(7)
    layer = TransformerEncoderLayer(D, H, d_ff)
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(b, L, D)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(b, L, D)).astype(np.float32)
    packed = fet.pack_encoder_layer_train(layer, H)
    ref_dx, *ref_grads = autograd_of_plain(x, dy, packed, rate, H)
    dx, grads, _ = staged(x, dy, packed, rate, H)
    assert_close_to(dx, grads, ref_dx, ref_grads)


def test_given_gates_are_taken_and_its_own_change_nothing() -> None:
    """``gates`` replaces the ReLU gates of the backward (what the card's
    checks put in where a kernel's gate flipped within rounding of 0)."""
    _, layer, x, dy = _layer_case(0.3)
    packed = fet.pack_encoder_layer_train(layer, H)
    dx, grads, stages = staged(x, dy, packed, 0.3, H)
    same = staged(x, dy, packed, 0.3, H, gates=stages["gates"])
    assert torch.equal(dx, same[0]) and all(torch.equal(a, b) for a, b in zip(grads, same[1]))
    flipped = stages["gates"].clone()
    kept = fet.dropout_masks(3, L, D, F, H, SEED, 0.3)["ff"] > 0
    where = kept.nonzero()[0].tolist()
    flipped[tuple(where)] = ~flipped[tuple(where)]
    other = staged(x, dy, packed, 0.3, H, gates=flipped)
    b1 = fet.LAYER_KEYS.index("b1")
    assert not torch.equal(other[1][b1], grads[b1])
