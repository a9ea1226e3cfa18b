"""Port parity of the training layer (``ops/fused_encoder_train.py``) and
the training forward (``models/fused.py::fused_score_training_forward``)
against the JAX package, on the CPU.

The JAX side runs its Pallas training kernels in interpret mode, as
``tests/test_fused_train.py`` does; the port's wrapper, given CPU tensors,
runs its plain PyTorch version, and autograd through it is the plain
backward. The kernels themselves run only on a CUDA card
(``tests/test_torch_cuda.py``).

Tolerances: the dropout masks are compared bit for bit (the same hash of
the same positions). Values 1e-5 absolute and relative, gradients 1e-4 of
the largest gradient of each tensor: the same fp32 arithmetic, summed in
other orders by the two libraries (the JAX kernel sums over 128 padded lanes,
the port over exactly L rows).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import jax_and_port_models, numpy_inputs

from fourierdiffusion_tpu.models import fused as jax_fused
from fourierdiffusion_tpu.ops import flash_attention as jax_fa
from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu.ops import fused_encoder_train as jax_fet
from fourierdiffusion_tpu_torch.models.fused import fused_score_training_forward
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.utils.weights import (
    encoder_layer_state_from_jax,
    state_dict_from_jax,
)

L, C, D, H, F = 19, 2, 24, 4, 64
VALUE = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4


def assert_grads_close(ours: torch.Tensor, ref: np.ndarray, name: str) -> None:
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(ours.detach().numpy() - ref).max()) / scale
    assert err < GRAD_REL, (name, err)


# ---- masks -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
def test_hash_bits_match_jax(seed: int) -> None:
    shape = (3, 5, 7)
    idx = np.arange(np.prod(shape), dtype=np.int64).reshape(shape)
    for tag in (seed, (seed + 131071 * 3 + 7919 * 2 + 104729 * 6) % 2**32):
        ref = np.asarray(jax_fa._hash_bits(shape, jnp.asarray(tag, jnp.uint32)))
        i0, i1, i2 = np.unravel_index(idx, shape)
        pos = ((((i0 * 1000003) % 2**32) * 19349663 + i1) % 2**32 * 19349663 + i2) % 2**32
        ours = fet.hash_bits(torch.from_numpy(pos), tag).numpy()
        np.testing.assert_array_equal(ours, ref.astype(np.int64))


def _jax_masks(batch: int, lp: int, d_ff: int, group: int, seed: int, rate: float,
               d_model: int = D, n_head: int = H):
    """The JAX kernel's masks, drawn by ``_keep`` inside an interpret-mode
    Pallas call with one program per chain: ATTN (groups, g, Lp, Lp)."""
    n_groups = n_head // group
    shapes = {"attn": (n_groups, group, lp, lp), "out": (d_model, lp), "ff": (d_ff, lp),
              "ff2": (d_model, lp)}

    def kernel(seed_ref, attn_ref, out_ref, ff_ref, ff2_ref):
        s = seed_ref[0]
        for gi in range(n_groups):
            attn_ref[0, gi] = jax_fet._keep(
                (group, lp, lp), rate, s, jax_fet._SITE_ATTN, extra=gi * group
            )
        out_ref[0] = jax_fet._keep((d_model, lp), rate, s, jax_fet._SITE_OUT)
        ff_ref[0] = jax_fet._keep((d_ff, lp), rate, s, jax_fet._SITE_FF)
        ff2_ref[0] = jax_fet._keep((d_model, lp), rate, s, jax_fet._SITE_FF2)

    def spec(shape):
        return pl.BlockSpec((1,) + shape, lambda b, s, _n=len(shape): (b,) + (0,) * _n,
                            memory_space=pltpu.VMEM)

    names = ("attn", "out", "ff", "ff2")
    outs = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(batch,), in_specs=[],
            out_specs=[spec(shapes[k]) for k in names],
        ),
        out_shape=[jax.ShapeDtypeStruct((batch,) + shapes[k], jnp.float32) for k in names],
        interpret=True,
    )(jnp.asarray([seed], jnp.int32))
    return {k: np.asarray(v) for k, v in zip(names, outs)}


@pytest.mark.parametrize(
    "max_len,seed,rate",
    [(19, 1234, 0.3), (19, 2**31 - 2, 0.1), (400, 77, 0.1)],
    ids=["L19", "L19-tag-wraps", "L400-two-head-groups"],
)
def test_masks_match_jax_bit_for_bit(max_len: int, seed: int, rate: float) -> None:
    batch = 2
    lp = -(-max_len // 128) * 128
    group = fet.train_group(H, max_len)
    assert group == jax_fet._train_group(H, lp, 1)
    if max_len == 400:
        assert group == 2  # the attention site splits into two head groups
    ref = _jax_masks(batch, lp, F, group, seed, rate)
    ours = {k: v.numpy() for k, v in fet.dropout_masks(batch, max_len, D, F, H, seed, rate).items()}
    # JAX (B, n_groups, g, Lp, Lp) -> (B, H, L, L); (B, rows, Lp) -> (B, L, rows).
    attn = ref["attn"].reshape(batch, H, lp, lp)[:, :, :max_len, :max_len]
    np.testing.assert_array_equal(ours["attn"], attn)
    for key in ("out", "ff", "ff2"):
        np.testing.assert_array_equal(ours[key], ref[key][:, :, :max_len].transpose(0, 2, 1))
    kept = np.mean(ours["ff"] > 0)
    assert abs(kept - (1 - rate)) < 0.02


def test_flagship_ecg_length_splits_heads() -> None:
    assert fet.train_group(12, 100) == 12
    assert fet.train_group(12, 187) == 6
    assert fet.train_group(12, 187) == jax_fet._train_group(12, 256, 1)


# ---- one layer -------------------------------------------------------------------


def _layer_case(rate: float):
    jmodel, variables, model = jax_and_port_models(L, C, num_layers=1, dim_feedforward=F)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, L, D)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(3, L, D)).astype(np.float32)
    return variables["params"]["backbone"]["layers_0"], model.backbone.layers[0], x, dy


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_training_layer_matches_jax(rate: float) -> None:
    jparams, layer, x, dy = _layer_case(rate)
    seed = 987654

    def jax_layer(params, xt):
        packed = jax_fe.pack_encoder_layer(params, H, jnp.float32)
        return jax_fet.fused_encoder_layer_train((H, L, rate), xt, packed, jnp.int32(seed))

    xt = jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(x), 1, 2))
    y, vjp = jax.vjp(jax_layer, jparams, xt)
    dyt = jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(dy), 1, 2))
    g_params, g_xt = vjp(dyt)
    y_ref = np.asarray(jnp.swapaxes(y[:, :, :L], 1, 2))
    dx_ref = np.asarray(jnp.swapaxes(g_xt[:, :, :L], 1, 2))

    xp = torch.from_numpy(x).requires_grad_(True)
    packed = fet.pack_encoder_layer_train(layer, H)
    out = fet.fused_encoder_layer_train(xp, packed, seed, n_head=H, rate=rate)
    np.testing.assert_allclose(out.detach().numpy(), y_ref, **VALUE)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(out, [xp, *params.values()], torch.from_numpy(dy))
    assert_grads_close(grads[0], dx_ref, "x")
    ref = encoder_layer_state_from_jax(jax.tree_util.tree_map(np.asarray, g_params))
    for (name, _), g in zip(params.items(), grads[1:]):
        assert_grads_close(g, ref[name].numpy(), name)


def test_pack_train_is_differentiable_and_matches_sampling_pack() -> None:
    _, layer, _, _ = _layer_case(0.0)
    packed = fet.pack_encoder_layer_train(layer, H)
    from fourierdiffusion_tpu_torch.ops.fused_encoder import pack_encoder_layer

    frozen = pack_encoder_layer(layer, H, torch.float32)
    for key in fet.LAYER_KEYS:
        assert packed[key].requires_grad, key
        torch.testing.assert_close(packed[key].detach(), frozen[key], rtol=0, atol=0)
        assert packed[key].is_contiguous()


def test_layer_rejects_bad_input() -> None:
    _, layer, x, _ = _layer_case(0.1)
    packed = fet.pack_encoder_layer_train(layer, H)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fet.fused_encoder_layer_train(torch.zeros(2, L, D, dtype=torch.float16), packed, 1,
                                      n_head=H, rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        fet.fused_encoder_layer_train(torch.from_numpy(x), packed, 1, n_head=H, rate=1.0)
    with pytest.raises(ValueError, match="w_qkv"):
        fet.fused_encoder_layer_train(torch.zeros(2, L, 20), packed, 1, n_head=H, rate=0.1)


# ---- the whole training forward ---------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_training_forward_matches_jax(rate: float) -> None:
    jmodel, variables, model = jax_and_port_models(
        L, C, num_layers=2, dim_feedforward=F, dropout_rate=rate
    )
    x, t = numpy_inputs(4, L, C, seed=7)
    w = np.random.default_rng(8).normal(size=(4, L, C)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    seeds = [
        int(jax.random.randint(jax.random.fold_in(key, i), (), 0, jnp.iinfo(jnp.int32).max))
        for i in range(2)
    ]

    def loss(params):
        out = jax_fused.fused_score_training_forward(
            jmodel, params, variables["constants"], jnp.asarray(x), jnp.asarray(t), key
        )
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out_ref), g_ref = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    ours = fused_score_training_forward(model, torch.from_numpy(x), torch.from_numpy(t), seeds)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out_ref), **VALUE)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad((ours * torch.from_numpy(w)).sum(), list(model.parameters()))
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, g_ref)}, 2)
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        assert_grads_close(g, ref[name].numpy(), name)


def test_training_forward_without_dropout_matches_module() -> None:
    _, _, model = jax_and_port_models(L, C, num_layers=2, dim_feedforward=F, dropout_rate=0.0)
    x, t = (torch.from_numpy(a) for a in numpy_inputs(3, L, C, seed=4))
    torch.testing.assert_close(
        fused_score_training_forward(model, x, t, [1, 2]), model(x, t), **VALUE
    )


def test_training_forward_needs_one_seed_per_layer() -> None:
    _, _, model = jax_and_port_models(L, C, num_layers=2, dim_feedforward=F)
    x, t = (torch.from_numpy(a) for a in numpy_inputs(3, L, C))
    with pytest.raises(ValueError, match="seeds"):
        fused_score_training_forward(model, x, t, [1])


# ---- the gate-matched reference of chip_smoke.py's B4 check -------------------------


def test_gate_matched_grads_locates_a_flipped_relu_gate() -> None:
    """``chip_smoke.gate_matched_grads`` finds a ReLU gate whose input is
    within rounding of 0 and that the backward under test opened, and its
    gate-matched fp64 gradients then agree with that backward. The backward
    under test is the plain version in fp64 with the unit's bias raised by a
    few 1e-13, which opens the gate; the check sees the bias before that."""
    import chip_smoke

    rng = np.random.default_rng(11)
    rate, seed, batch = 0.3, 77, 2
    layer = {k: torch.from_numpy(rng.normal(size=s).astype(np.float64) * 0.3) for k, s in (
        ("w_qkv", (D, 3 * D)), ("b_qkv", (3 * D,)), ("w_out", (D, D)), ("b_out", (D,)),
        ("ln1_s", (D,)), ("ln1_b", (D,)), ("w1", (D, F)), ("b1", (F,)), ("w2", (F, D)),
        ("b2", (D,)), ("ln2_s", (D,)), ("ln2_b", (D,)))}
    x = torch.from_numpy(rng.normal(size=(batch, L, D)))
    dy = torch.from_numpy(rng.normal(size=(batch, L, D)))
    masks = fet.dropout_masks(batch, L, D, F, H, seed, rate)
    x1 = fet.attention_sublayer(x, layer, masks, H)
    pre = x1 @ layer["w1"] + layer["b1"]
    b, l, f = 1, 7, next(f for f in range(F) if masks["ff"][1, 7, f] > 0)
    layer["b1"][f] -= pre[b, l, f] + 1e-13  # this gate's input is now just below 0

    def grads(lay):
        xx = x.clone().requires_grad_(True)
        lay = {k: v.clone().requires_grad_(True) for k, v in lay.items()}
        out = fet.fused_encoder_layer_train_reference(xx, lay, seed, n_head=H, rate=rate)
        return torch.autograd.grad(out, [xx, *lay.values()], dy)

    opened = {**layer, "b1": layer["b1"].clone()}
    opened["b1"][f] += 3e-13
    under_test, shut = grads(opened), grads(layer)
    i_b1 = 1 + fet.LAYER_KEYS.index("b1")
    matched, flips, n_near = chip_smoke.gate_matched_grads(
        x, dy, layer, seed, under_test[i_b1], masks, H)

    assert n_near >= 1
    assert [(r["chain"], r["row"], r["unit"]) for r in flips] == [(b, l, f)]
    assert chip_smoke.rel_err(under_test[i_b1], shut[i_b1]) > 1e-3  # the flip shows
    for name, g, m in zip(["x", *fet.LAYER_KEYS], under_test, matched):
        assert chip_smoke.rel_err(g, m) < 1e-9, name
