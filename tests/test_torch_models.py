"""Port parity: the unfused ``ScoreTransformer`` of
``fourierdiffusion_tpu_torch`` against the JAX module, on the CPU.

Both get the same weights: JAX initialises its variables and
``state_dict_from_jax`` carries them into the port, or both load the
trained reference checkpoint. Inputs are numpy draws.

Tolerances: fp32 2e-5 absolute and relative (same arithmetic, other
summation orders in the two libraries' matmuls); bf16 is loose, 0.1
absolute on scores of size ~1, because JAX and PyTorch round bf16 at
other places inside their products and additions.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu.models import ScoreModelConfig as JaxConfig
from fourierdiffusion_tpu.models.attention import dot_product_attention
from fourierdiffusion_tpu.utils.torch_import import (
    export_torch_state_dict,
    import_transformer_state_dict,
    load_torch_state_dict,
)
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.models import attention as port_attention
from fourierdiffusion_tpu_torch.utils.weights import (
    load_reference_state_dict,
    state_dict_from_jax,
)

FP32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
CHECKPOINT = Path(__file__).resolve().parents[1] / "runs_reference/ref-freq42-e200/model.pt"
SMALL = dict(d_model=24, n_head=4, num_layers=2, dim_feedforward=64)


def jax_and_port_models(max_len, n_channels, dtype="float32", seed=0, **arch):
    """A JAX ``ScoreTransformer`` with initialised variables (as numpy) and
    the port's model holding the same weights."""
    arch = {**SMALL, **arch}
    jmodel = JaxConfig(model_type="transformer", dtype=dtype, **arch).build(
        n_channels=n_channels, max_len=max_len
    )
    x0 = jnp.zeros((1, max_len, n_channels), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)))
    )
    model = ScoreModelConfig(dtype=dtype, **arch).build(n_channels, max_len)
    model.load_state_dict(state_dict_from_jax(variables, arch["num_layers"]), strict=True)
    return jmodel, variables, model.eval()


def numpy_inputs(batch, max_len, n_channels, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, max_len, n_channels)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, size=(batch,)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("max_len,n_channels", [(19, 1), (16, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_transformer_matches_jax(max_len, n_channels, dtype) -> None:
    jmodel, variables, model = jax_and_port_models(max_len, n_channels, dtype)
    x, t = numpy_inputs(3, max_len, n_channels)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **(FP32 if dtype == "float32" else BF16))


def test_trained_checkpoint_matches_jax() -> None:
    """The trained flagship at full width (d_model 72, 10 layers, 12 heads,
    FFN 2048, L 100) loaded into both packages, unfused, fp32, B=2."""
    jmodel = JaxConfig(model_type="transformer").build(n_channels=1, max_len=100)
    variables = import_transformer_state_dict(load_torch_state_dict(CHECKPOINT), 10)
    model = ScoreModelConfig().build(n_channels=1, max_len=100)
    load_reference_state_dict(model, CHECKPOINT).eval()
    x, t = numpy_inputs(2, 100, 1, seed=4)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_state_dict_from_jax_matches_export() -> None:
    _, variables, _ = jax_and_port_models(19, 1)
    ours = state_dict_from_jax(variables, SMALL["num_layers"])
    ref = export_torch_state_dict(variables, "transformer", SMALL["num_layers"])
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_state_dict_names_match_reference_checkpoint() -> None:
    model = ScoreModelConfig().build(n_channels=1, max_len=100)
    ref = torch.load(CHECKPOINT, map_location="cpu", weights_only=True)
    assert sorted(model.state_dict()) == sorted(ref)


def test_positional_encoding_renorms_without_touching_weight() -> None:
    _, _, model = jax_and_port_models(19, 1)
    with torch.no_grad():
        model.pos_encoder.embedding.weight.mul_(10.0)  # rows far above max_norm
    before = model.pos_encoder.embedding.weight.detach().clone()
    h = torch.zeros(2, 19, SMALL["d_model"])
    with torch.no_grad():
        pe = model.pos_encoder(h)
    torch.testing.assert_close(model.pos_encoder.embedding.weight, before, rtol=0, atol=0)
    norms = torch.linalg.vector_norm(pe[0], dim=-1)
    assert float(norms.max()) <= SMALL["d_model"] ** 0.5 * (1 + 1e-6)


def test_gaussian_projection_W_is_a_buffer() -> None:
    _, _, model = jax_and_port_models(19, 1)
    assert "time_encoder.W" in model.state_dict()
    assert "time_encoder.W" not in dict(model.named_parameters())


def test_attention_matches_jax() -> None:
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 4, 19, 6)).astype(np.float32) for _ in range(3))
    ours = port_attention.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v))
    ).numpy()
    ref = np.asarray(dot_product_attention(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(ours, ref, **FP32)


@pytest.mark.parametrize("model_type", ["mlp", "lstm"])
def test_unported_model_types_raise(model_type: str) -> None:
    with pytest.raises(ValueError, match="not ported"):
        ScoreModelConfig(model_type=model_type).build(1, 19)
