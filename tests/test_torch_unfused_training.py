"""Port parity of unfused training (``FDIFF_FUSED_TRAIN=0``: the module's
own forward in training mode, its attention through ``flash_attention`` or
``flash_attention_dropout``) against the JAX trainer, on the CPU; the
default dropout rate (C2) and the definition of ``steps_per_sec`` (C3).

The JAX side builds its ``ScoreTransformer`` with ``use_pallas=True``, so
its attention runs the Pallas kernels (``_fwd_kernel`` and ``_bwd_kernel``)
in interpret mode, as on the TPU; the port runs the plain versions on CPU
tensors. JAX's ``t`` and ``z`` are re-derived from its keys and handed in.
At a rate above 0 the FFN sites' draws come from ``jax.random`` in JAX and
from a ``torch.Generator`` in the port, so they cannot match: the attention
site is held to JAX in ``tests/test_torch_attention.py``, and here the
port's draws are held to repeat from one generator state.

Tolerances: the loss 1e-5 relative, gradients 1e-4 of each tensor's largest
entry (the same fp32 arithmetic summed in other orders).

In bf16 (a model of ``dtype`` bfloat16, fp32 parameters) the step at rate 0
is held to JAX's with the FFN ReLU gates located and matched. The two
libraries round bf16 at other points (JAX's linear layers round ``x W`` to
bf16 and then add the bias in bf16, PyTorch adds it to the fp32 sum; the
LayerNorm and residual casts differ too), so a pre-activation within a few
bf16 ulps of 0 can take the other sign: at the test's shapes 3 to 11 gates
per layer do, each within BF16_GATE_BAND of its sum of |terms| from 0, and
each moves a row of ``linear1.weight``'s gradient by its whole share
(7.5e-2 of that tensor's largest entry unmatched). The port's gates are
forced to JAX's (``chip_smoke.unfused_step0``), and then (the ranges over
four draws, ``scripts/bf16_parity_probe.py unfused``):

* the loss, 1e-3 relative (a mean of squared terms, each within a few bf16
  ulps; 5.7e-5 to 3.0e-4);
* every weight matrix and LayerNorm parameter, 2**-6 of each tensor's
  largest (two bf16 ulps: the cotangents that meet in their sums differ by
  an ulp here and there through those rounding points; at most 9.6e-3);
* the bias of every linear layer, 2**-6 against the sum in fp32 of JAX's
  own cotangents of that layer's output in the same step (taken by
  ``flax.linen.intercept_methods``), not against JAX's gradient: JAX sums a
  broadcast bias's bf16 cotangents over the B*L rows in bf16 (XLA's CPU
  reduction), where PyTorch's autograd sums in fp32 and rounds once. JAX's
  worst bias gradient per draw lies 1.7e-2 to 5.0e-2 from that fp32 sum
  (the 5.0e-2 in the v third of ``in_proj_bias``), the port's at most
  9.4e-3;
* the positional embedding, 2**-5 (7.5e-3 to 1.4e-2): each entry of its
  gradient sums only the B rows of the cotangent at the backbone's input,
  which has come back through every layer's bf16 roundings, where a
  weight's gradient sums B*L rows and averages those differences down.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models
from test_torch_train_layer import assert_grads_close
from test_torch_training import _jax_loss_draws

from fourierdiffusion_tpu.data.batch import DiffusableBatch as JaxBatch
from fourierdiffusion_tpu.models import ScoreModelConfig as JaxConfig
from fourierdiffusion_tpu.models.score_models import ScoreTransformer as JaxScoreTransformer
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.training.trainer import Trainer as JaxTrainer
from fourierdiffusion_tpu_torch.data import DummyDatamodule
from fourierdiffusion_tpu_torch.models import ScoreModelConfig, ScoreTransformer
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.training import trainer as trainer_module
from fourierdiffusion_tpu_torch.utils.weights import state_dict_from_jax

L, C, B = 20, 2, 4
ARCH = dict(d_model=48, n_head=12, num_layers=2, dim_feedforward=64)


@pytest.fixture
def unfused(monkeypatch) -> None:
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "0")


def test_unfused_step_at_rate_0_matches_jax(unfused) -> None:
    """One step's loss and every parameter gradient against JAX's unfused
    trainer (attention: ``flash_attention`` forward and its ``_bwd_kernel``)."""
    _, variables, model = jax_and_port_models(L, C, dropout_rate=0.0, **ARCH)
    jmodel = JaxConfig(model_type="transformer", dropout_rate=0.0, use_pallas=True,
                       **ARCH).build(n_channels=C, max_len=L)
    jsched = JaxVP(fourier_noise_scaling=True)
    jtrainer = JaxTrainer(jmodel, jsched)
    assert not jtrainer._use_fused_train()
    x = np.random.default_rng(12).normal(size=(B, L, C)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    constants = jax.tree_util.tree_map(jnp.asarray, variables["constants"])
    loss_ref, grads_ref = jax.value_and_grad(jtrainer._loss)(
        params, constants, JaxBatch(X=jnp.asarray(x)), key, True
    )
    t, z = (np.array(a) for a in _jax_loss_draws(jax.random.split(key)[1], x.shape, jsched))

    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
    assert not trainer_module.use_fused_train()
    loss, grads = trainer.loss_and_grads(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z),
        generator=torch.Generator(),
    )
    assert model.training
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5, atol=0)
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_ref)}, 2)
    assert set(ref) == set(trainer.names)
    for name, g in zip(trainer.names, grads):
        assert_grads_close(g, ref[name].numpy(), name)


BF16_GATE_BAND = 2.0**-5
BF16_LOSS_REL = 1e-3
BF16_GRAD_REL = 2.0**-6
BF16_POS_EMBEDDING_REL = 2.0**-5


def jax_step_with_linear_cotangents(jtrainer, variables, x: np.ndarray, key) -> tuple:
    """JAX's loss, parameter gradients and, by module path ("a/b/c"), the
    cotangent of every ``TorchLinear``'s output in one training step: a
    zero of the output's shape and dtype is added to each output by
    ``flax.linen.intercept_methods`` and differentiated with the
    parameters."""
    import flax.linen as nn

    from fourierdiffusion_tpu.models.blocks import TorchLinear

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    constants = jax.tree_util.tree_map(jnp.asarray, variables["constants"])
    batch = JaxBatch(X=jnp.asarray(x))

    def loss(p, zeros):
        def add_zero(call, args, kwargs, context):
            y = call(*args, **kwargs)
            if context.method_name != "__call__" or not isinstance(context.module, TorchLinear):
                return y
            path = "/".join(context.module.path)
            if zeros is None:
                shapes[path] = jax.ShapeDtypeStruct(y.shape, y.dtype)
                return y
            return y + zeros[path]

        with nn.intercept_methods(add_zero):
            return jtrainer._loss(p, constants, batch, key, True)

    shapes: dict = {}
    jax.eval_shape(loss, params, None)
    zeros = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    value, (grads, cotangents) = jax.value_and_grad(loss, argnums=(0, 1))(params, zeros)
    return value, grads, cotangents


def linear_bias_sums(cotangents: dict) -> dict:
    """The port's name of each linear layer's bias, with the sum in fp32 of
    the layer's output cotangents over every row."""
    out = {}
    for path, c in cotangents.items():
        name = path.replace("/", ".").replace("layers_", "layers.")
        name = name.replace("self_attn.in_proj", "self_attn.in_proj_bias")
        name = name if name.endswith("in_proj_bias") else name + ".bias"
        c = np.asarray(c.astype(jnp.float32))
        out[name] = c.reshape(-1, c.shape[-1]).sum(0, dtype=np.float64)
    return out


def test_bf16_unfused_step_at_rate_0_matches_jax(unfused) -> None:
    """One bf16 step's loss and every gradient against JAX's unfused trainer
    (its attention through the Pallas kernels, interpret mode, in bf16: the
    fast forward and ``_bwd_kernel``; the port's through their plain
    versions), with the FFN ReLU gates that take the other sign located and
    matched, and the linear layers' biases against the fp32 sums of JAX's
    cotangents; the parameters and gradients stay fp32."""
    import chip_smoke

    _, variables, model = jax_and_port_models(L, C, "bfloat16", dropout_rate=0.0, **ARCH)
    jmodel = JaxConfig(model_type="transformer", dropout_rate=0.0, use_pallas=True,
                       dtype="bfloat16", **ARCH).build(n_channels=C, max_len=L)
    jsched = JaxVP(fourier_noise_scaling=True)
    x = np.random.default_rng(12).normal(size=(B, L, C)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    loss_ref, grads_ref, cotangents = jax_step_with_linear_cotangents(
        JaxTrainer(jmodel, jsched), variables, x, key)
    t, z = (torch.from_numpy(np.array(a))
            for a in _jax_loss_draws(jax.random.split(key)[1], x.shape, jsched))
    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
    step = (torch.from_numpy(x), t, z, None)

    seen = []
    forward = model.forward
    model.forward = lambda xt, tt, *a, **k: seen.append((xt, tt)) or forward(xt, tt, *a, **k)
    _, gates, pres, terms = chip_smoke.unfused_step0(trainer, step)
    del model.forward
    (xt, tt), = seen
    _, inter = jmodel.apply(variables, jnp.asarray(xt.detach().numpy()),
                            jnp.asarray(tt.detach().numpy()), True,
                            capture_intermediates=True, mutable=["intermediates"])
    layers = inter["intermediates"]["backbone"]
    jax_gates = {i: torch.from_numpy(np.asarray(
        layers[f"layers_{i}"]["linear1"]["__call__"][0].astype(jnp.float32)) > 0)
        for i in gates}
    flips = {i: gates[i] != jax_gates[i] for i in gates}
    assert 0 < sum(int(f.sum()) for f in flips.values())
    for i, where in flips.items():
        assert bool((pres[i].float().abs()[where] <= BF16_GATE_BAND * terms[i][where]).all()), i
    # Every gate takes JAX's sign (a no-op where they agree), so that gates
    # of a later layer that flip only once an earlier layer's are forced
    # are matched too.
    grads = chip_smoke.unfused_step0(
        trainer, step, {i: (torch.ones_like(g), g) for i, g in jax_gates.items()})[0]
    loss = trainer.train_loss(*step[:3], generator=torch.Generator())
    assert abs(loss.item() - float(loss_ref)) <= BF16_LOSS_REL * abs(float(loss_ref))
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_ref)}, 2)
    bias_sums = linear_bias_sums(cotangents)
    assert len(bias_sums) == 3 + 4 * ARCH["num_layers"] and set(bias_sums) <= set(trainer.names)
    for name, g in zip(trainer.names, grads):
        r = bias_sums.get(name, ref[name].numpy())
        tol = BF16_POS_EMBEDDING_REL if name.startswith("pos_encoder.") else BF16_GRAD_REL
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max(), name
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _unfused_trainer(rate: float) -> tuple[Trainer, tuple]:
    _, _, model = jax_and_port_models(L, C, dropout_rate=rate, **ARCH)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(B, L, C)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(1e-3, 1.0, size=(B,)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(B, L, C)).astype(np.float32))
    return Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu"), (x, t, z)


def test_unfused_losses_repeat_from_one_generator_state(unfused) -> None:
    trainer, batch = _unfused_trainer(0.1)
    a = trainer.loss_and_grads(*batch, generator=torch.Generator().manual_seed(5))
    b = trainer.loss_and_grads(*batch, generator=torch.Generator().manual_seed(5))
    c = trainer.loss_and_grads(*batch, generator=torch.Generator().manual_seed(6))
    assert a[0].item() == b[0].item() != c[0].item()
    for ga, gb in zip(a[1], b[1]):
        assert torch.equal(ga, gb)


def test_unfused_path_draws_dropout_only_at_rates_above_0(unfused) -> None:
    for rate, draws in ((0.0, False), (0.1, True)):
        trainer, batch = _unfused_trainer(rate)
        g = torch.Generator().manual_seed(7)
        state = g.get_state()
        trainer.loss_and_grads(*batch, generator=g)
        assert (not torch.equal(g.get_state(), state)) == draws, rate


def test_plain_unfused_path_takes_the_same_draws(unfused) -> None:
    """``plain=True`` consumes the generator as the default path does (on the
    CPU both run the plain versions, so the losses agree exactly)."""
    trainer, batch = _unfused_trainer(0.1)
    plain = Trainer(trainer.model, VPScheduler(fourier_noise_scaling=True), device="cpu",
                    plain=True)
    ga, gb = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    a = trainer.loss_and_grads(*batch, generator=ga)[0]
    b = plain.loss_and_grads(*batch, generator=gb)[0]
    assert a.item() == b.item() and torch.equal(ga.get_state(), gb.get_state())


def test_unfused_fit_trains_without_the_fused_forward(unfused, monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise AssertionError("the unfused path called the fused training forward")

    monkeypatch.setattr(trainer_module, "fused_score_training_forward", refuse)
    _, _, model = jax_and_port_models(16, 2, num_layers=1, dim_feedforward=32,
                                      dropout_rate=0.1)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=16, standardize=True)
    dm.prepare_data()
    dm.setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    history = Trainer(model, VPScheduler(), max_epochs=2, ema_decay=0.999,
                      device="cpu").fit(dm)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["train/loss"]) and np.isfinite(h["val/loss"]) for h in history)
    assert len({h["train/loss"] for h in history}) == 2
    for n, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


def test_fused_path_is_the_default(monkeypatch) -> None:
    monkeypatch.delenv("FDIFF_FUSED_TRAIN", raising=False)
    assert trainer_module.use_fused_train()
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "1")
    assert trainer_module.use_fused_train()
    trainer, batch = _unfused_trainer(0.1)
    with pytest.raises(ValueError, match="layer_seeds"):
        trainer.train_loss(*batch)


# ---- C2: the default dropout rate --------------------------------------------------


def test_dropout_rate_defaults_to_jax_value() -> None:
    jax_default = {f.name: f.default for f in dataclasses.fields(JaxConfig)}["dropout_rate"]
    assert jax_default == 0.1
    assert ScoreModelConfig().dropout_rate == jax_default
    model = ScoreTransformer(n_channels=1, max_len=19, d_model=24, n_head=4, num_layers=1,
                             dim_feedforward=32)
    assert model.dropout_rate == JaxScoreTransformer.dropout_rate == jax_default
    assert all(layer.dropout_rate == jax_default and layer.self_attn.dropout_rate == jax_default
               for layer in model.backbone.layers)
    assert ScoreModelConfig(d_model=24, n_head=4, num_layers=1).build(1, 19).dropout_rate == 0.1


# ---- C3: steps_per_sec -----------------------------------------------------------------


class _Clock:
    """``time.perf_counter`` that moves by one second on every reading."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1.0
        return self.now


def test_steps_per_sec_counts_validation_and_guard(monkeypatch) -> None:
    """JAX's definition: steps over the seconds from the start of the epoch
    through validation and the rollback guard. The clock reads t0, the end
    of training, the start and end of validation, then the end of the
    guard: 1 s of training, 1 s of validation, 4 s in all."""
    monkeypatch.setattr(trainer_module, "time", _Clock())
    _, _, model = jax_and_port_models(16, 2, num_layers=1, dim_feedforward=32)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=16, standardize=True)
    dm.prepare_data()
    dm.setup()
    history = Trainer(model, VPScheduler(), max_epochs=2, device="cpu").fit(dm)
    for h in history:
        assert h["train_seconds"] == 1.0 and h["val_seconds"] == 1.0
        assert h["steps_per_sec"] == dm.steps_per_epoch / 4.0


# ---- the gate-matched reference of chip_smoke.py's unfused check ---------------------


def test_unfused_step0_records_and_forces_relu_gates(unfused) -> None:
    """``chip_smoke.unfused_step0`` records every layer's FFN ReLU gates; forcing
    them to the recorded values changes nothing, and forcing one open gate
    shut takes that position's gradient out of ``linear1``'s."""
    import chip_smoke

    trainer, (x, t, z) = _unfused_trainer(0.1)
    step = (x, t, z, None)
    grads, gates, pres, terms = chip_smoke.unfused_step0(trainer, step)
    assert sorted(gates) == [0, 1] and gates[0].shape == (B, L, ARCH["dim_feedforward"])
    assert torch.equal(gates[1], pres[1] > 0) and bool((terms[1] >= pres[1].abs()).all())
    same = chip_smoke.unfused_step0(
        trainer, step, {i: (torch.ones_like(g), g) for i, g in gates.items()})[0]
    for a, b in zip(grads, same):
        assert torch.equal(a, b)
    where = torch.zeros_like(gates[1])
    b, l, u = gates[1].nonzero()[0].tolist()
    where[b, l, u] = True
    forced, regates = chip_smoke.unfused_step0(trainer, step, {1: (where, ~where)})[:2]
    assert torch.equal(regates[1], gates[1])  # recorded before forcing
    i_b1 = trainer.names.index("backbone.layers.1.linear1.bias")
    assert not torch.equal(forced[i_b1][u], grads[i_b1][u])
