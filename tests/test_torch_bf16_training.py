"""Port parity of bf16 training (a model of ``dtype`` bfloat16 with fp32
parameters) against the JAX package, on the CPU: one training layer
(``ops/fused_encoder_train.py``), one whole step of the fused path
(``models/fused.py``, ``losses.py``, ``training/trainer.py``) and the eval
forward that validation runs; and that the other paths (the unfused
path, ``FDIFF_FUSED_TRAIN=0``, and the MLP and LSTM) start and take a bf16
step with fp32 parameters and gradients (their parity with JAX:
``tests/test_torch_unfused_training.py``, ``tests/test_torch_mlp_lstm.py``).

The JAX side runs its Pallas training kernels in interpret mode in bf16;
the port, given CPU tensors, runs its plain versions, whose backward in
bf16 (``train_backward_staged``) rounds where the TPU kernel rounds.

Tolerances, each with its reason:

* one layer, output and dx: 2**-8 of the largest value. Both sides round
  to bf16 at the same points; an fp32 sum taken in another order (the JAX
  kernel sums over 128 padded lanes, the port over exactly L rows) can flip
  one bf16 rounding, which moves that element by one bf16 ulp (2**-8
  relative). The layer's 12 weight gradients: 2**-7 of each tensor's
  largest, as a flipped rounding of one operand moves a sum by at most an
  ulp of that operand; the matrices' gradients must be bf16 values (the
  TPU kernel's caller rounds them to the packed weights' dtype).
* the whole step's loss: 1e-3 relative (a mean of squared terms, each
  within a few bf16 ulps). The encoder layers' gradients: 2**-7 of each
  tensor's largest, as for one layer. The gradients of the embeddings and
  the unembedding, which no kernel computes: 5e-2. JAX's autodiff sums
  their bf16 cotangents over the B*L rows in bf16, rounding as it goes
  (XLA's CPU reduction), where PyTorch's autograd sums in fp32 and rounds
  once: the embedder's bias, a sum over 76 rows, reads 1.8e-2 apart, the
  others up to 5e-3.
* the eval forward's validation loss: 1e-2 relative, for the rounding
  places of the unfused module in the two libraries (the bf16 scores
  agree to 0.1 absolute, ``tests/test_torch_models.py``).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models, numpy_inputs
from test_torch_training import _jax_loss_draws

from fourierdiffusion_tpu.data.batch import DiffusableBatch as JaxBatch
from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu.ops import fused_encoder_train as jax_fet
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.training.trainer import Trainer as JaxTrainer
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.utils.weights import (
    encoder_layer_state_from_jax,
    state_dict_from_jax,
)

L, C, D, H, F = 19, 2, 24, 4, 64
BF16 = torch.bfloat16
LAYER_VALUE_REL = 2.0**-8
LAYER_GRAD_REL = 2.0**-7
STEP_LOSS_REL = 1e-3
STEP_EMBED_GRAD_REL = 5e-2
VAL_LOSS_REL = 1e-2


def rel(ours: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    diff = np.abs(ours.detach().float().numpy() - ref).max()
    return float(diff) / max(float(np.abs(ref).max()), 1e-6)


def test_bf16_training_layer_matches_jax() -> None:
    """One layer at dropout 0.3: output, dx and the 12 parameter gradients
    (through the bf16 packing) against the JAX kernel's custom VJP."""
    rate, seed = 0.3, 987654
    _, variables, model = jax_and_port_models(L, C, num_layers=1, dim_feedforward=F)
    jparams, layer = variables["params"]["backbone"]["layers_0"], model.backbone.layers[0]
    rng = np.random.default_rng(5)
    x = jnp.asarray((rng.normal(size=(2, L, D)) * 0.5).astype(np.float32)).astype(jnp.bfloat16)
    dy = jnp.asarray(rng.normal(size=(2, L, D)).astype(np.float32)).astype(jnp.bfloat16)

    def jax_layer(params, xt):
        packed = jax_fe.pack_encoder_layer(params, H, jnp.bfloat16)
        return jax_fet.fused_encoder_layer_train((H, L, rate), xt, packed, jnp.int32(seed))

    @jax.jit
    def jax_vjp(params, xt, dyt):
        y, vjp = jax.vjp(jax_layer, params, xt)
        return (y, *vjp(dyt))

    y, g_params, g_xt = jax_vjp(jparams, jax_fe.pad_lanes(jnp.swapaxes(x, 1, 2)),
                                jax_fe.pad_lanes(jnp.swapaxes(dy, 1, 2)))

    def unpad(t):
        return np.asarray(jnp.swapaxes(t[:, :, :L], 1, 2).astype(jnp.float32))

    xp = torch.tensor(np.asarray(x.astype(jnp.float32))).to(BF16).requires_grad_(True)
    packed = fet.pack_encoder_layer_train(layer, H, BF16)
    assert all(packed[k].dtype == (BF16 if k.startswith("w") else torch.float32)
               for k in fet.LAYER_KEYS)
    out = fet.fused_encoder_layer_train(xp, packed, seed, n_head=H, rate=rate)
    assert out.dtype == BF16 and rel(out, unpad(y)) <= LAYER_VALUE_REL
    params = dict(layer.named_parameters())
    dyp = torch.tensor(np.asarray(dy.astype(jnp.float32))).to(BF16)
    grads = torch.autograd.grad(out, [xp, *params.values()], dyp)
    assert grads[0].dtype == BF16 and rel(grads[0], unpad(g_xt)) <= LAYER_VALUE_REL
    ref = encoder_layer_state_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g_params))
    for (name, p), g in zip(params.items(), grads[1:]):
        assert g.dtype == torch.float32 and rel(g, ref[name].numpy()) <= LAYER_GRAD_REL, name
    for name in ("self_attn.out_proj.weight", "linear1.weight", "linear2.weight"):
        g = grads[1 + list(params).index(name)]
        assert torch.equal(g.to(BF16).float(), g), name  # rounded to bf16 on the way out


def test_bf16_fused_train_step_matches_jax(monkeypatch) -> None:
    """The loss and every parameter's gradient of one step of a 2-layer
    bf16 model on the fused path, against the JAX trainer's ``_loss`` with
    the draws it makes from the same key (its fused training forward in
    interpret mode)."""
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "1")
    batch = 2
    jmodel, variables, model = jax_and_port_models(
        L, C, "bfloat16", num_layers=2, dim_feedforward=F, dropout_rate=0.3)
    x = np.random.default_rng(6).normal(size=(batch, L, C)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jsched = JaxVP(fourier_noise_scaling=True)
    jtrainer = JaxTrainer(jmodel, jsched, lr_max=1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    constants = jax.tree_util.tree_map(jnp.asarray, variables["constants"])
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jtrainer._loss), static_argnums=4)(
        params, constants, JaxBatch(X=jnp.asarray(x)), key, True)
    drop_key, loss_key = jax.random.split(key)
    seeds = [int(jax.random.randint(jax.random.fold_in(drop_key, i), (), 0,
                                    jnp.iinfo(jnp.int32).max)) for i in range(2)]
    t, z = _jax_loss_draws(loss_key, x.shape, jsched)

    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
    trainer.start(10)
    loss, grads = trainer.loss_and_grads(torch.from_numpy(x), torch.from_numpy(t),
                                         torch.from_numpy(z), seeds)
    assert abs(loss.item() - float(loss_ref)) <= STEP_LOSS_REL * abs(float(loss_ref))
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_ref)}, 2)
    for name, g in zip(trainer.names, grads):
        tol = LAYER_GRAD_REL if name.startswith("backbone.") else STEP_EMBED_GRAD_REL
        assert g.dtype == torch.float32 and rel(g, ref[name].numpy()) <= tol, name
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_eval_forward_matches_jax() -> None:
    """The validation loss through the module's own forward in eval mode
    (bf16 compute, fp32 parameters) against JAX's flax forward in bf16 on
    the same draws; the parameters stay fp32."""
    jmodel, variables, model = jax_and_port_models(L, C, "bfloat16", num_layers=2,
                                                   dim_feedforward=F)
    x, _ = numpy_inputs(4, L, C, seed=3)
    key = jax.random.PRNGKey(5)
    jsched = JaxVP(fourier_noise_scaling=True)
    jtrainer = JaxTrainer(jmodel, jsched)
    ref = float(jax.jit(jtrainer._loss, static_argnums=4)(
        variables["params"], variables["constants"], JaxBatch(X=jnp.asarray(x)), key, False))
    t, z = _jax_loss_draws(key, x.shape, jsched)
    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
    ours = trainer.val_loss(*(torch.from_numpy(a) for a in (x, t, z))).item()
    assert abs(ours - ref) <= VAL_LOSS_REL * abs(ref)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("model_type,fused", [("transformer", "0"), ("mlp", "1"),
                                              ("lstm", "1")])
def test_every_path_takes_a_bf16_step(monkeypatch, model_type, fused) -> None:
    """The unfused path (``FDIFF_FUSED_TRAIN=0``) and the MLP and LSTM (which
    take it whatever the variable says) train in bf16: the trainer sets out
    and takes steps at dropout 0.1, the losses finite, the parameters,
    their gradients and the EMA fp32, and the parameters moved by the second
    step (the schedule's rate is 0 at the first update)."""
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", fused)
    arch = dict(d_model=8, num_layers=1, n_head=2, dim_feedforward=16, d_mlp=16)
    model = ScoreModelConfig(model_type=model_type, dtype="bfloat16", **arch).build(C, L, seed=0)
    trainer = Trainer(model, VPScheduler(), device="cpu")
    trainer.start(4)
    assert not trainer.fused()
    x, t = (torch.from_numpy(a) for a in numpy_inputs(2, L, C))
    z = torch.from_numpy(np.random.default_rng(4).normal(size=x.shape).astype(np.float32))
    before = [p.detach().clone() for p in trainer.params]
    _, grads = trainer.loss_and_grads(x, t, z, generator=torch.Generator().manual_seed(1))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    for seed in (1, 2):
        loss = trainer.train_step(x, t, z, generator=torch.Generator().manual_seed(seed))
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in trainer.ema.values())
    assert any(not torch.equal(p.detach(), b) for p, b in zip(trainer.params, before))


def test_chip_smoke_trains_the_bf16_runs_configuration(tmp_path) -> None:
    """``chip_smoke.py`` phase 20 (c) trains ``runs/94c6eb87`` (the flagship
    trained in bf16) through overrides, as the card's copy of the repository
    holds no ``runs/``: they compose to that run's configuration on every
    leaf but the directories and the epochs the phase cuts."""
    import chip_smoke

    from fourierdiffusion_tpu_torch.utils import yamlio
    from fourierdiffusion_tpu_torch.utils.config import compose

    def leaves(cfg: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in cfg.items():
            out.update(leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
        return out

    repo = Path(chip_smoke.__file__).resolve().parent
    saved = leaves(yamlio.load(repo / chip_smoke.BF16_RUN))
    composed = leaves(compose("train", chip_smoke.bf16_cli_overrides(tmp_path, "bfloat16")))
    cut = ("run_dir", "datamodule.data_dir", "trainer.max_epochs")
    differ = {k: (v, composed.get(k)) for k, v in saved.items()
              if k not in cut and composed.get(k) != v}
    assert not differ
    assert composed["score_model.dtype"] == "bfloat16"
    assert composed["trainer.max_epochs"] == chip_smoke.BF16_EPOCHS
