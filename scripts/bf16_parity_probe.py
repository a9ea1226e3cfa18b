"""How far the port's bf16 training steps lie from the JAX package's, on the
CPU, over several draws: the numbers behind the bf16 tolerances of
``tests/test_torch_unfused_training.py`` and ``tests/test_torch_mlp_lstm.py``.

* ``unfused``: one bf16 step of the unfused transformer at dropout 0 (the
  tests' shapes: L=20, C=2, B=4, d_model 48, 12 heads, 2 layers, FFN 64)
  against JAX's trainer with ``use_pallas=True`` (its Pallas attention in
  interpret mode), with the FFN ReLU gates that take the other sign in the
  two forwards located and the port's forced to JAX's: per draw the flips
  per layer, the loss's relative gap, and the worst gradient, of each
  tensor's largest entry: among the weight matrices and LayerNorm
  parameters; among the linear layers' biases, the port's and JAX's each
  against the sum in fp32 of JAX's cotangents of the layer's output in the
  same step (JAX sums them in bf16); and the positional embedding.
* ``mlp``, ``lstm``: one bf16 step of ``ScoreMLP`` / ``ScoreLSTM`` (d_model
  16, 2 layers, d_mlp 32, L=12, C=2, B=4, dropout 0) against JAX's: the
  loss's relative gap and the worst gradient per draw.

Run it from the repository root (each part takes under a minute)::

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python scripts/bf16_parity_probe.py unfused mlp lstm
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fourierdiffusion_tpu.data.batch import DiffusableBatch as JaxBatch
from fourierdiffusion_tpu.losses import sde_loss as jax_sde_loss
from fourierdiffusion_tpu.models import ScoreModelConfig as JaxConfig
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.training.trainer import Trainer as JaxTrainer
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.utils.weights import state_dict_from_jax

DRAWS = ((12, 13), (22, 23), (32, 33), (42, 43))  # (x seed, JAX key) per draw


def rel(ours: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(ours.detach().numpy() - ref).max() / np.abs(ref).max())


def unfused() -> None:
    import chip_smoke
    from test_torch_models import jax_and_port_models
    from test_torch_training import _jax_loss_draws
    from test_torch_unfused_training import jax_step_with_linear_cotangents, linear_bias_sums

    os.environ["FDIFF_FUSED_TRAIN"] = "0"
    arch = dict(d_model=48, n_head=12, num_layers=2, dim_feedforward=64)
    for xs, ks in DRAWS:
        _, variables, model = jax_and_port_models(20, 2, "bfloat16", seed=xs % 5,
                                                  dropout_rate=0.0, **arch)
        jmodel = JaxConfig(model_type="transformer", dropout_rate=0.0, use_pallas=True,
                           dtype="bfloat16", **arch).build(n_channels=2, max_len=20)
        jsched = JaxVP(fourier_noise_scaling=True)
        x = np.random.default_rng(xs).normal(size=(4, 20, 2)).astype(np.float32)
        key = jax.random.PRNGKey(ks)
        loss_ref, grads_ref, cotangents = jax_step_with_linear_cotangents(
            JaxTrainer(jmodel, jsched), variables, x, key)
        t, z = (torch.from_numpy(np.array(a))
                for a in _jax_loss_draws(jax.random.split(key)[1], x.shape, jsched))
        trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
        step = (torch.from_numpy(x), t, z, None)
        seen = []
        forward = model.forward
        model.forward = lambda xt, tt, *a, **k: seen.append((xt, tt)) or forward(xt, tt, *a, **k)
        _, gates, _, _ = chip_smoke.unfused_step0(trainer, step)
        del model.forward
        (xt, tt), = seen
        _, inter = jmodel.apply(variables, jnp.asarray(xt.detach().numpy()),
                                jnp.asarray(tt.detach().numpy()), True,
                                capture_intermediates=True, mutable=["intermediates"])
        jax_gates = {i: torch.from_numpy(np.asarray(
            inter["intermediates"]["backbone"][f"layers_{i}"]["linear1"]["__call__"][0]
            .astype(jnp.float32)) > 0) for i in gates}
        flips = {i: gates[i] != jax_gates[i] for i in gates}
        grads = chip_smoke.unfused_step0(
            trainer, step, {i: (torch.ones_like(g), g) for i, g in jax_gates.items()})[0]
        loss = trainer.train_loss(*step[:3], generator=torch.Generator()).item()
        ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_ref)}, 2)
        sums = linear_bias_sums(cotangents)
        grads = dict(zip(trainer.names, grads))
        weights = max((rel(g, ref[n].numpy()), n) for n, g in grads.items()
                      if n not in sums and not n.startswith("pos_encoder."))
        port_bias = max((rel(grads[n], f), n) for n, f in sums.items())
        jax_bias = max((rel(torch.from_numpy(ref[n].numpy()), f), n) for n, f in sums.items())
        embedding = rel(grads["pos_encoder.embedding.weight"],
                        ref["pos_encoder.embedding.weight"].numpy())
        print(f"unfused draw {xs}: gate flips per layer "
              f"{ {i: int(f.sum()) for i, f in flips.items()} }, loss "
              f"{abs(loss - float(loss_ref)) / abs(float(loss_ref)):.2e}, worst weight "
              f"{weights}, worst bias against the fp32 sum: port {port_bias}, JAX "
              f"{jax_bias}; positional embedding {embedding:.2e}", flush=True)


def network(model_type: str) -> None:
    from test_torch_mlp_lstm import SMALL, _inputs, _jax_loss_draws, _models

    for seed, xs, ks in ((0, 3, 5), (1, 4, 6), (2, 7, 8)):
        jmodel, variables, model = _models(model_type, 12, 2, dropout_rate=0.0, seed=seed,
                                           dtype="bfloat16", **SMALL)
        x, _ = _inputs(4, 12, 2, seed=xs)
        jsched = JaxVP(fourier_noise_scaling=True)
        key = jax.random.PRNGKey(ks)
        ref_loss, ref_grads = jax.value_and_grad(lambda p: jax_sde_loss(
            lambda b: jmodel.apply({"params": p, "constants": variables["constants"]},
                                   b.X, b.timesteps, deterministic=False),
            jsched, JaxBatch(X=jnp.asarray(x)), key))(variables["params"])
        t, z = _jax_loss_draws(key, x.shape, jsched)
        trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), device="cpu")
        loss, grads = trainer.loss_and_grads(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z),
            generator=torch.Generator().manual_seed(0))
        ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, ref_grads)},
                                  SMALL["num_layers"])
        worst = max((rel(g, ref[n].numpy()), n) for n, g in zip(trainer.names, grads))
        print(f"{model_type} draw {seed}: loss "
              f"{abs(loss.item() - float(ref_loss)) / abs(float(ref_loss)):.2e}, worst "
              f"gradient {worst}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    parts = {"unfused": unfused, "mlp": lambda: network("mlp"),
             "lstm": lambda: network("lstm")}
    for part in sys.argv[1:] or parts:
        parts[part]()
