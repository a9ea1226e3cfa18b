"""Port parity of the training stack (``losses.py``, ``training/optim.py``,
``data/datamodules.py``, ``training/trainer.py``) against the JAX package,
on the CPU.

Random draws differ between ``jax.random`` and ``torch.Generator``, so each
test re-derives the draws JAX makes from its keys (``t``, ``z``, the layer
dropout seeds) and hands them to the port. The JAX trainer runs its fused
training forward (``FDIFF_FUSED_TRAIN=1``), whose Pallas kernels run in
interpret mode; the port runs the plain version of its training layer.

Tolerances: values 1e-5 absolute and relative, gradients 1e-4 of the
largest gradient of each tensor (the same fp32 arithmetic summed in other
orders); the schedule 1e-5 relative or 1e-6 of the peak rate absolute
(optax computes it in fp32, the port in fp64, and near the end of the
decay fp32's cosine is off by up to ~1e-4 relative of a rate 1e-4 of the
peak); the optimiser update 1e-6 relative; the numpy data bit for bit,
after the DFT, and its mean and std, 1e-6 absolute and relative; the
standardised data 1e-6 of the split's largest value, times 1/std per
position (a DFT difference of an ulp or two is divided by stds as small as
0.01 at some frequencies).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_and_port_models
from test_torch_train_layer import assert_grads_close

from fourierdiffusion_tpu.data import datamodules as jax_dm
from fourierdiffusion_tpu.data.batch import DiffusableBatch as JaxBatch
from fourierdiffusion_tpu.losses import sde_loss as jax_sde_loss
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.training import optim as jax_optim
from fourierdiffusion_tpu.training.trainer import Trainer as JaxTrainer
from fourierdiffusion_tpu.training.trainer import TrainStateBundle
from fourierdiffusion_tpu_torch.data import (
    DiffusableBatch,
    DummyDatamodule,
    SyntheticDatamodule,
    make_diffusion_arrays,
)
from fourierdiffusion_tpu_torch.losses import sde_loss
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer, cosine_warmup_schedule
from fourierdiffusion_tpu_torch.training.optim import AdamW, clip_by_global_norm
from fourierdiffusion_tpu_torch.utils.weights import state_dict_from_jax

VALUE = dict(atol=1e-5, rtol=1e-5)
L, C = 19, 2


def _jax_loss_draws(key, x_shape, scheduler):
    """The ``t`` and ``z`` that ``sde_loss`` draws from ``key``."""
    t_key, z_key = jax.random.split(key)
    t = jax.random.uniform(t_key, (x_shape[0],), jnp.float32) * (
        scheduler.T - scheduler.eps
    ) + scheduler.eps
    return np.asarray(t), np.asarray(jax.random.normal(z_key, x_shape, jnp.float32))


# ---- loss ------------------------------------------------------------------------


@pytest.mark.parametrize("likelihood_weighting", [False, True])
@pytest.mark.parametrize("reduce_mean", [True, False])
def test_sde_loss_matches_jax(likelihood_weighting: bool, reduce_mean: bool) -> None:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, L, C)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jsched, sched = JaxVP(fourier_noise_scaling=True), VPScheduler(fourier_noise_scaling=True)
    t, z = _jax_loss_draws(key, x.shape, jsched)
    kw = dict(reduce_mean=reduce_mean, likelihood_weighting=likelihood_weighting)
    ref = jax_sde_loss(
        lambda b: -0.5 * b.X + 0.1 * b.timesteps[:, None, None], jsched,
        JaxBatch(X=jnp.asarray(x), timesteps=jnp.asarray(t)), key, **kw,
    )
    ours = sde_loss(
        lambda b: -0.5 * b.X + 0.1 * b.timesteps[:, None, None], sched,
        DiffusableBatch(X=torch.from_numpy(x), timesteps=torch.from_numpy(t)),
        z=torch.from_numpy(z), **kw,
    )
    np.testing.assert_allclose(ours.item(), float(ref), **VALUE)


def test_sde_loss_draws_from_generator() -> None:
    x = torch.randn(4, L, C)
    sched = VPScheduler()
    a = sde_loss(lambda b: -b.X, sched, DiffusableBatch(X=x),
                 generator=torch.Generator().manual_seed(1))
    b = sde_loss(lambda b: -b.X, sched, DiffusableBatch(X=x),
                 generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a) and a.item() == b.item()


# ---- schedule and optimiser --------------------------------------------------------


@pytest.mark.parametrize("n", [10, 160, 9600])
def test_schedule_matches_optax(n: int) -> None:
    ref = jax_optim.cosine_warmup_schedule(1e-3, n)
    ours = cosine_warmup_schedule(1e-3, n)
    counts = list(range(0, n + 3)) if n < 1000 else list(range(0, n + 3, 7)) + [n - 1, n]
    got = np.array([ours(c) for c in counts])
    want = np.array([float(ref(c)) for c in counts])
    assert got[0] == 0.0  # the first update has rate 0, as in optax
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * 1e-3)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_clip_and_adamw_match_optax(grad_scale: float) -> None:
    rng = np.random.default_rng(1)
    params = {f"p{i}": rng.normal(size=s).astype(np.float32) for i, s in
              enumerate([(5, 3), (7,), (2, 2, 4)])}
    grads = [{k: (rng.normal(size=v.shape) * grad_scale).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = jax_optim.make_optimizer(1e-2, 12, gradient_clip_val=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = [torch.from_numpy(v.copy()) for v in params.values()]
    ours = AdamW(tp, cosine_warmup_schedule(1e-2, 12), gradient_clip_val=1.0)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        ours.step([torch.from_numpy(v) for v in g.values()])
    for (name, ref), got in zip(jp.items(), tp):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_clip_scales_only_above_the_norm() -> None:
    g = [torch.tensor([3.0, 4.0])]
    torch.testing.assert_close(clip_by_global_norm(g, 10.0)[0], g[0], rtol=0, atol=0)
    torch.testing.assert_close(clip_by_global_norm(g, 1.0)[0], torch.tensor([0.6, 0.8]))


# ---- data ----------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["sine", "ar2"])
def test_synthetic_datamodule_matches_jax(tmp_path, family: str) -> None:
    kw = dict(random_seed=42, batch_size=16, fourier_transform=True, standardize=True,
              max_len=L, num_samples=40, family=family)
    ref = jax_dm.SyntheticDatamodule(data_dir=tmp_path / "jax", **kw)
    ours = SyntheticDatamodule(data_dir=tmp_path / "port", **kw)
    for dm in (ref, ours):
        dm.prepare_data()
        dm.setup()
    np.testing.assert_array_equal(ours.X_train.numpy(), np.asarray(ref.X_train))
    np.testing.assert_array_equal(ours.X_test.numpy(), np.asarray(ref.X_test))
    for split in ("train_arrays", "val_arrays"):
        got, want = getattr(ours, split)(), getattr(ref, split)()
        for key in ("X", "feature_mean", "feature_std"):
            np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
        err = np.abs(got.standardized().numpy() - np.asarray(want.standardized()))
        scale = max(1.0, float(np.abs(got.X.numpy()).max()))
        assert float((err * got.feature_std.numpy()).max()) <= 1e-6 * scale
    assert ours.steps_per_epoch == ref.steps_per_epoch == 3
    assert ours.dataset_parameters == ref.dataset_parameters


@pytest.mark.parametrize("fourier_transform", [False, True])
def test_make_diffusion_arrays_matches_jax(fourier_transform: bool) -> None:
    rng = np.random.default_rng(2)
    x, ref_x = (rng.normal(size=(9, 16, 3)).astype(np.float32) for _ in range(2))
    kw = dict(fourier_transform=fourier_transform, standardize=True)
    want = jax_dm.make_diffusion_arrays(jnp.asarray(x), X_ref=jnp.asarray(ref_x), **kw)
    got = make_diffusion_arrays(torch.from_numpy(x), X_ref=torch.from_numpy(ref_x), **kw)
    np.testing.assert_allclose(got.standardized().numpy(), np.asarray(want.standardized()),
                               atol=1e-6, rtol=1e-6)


def test_dummy_datamodule_shapes() -> None:
    dm = DummyDatamodule(batch_size=4, n_channels=2, max_len=L)
    dm.prepare_data()
    dm.setup()
    assert tuple(dm.X_train.shape) == (40, L, 2) and dm.steps_per_epoch == 10
    assert dm.dataset_parameters == {"n_channels": 2, "max_len": L, "steps_per_epoch": 10}


# ---- one trainer step -------------------------------------------------------------------


def test_trainer_steps_match_jax(monkeypatch) -> None:
    """Two steps of the JAX trainer's own epoch program (fused training
    forward, clip + AdamW, EMA) against the port's ``train_step`` with the
    draws JAX made from the same keys. Step 0 has rate 0, so step 1 is the
    first to move the weights."""
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "1")
    batch, n_steps, n_total = 4, 2, 20
    jmodel, variables, model = jax_and_port_models(
        L, C, num_layers=2, dim_feedforward=64, dropout_rate=0.3
    )
    x_all = np.random.default_rng(6).normal(size=(10, L, C)).astype(np.float32)
    perm = np.array([[3, 1, 7, 0], [9, 2, 5, 4]])
    key = jax.random.PRNGKey(11)
    jsched = JaxVP(fourier_noise_scaling=True)
    jtrainer = JaxTrainer(jmodel, jsched, lr_max=1e-3, ema_decay=0.999)
    opt = jax_optim.make_optimizer(1e-3, n_total)
    train_epoch, _ = jtrainer._make_epoch_fns(opt)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    constants = jax.tree_util.tree_map(jnp.asarray, variables["constants"])
    step_keys = jax.random.split(key, n_steps)

    # The JAX draws of each step: loss (t, z) and the per-layer dropout seeds.
    draws = []
    for k in step_keys:
        drop_key, loss_key = jax.random.split(k)
        seeds = [int(jax.random.randint(jax.random.fold_in(drop_key, i), (), 0,
                                        jnp.iinfo(jnp.int32).max)) for i in range(2)]
        draws.append((*_jax_loss_draws(loss_key, (batch, L, C), jsched), seeds))
    loss0, grads0 = jax.value_and_grad(jtrainer._loss)(
        params, constants, JaxBatch(X=jnp.asarray(x_all[perm[0]])), step_keys[0], True
    )

    state = TrainStateBundle(
        params, constants, opt.init(params), jnp.zeros((), jnp.int32),
        jax.tree_util.tree_map(jnp.copy, params),
    )
    state, mean_loss = train_epoch(
        jax.tree_util.tree_map(jnp.copy, state), jnp.asarray(x_all), jnp.asarray(perm), key
    )

    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), lr_max=1e-3,
                      ema_decay=0.999, device="cpu")
    trainer.start(n_total)
    t0, z0, s0 = draws[0]
    x0 = torch.from_numpy(x_all[perm[0]])
    loss, grads = trainer.loss_and_grads(x0, torch.from_numpy(t0), torch.from_numpy(z0), s0)
    np.testing.assert_allclose(loss.item(), float(loss0), **VALUE)
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads0)}, 2)
    for name, g in zip(trainer.names, grads):
        assert_grads_close(g, ref[name].numpy(), name)

    losses = [
        trainer.train_step(torch.from_numpy(x_all[idx]), torch.from_numpy(t),
                           torch.from_numpy(z), seeds).item()
        for idx, (t, z, seeds) in zip(perm, draws)
    ]
    np.testing.assert_allclose(np.mean(losses), float(mean_loss), **VALUE)
    assert trainer.step == int(state.step) == n_steps
    for tree, ours in ((state.params, dict(model.named_parameters())), (state.ema_params, trainer.ema)):
        want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, tree)}, 2)
        for name in trainer.names:
            np.testing.assert_allclose(ours[name].detach().numpy(), want[name].numpy(),
                                       **VALUE, err_msg=name)


# ---- a short fit ------------------------------------------------------------------------


def _tiny(dropout_rate: float = 0.1):
    _, _, model = jax_and_port_models(16, 2, num_layers=1, dim_feedforward=32,
                                      dropout_rate=dropout_rate)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=16, standardize=True)
    dm.prepare_data()
    dm.setup()
    return model, dm


def test_fit_trains_on_cpu() -> None:
    model, dm = _tiny()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, VPScheduler(), max_epochs=2, ema_decay=0.999, device="cpu")
    history = trainer.fit(dm)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(math.isfinite(h["train/loss"]) and math.isfinite(h["val/loss"]) for h in history)
    assert trainer.step == 2 * dm.steps_per_epoch
    for n, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


def test_validation_draws_are_fixed_across_epochs() -> None:
    model, dm = _tiny()
    history = Trainer(model, VPScheduler(), max_epochs=3, lr_max=0.0, device="cpu").fit(dm)
    vals = [h["val/loss"] for h in history]
    assert vals[0] == vals[1] == vals[2]
    assert len({h["train/loss"] for h in history}) == 3  # train draws change per epoch


def test_validation_batches_wrap_around() -> None:
    np.testing.assert_array_equal(
        Trainer.val_batches(5, 4).numpy(), [[0, 1, 2, 3], [4, 0, 1, 2]]
    )
    perm = Trainer.epoch_permutation(5, 4, torch.Generator().manual_seed(0))
    assert perm.shape == (2, 4) and set(perm.flatten().tolist()) == set(range(5))


class _SpikyTrainer(Trainer):
    """Multiplies the train loss of epoch ``spike_epoch`` by 100 the first
    time that epoch runs."""

    spike_epoch = 6

    def fit(self, datamodule):
        self._calls, self._spiked = 0, False
        self._steps = datamodule.steps_per_epoch
        return super().fit(datamodule)

    def train_step(self, x, t, z, layer_seeds):
        loss = super().train_step(x, t, z, layer_seeds)
        epoch = self._calls // self._steps
        self._calls += 1
        if epoch == self.spike_epoch and not self._spiked:
            if self._calls % self._steps == 0:
                self._spiked = True
            return loss * 100.0
        return loss


def test_spike_rollback_guard_rewinds_and_perturbs_the_stream() -> None:
    model, dm = _tiny(dropout_rate=0.0)
    trainer = _SpikyTrainer(model, VPScheduler(), max_epochs=8, device="cpu")
    history = trainer.fit(dm)
    assert [h["epoch"] for h in history] == list(range(8))
    # The spike at epoch 6 rewound to the older snapshot, epoch 5, which
    # re-ran under salt 1 like every later epoch.
    assert [h.get("stream_salt", 0) for h in history] == [0] * 5 + [1] * 3
    assert max(h["train/loss"] for h in history) < 100 * min(h["train/loss"] for h in history)
    assert trainer.step == 8 * dm.steps_per_epoch


def test_no_rollback_without_spikes() -> None:
    model, dm = _tiny()
    history = Trainer(model, VPScheduler(), max_epochs=6, device="cpu").fit(dm)
    assert all("stream_salt" not in h for h in history)
