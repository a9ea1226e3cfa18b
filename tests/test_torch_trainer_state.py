"""The rest of the port's ``Trainer`` (gradient accumulation, the ``last``
training state and resume, ``perm_salt``, callbacks, the metrics writer),
the seeded initial weights and the sampling callback, on the CPU.

* ``MultiSteps`` against ``optax.MultiSteps(make_optimizer(...))`` of the
  JAX package on the same gradient sequence, with a partial accumulation
  across an epoch boundary and across a save and load of the state: the
  parameters to 1e-6 absolute (fp32 values of order 1, the same
  arithmetic), the counters exactly.
* A fit interrupted after an epoch and resumed from ``last`` equals the
  uninterrupted fit bit for bit: weights, EMA, optimiser state, step and the
  resumed epochs' losses; also with gradient accumulation.
* the seed of the initial weights (``build(seed=)``, which the training
  CLI gives ``trainer.init_seed`` or else ``random_seed``) changes only the
  initial weights, and ``perm_salt`` only the epoch order (the noise,
  dropout seeds and weights elsewhere bit for bit).
* ``last`` is written every ``save_last_every_n`` epochs and at the last;
  callbacks get the EMA weights; rollbacks reach the metrics writer; a fit
  with the ``SamplingCallback`` equals one without it, bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourierdiffusion_tpu.training.optim import make_optimizer as jax_make_optimizer
from fourierdiffusion_tpu_torch.data import DummyDatamodule
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import MultiSteps, Trainer, make_optimizer
from fourierdiffusion_tpu_torch.training import trainer as trainer_module
from fourierdiffusion_tpu_torch.training.callbacks import SamplingCallback

CFG = ScoreModelConfig(d_model=16, num_layers=2, n_head=2, dim_feedforward=32)
L, C, BATCH = 12, 2, 8  # DummyDatamodule: 80 series, 10 steps per epoch


def _datamodule(fourier: bool = False) -> DummyDatamodule:
    dm = DummyDatamodule(batch_size=BATCH, n_channels=C, max_len=L, fourier_transform=fourier,
                         standardize=True, random_seed=3)
    dm.setup()
    return dm


def _trainer(max_epochs: int = 4, model_seed: int = 0, **kwargs) -> Trainer:
    model = CFG.build(n_channels=C, max_len=L, seed=model_seed)
    kwargs.setdefault("ema_decay", 0.999)
    return Trainer(model, VPScheduler(fourier_noise_scaling=False), max_epochs=max_epochs,
                   lr_max=1e-3, seed=42, device="cpu", **kwargs)


def _assert_same_state(a: Trainer, b: Trainer) -> None:
    sa, sb = a.train_state(), b.train_state()
    assert sa["step"] == sb["step"]

    def walk(x, y, where):
        if isinstance(x, dict):
            assert list(x) == list(y), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        else:
            assert x == y, where

    walk(sa, sb, "state")


# -- MultiSteps against optax ----------------------------------------------------------------


def test_multisteps_equals_optax(tmp_path: Path) -> None:
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (5,), (3, 2, 4)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    k, per_epoch, epochs = 3, 7, 3  # 7 % 3: an accumulation spans each epoch boundary
    n_updates = per_epoch * epochs // k
    opt = optax.MultiSteps(jax_make_optimizer(1e-2, n_updates), every_k_schedule=k)
    jp = {str(i): jnp.asarray(a) for i, a in enumerate(p0)}
    jstate = opt.init(jp)
    tp = [torch.tensor(a) for a in p0]
    topt = make_optimizer(tp, 1e-2, n_updates, accumulate_grad_batches=k)
    assert isinstance(topt, MultiSteps)
    for step in range(per_epoch * epochs):
        # Large gradients now and then, so the clip acts on some updates.
        g = [rng.normal(size=s).astype(np.float32) * (4.0 if step % 5 == 0 else 0.2)
             for s in shapes]
        upd, jstate = opt.update({str(i): jnp.asarray(a) for i, a in enumerate(g)}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.tensor(a) for a in g])
        if step == per_epoch + 1:  # mid-accumulation: through a file, as `last` does
            torch.save(topt.state_dict(), tmp_path / "opt.pt")
            topt = make_optimizer(tp, 1e-2, n_updates, accumulate_grad_batches=k)
            topt.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
        for i in range(len(shapes)):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[str(i)]), rtol=0, atol=1e-6)
        assert topt.mini_step == int(jstate.mini_step)
        assert topt.gradient_step == int(jstate.gradient_step)
        assert topt.count == int(jstate.inner_opt_state[1][0].count)


def test_multisteps_rejects_k_below_one() -> None:
    with pytest.raises(ValueError):
        MultiSteps(make_optimizer([torch.zeros(2)], 1e-3, 10), 0)


# -- resume ------------------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _stop_in(epoch_to_stop: int):
    def callback(trainer, epoch, params, constants, metrics):
        if epoch == epoch_to_stop:
            raise _Stop
    return callback


@pytest.mark.parametrize("k", [1, 3], ids=["no-accumulation", "accumulate-3"])
def test_resumed_fit_equals_uninterrupted(tmp_path: Path, k: int) -> None:
    dm = _datamodule()
    full = _trainer(4, accumulate_grad_batches=k, save_last_dir=tmp_path / "full")
    history = full.fit(dm)
    # Stopped in epoch 2, after its training and before its `last`.
    cut = _trainer(4, accumulate_grad_batches=k, save_last_dir=tmp_path / "cut",
                   callbacks=(_stop_in(2),))
    with pytest.raises(_Stop):
        cut.fit(dm)
    resumed = _trainer(4, accumulate_grad_batches=k, save_last_dir=tmp_path / "cut")
    resumed_history = resumed.fit(dm, resume_from=tmp_path / "cut" / "last")
    assert [h["epoch"] for h in resumed_history] == [2, 3]
    for h, r in zip(history[2:], resumed_history):
        assert (h["train/loss"], h["val/loss"], h["step"], h["lr"]) == (
            r["train/loss"], r["val/loss"], r["step"], r["lr"])
    _assert_same_state(full, resumed)
    assert full.num_training_steps == 10 * 4 // k
    assert full.step == 40 and full.optimizer.count == 40 // k
    if k > 1:
        # 40 steps in updates of 3: the last update's accumulation is partial.
        assert full.optimizer.mini_step == 40 % 3


def test_last_state_round_trips_into_a_new_trainer(tmp_path: Path) -> None:
    dm = _datamodule()
    a = _trainer(2, save_last_dir=tmp_path)
    a.fit(dm)
    b = _trainer(2)
    b.start(a.num_training_steps)
    state, next_epoch = trainer_module.restore_train_state(tmp_path / "last")
    b.load_train_state(state)
    assert next_epoch == 2
    _assert_same_state(a, b)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        c = _trainer(2, accumulate_grad_batches=2)
        c.start(10)
        c.load_train_state(state)


@pytest.mark.parametrize("every,epochs,saved", [(1, 3, [0, 1, 2]), (2, 5, [0, 2, 4]),
                                                (3, 5, [0, 3, 4])])
def test_save_last_every_n(tmp_path: Path, monkeypatch, every: int, epochs: int,
                           saved: list[int]) -> None:
    calls = []
    monkeypatch.setattr(trainer_module, "save_train_state",
                        lambda d, state, epoch: calls.append(epoch))
    _trainer(epochs, save_last_dir=tmp_path, save_last_every_n=every).fit(_datamodule())
    assert calls == saved


# -- init_seed and perm_salt ----------------------------------------------------------------


def _recorded_fit(monkeypatch, **kwargs) -> tuple[Trainer, list, dict]:
    """A 2-epoch fit whose steps' inputs (batch, t, z, layer seeds) are kept."""
    steps = []
    trainer = _trainer(2, **kwargs)
    original = trainer.train_step

    def train_step(x, t, z, layer_seeds=None, **kw):
        steps.append((x.clone(), t.clone(), z.clone(), list(layer_seeds)))
        return original(x, t, z, layer_seeds, **kw)

    monkeypatch.setattr(trainer, "train_step", train_step)
    initial = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit(_datamodule())
    return trainer, steps, initial


def test_init_seed_changes_only_the_initial_weights(monkeypatch) -> None:
    _, steps, initial = _recorded_fit(monkeypatch)
    seeded, seeded_steps, seeded_initial = _recorded_fit(monkeypatch, model_seed=7)
    assert len(steps) == len(seeded_steps) == 20
    for a, b in zip(steps, seeded_steps):  # batches, noise and dropout seeds
        assert all(torch.equal(u, v) for u, v in zip(a[:3], b[:3])) and a[3] == b[3]
    want = CFG.build(n_channels=C, max_len=L, seed=7).state_dict()
    assert all(torch.equal(seeded_initial[k], want[k]) for k in want)
    assert not torch.equal(initial["embedder.weight"], want["embedder.weight"])
    # The same seed, the same network: a fit from it repeats bit for bit.
    again, _, _ = _recorded_fit(monkeypatch, model_seed=7)
    _assert_same_state(again, seeded)


def test_init_seed_leaves_the_global_generator_alone() -> None:
    torch.manual_seed(11)
    before = torch.rand(3)
    torch.manual_seed(11)
    CFG.build(n_channels=C, max_len=L, seed=5)
    assert torch.equal(torch.rand(3), before)


def test_perm_salt_changes_only_the_epoch_order(monkeypatch) -> None:
    _, steps, _ = _recorded_fit(monkeypatch)
    _, salted, _ = _recorded_fit(monkeypatch, perm_salt=3)
    assert len(steps) == len(salted) == 20
    for a, b in zip(steps, salted):  # the noise and the dropout seeds
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and a[3] == b[3]
    assert not all(torch.equal(a[0], b[0]) for a, b in zip(steps, salted))
    for epoch in range(2):  # each epoch still covers every series once
        rows = [torch.cat([s[0] for s in run[10 * epoch:10 * epoch + 10]]) for run in
                (steps, salted)]
        assert torch.equal(*(r[torch.argsort(r[:, 0, 0])] for r in rows))


# -- callbacks and the writer ----------------------------------------------------------------


def test_callbacks_receive_the_ema_weights() -> None:
    seen = []

    def callback(trainer, epoch, params, constants, metrics):
        seen.append((epoch, {k: v.clone() for k, v in params.items()},
                     {k: v.clone() for k, v in constants.items()},
                     {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)},
                     {n: e.clone() for n, e in trainer.ema.items()}))

    _trainer(2, callbacks=(callback,)).fit(_datamodule())
    assert [s[0] for s in seen] == [0, 1]
    for _, params, constants, raw, ema in seen:
        assert all(torch.equal(params[k], ema[k]) for k in ema)
        assert any(not torch.equal(params[k], raw[k]) for k in raw)
        assert list(constants) == ["time_encoder.W"]


class _Writer:
    def __init__(self) -> None:
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((dict(metrics), step))


def test_epoch_records_and_rollbacks_reach_the_writer() -> None:
    writer = _Writer()
    # A factor far below 1 makes every epoch after the fifth a "spike".
    trainer = _trainer(7, metrics_writer=writer, spike_rollback_factor=1e-6,
                       spike_rollback_retries=1)
    history = trainer.fit(_datamodule())
    rollbacks = [(r, s) for r, s in writer.records if "rollback_from_epoch" in r]
    assert len(rollbacks) == 1
    record, step = rollbacks[0]
    assert record["rollback_from_epoch"] == 5 and record["rollback_to_epoch"] == 4
    assert step == 40  # the snapshot's step: the start of epoch 4
    epochs = [r for r, _ in writer.records if "epoch" in r]
    # Epoch 5's first run is rolled back before it is recorded; 4 re-runs.
    assert [r["epoch"] for r in epochs] == [0, 1, 2, 3, 4, 4, 5, 6]
    assert [h["epoch"] for h in history] == [0, 1, 2, 3, 4, 5, 6]
    assert history[-1]["stream_salt"] == 1
    assert all(s == r["step"] for r, s in writer.records if "epoch" in r)


@pytest.mark.parametrize("fourier", [False, True], ids=["time", "freq"])
def test_sampling_callback_leaves_the_fit_unchanged(fourier: bool) -> None:
    dm = _datamodule(fourier)
    plain = _trainer(3)
    plain_history = plain.fit(dm)
    writer = _Writer()
    model = CFG.build(n_channels=C, max_len=L, seed=0)
    callback = SamplingCallback(model, VPScheduler(fourier_noise_scaling=False), dm,
                                every_n_epochs=2, sample_batch_size=8, num_samples=12,
                                num_diffusion_steps=4, num_directions=8, random_seed=1,
                                metrics_writer=writer, device="cpu")
    with_cb = Trainer(model, VPScheduler(fourier_noise_scaling=False), max_epochs=3,
                      lr_max=1e-3, seed=42, ema_decay=0.999, device="cpu",
                      callbacks=(callback,))
    history = with_cb.fit(dm)
    _assert_same_state(plain, with_cb)
    for a, b in zip(plain_history, history):
        assert (a["train/loss"], a["val/loss"]) == (b["train/loss"], b["val/loss"])
    # It fired at epochs 0 and 2 (every 2, and the last), with metrics/* keys.
    assert len(writer.records) == 2
    assert {k for k in history[0] if k.startswith("metrics/")} == set(writer.records[0][0])
    assert "metrics/time_sliced_wasserstein_mean" in writer.records[0][0]
    assert not any(k.startswith("metrics/") for k in history[1])
    assert callback.sampler.model is not model
    # Each call draws from a fresh generator of its seed: the same weights
    # give the same samples.
    params = {k: v.clone() for k, v in with_cb.eval_params().items()}
    constants = dict(model.named_buffers())
    assert torch.equal(callback.sample(params, constants), callback.sample(params, constants))
