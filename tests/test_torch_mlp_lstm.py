"""Port parity of the MLP and LSTM score networks (``models/blocks.py``'s
``MLPBlock``, ``models/lstm.py``, ``ScoreMLP``, ``ScoreLSTM``) against the
JAX package, on the CPU, and their path through the trainer, the sampler
and the two entry points.

* Forward: the same weights (``state_dict_from_jax``) and inputs give the
  same score to 1e-5 of its largest magnitude, at a small size (d_model 16,
  2 layers, L=12, C=2) and at the full width (d_model 72, 10 layers, d_mlp
  1024, L=100, batch 2); the reference's trained LSTM weights
  (``runs_reference/ref-lstm-*/model.pt``) loaded into both likewise.
* One training step at dropout 0 with JAX's ``t`` and ``z``: the loss to
  1e-5 relative, each gradient to 1e-5 of its tensor's largest entry.
* The same step in bf16 (``dtype`` bfloat16, fp32 parameters, as JAX's
  ``score_model.dtype: bfloat16`` trains): the loss to 1e-3 relative, each
  gradient to BF16_GRAD_REL of its tensor's largest entry (the MLP 2**-6,
  the LSTM 2**-5), and parameters and gradients fp32. The two libraries
  round bf16 at other points: JAX's linear layers round ``x W`` to bf16
  before adding the bias in bf16, PyTorch adds it to the fp32 sum; JAX's
  gradient of a broadcast bias sums its bf16 cotangents in bf16 (up to
  1.1e-2 of the largest on 80 random rows); the MLP's ReLU gates near 0
  may take the other sign; and the LSTM's recurrence rounds every gate
  operation, h and c to bf16 at each of the L steps in JAX (its
  ``lax.scan``) and at the points of ``torch.lstm`` in the port (on the
  card cuDNN, which keeps its cell state in fp32), so its roundings
  compound over the steps. Over three draws
  (``scripts/bf16_parity_probe.py mlp lstm``) the MLP read 7.6e-3 to
  1.3e-2 and the LSTM 8.1e-3 to 2.4e-2 (the embedder's bias), the losses
  8.3e-5 to 7.1e-4.
* The MLP's dropout at 0.1 draws from the generator: the same generator
  seed gives the same output, another seed another.
* A 20-step ``em`` run of ``ScoreLSTM`` on JAX's noise: to 1e-5 of the
  largest sample.
* ``Trainer.fit`` of each with EMA, gradient accumulation and validation,
  interrupted and resumed from ``last``: equal to the uninterrupted fit
  bit for bit.
* ``fdiff-torch-train device=cpu`` one epoch of ``score_model=mlp
  datamodule=nasdaq`` and ``score_model=lstm datamodule=ecg`` on files the
  test writes, ``metrics.jsonl``'s keys those of the JAX CLI's run on the
  same files; then ``fdiff-torch-sample`` on the LSTM run; and the JAX
  run converted by ``scripts/convert_jax_run.py``: its best checkpoint
  gives the JAX forward's scores (1e-5 of the largest) and its ``last``
  loads into the port's ``Trainer``.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trainer_state import _assert_same_state, _Stop, _stop_in

from fourierdiffusion_tpu.cli import train as jax_cli_train
from fourierdiffusion_tpu.data.batch import DiffusableBatch as JaxBatch
from fourierdiffusion_tpu.losses import sde_loss as jax_sde_loss
from fourierdiffusion_tpu.models import ScoreModelConfig as JaxConfig
from fourierdiffusion_tpu.sampling.sampler import make_sample_fn as jax_make_sample_fn
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.utils.config import load_config as jax_load_config
from fourierdiffusion_tpu.utils.instantiate import build_model_config as jax_build_model_config
from fourierdiffusion_tpu.utils.torch_import import _IMPORTERS, load_torch_state_dict
from fourierdiffusion_tpu_torch.cli import sample as cli_sample
from fourierdiffusion_tpu_torch.cli import train as cli_train
from fourierdiffusion_tpu_torch.data import DummyDatamodule
from fourierdiffusion_tpu_torch.data.raw_formats import write_mitbih, write_nasdaq
from fourierdiffusion_tpu_torch.models import ScoreLSTM, ScoreMLP, ScoreModelConfig
from fourierdiffusion_tpu_torch.sampling import reverse_diffusion
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.utils.checkpoint import (
    get_best_checkpoint,
    load_checkpoint,
    restore_train_state,
)
from fourierdiffusion_tpu_torch.utils.config import load_config
from fourierdiffusion_tpu_torch.utils.instantiate import build_model_config
from fourierdiffusion_tpu_torch.utils.weights import (
    load_reference_state_dict,
    state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The LSTM's many small per-step operations slow down by an order of
    magnitude when the test workers' thread pools share the cores; one
    intra-op thread per test avoids that."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SMALL = dict(d_model=16, num_layers=2, d_mlp=32)
FULL = dict(d_model=72, num_layers=10, d_mlp=1024)


def _models(model_type: str, max_len: int, n_channels: int, dropout_rate: float = 0.1,
            seed: int = 0, dtype: str = "float32", **arch):
    """A JAX network with initialised variables (numpy) and the port's
    network holding the same weights, both computing in ``dtype``."""
    jmodel = JaxConfig(model_type=model_type, dropout_rate=dropout_rate, dtype=dtype,
                       **arch).build(n_channels=n_channels, max_len=max_len)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, max_len, n_channels)), jnp.zeros((1,))))
    model = ScoreModelConfig(model_type=model_type, dropout_rate=dropout_rate, dtype=dtype,
                             **arch).build(n_channels, max_len)
    model.load_state_dict(state_dict_from_jax(variables, arch["num_layers"]), strict=True)
    return jmodel, variables, model.eval()


def _inputs(batch: int, max_len: int, n_channels: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, max_len, n_channels)).astype(np.float32),
            rng.uniform(1e-5, 1.0, size=(batch,)).astype(np.float32))


def _assert_close(ours: np.ndarray, ref: np.ndarray, rel: float = REL) -> None:
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(ours - ref).max()) <= rel * scale, float(np.abs(ours - ref).max()) / scale


@pytest.mark.parametrize("size,max_len,n_channels,batch", [
    ("small", 12, 2, 3), ("full", 100, 1, 2)])
@pytest.mark.parametrize("model_type", ["mlp", "lstm"])
def test_forward_matches_jax(model_type, size, max_len, n_channels, batch) -> None:
    arch = SMALL if size == "small" else FULL
    jmodel, variables, model = _models(model_type, max_len, n_channels, **arch)
    assert isinstance(model, ScoreMLP if model_type == "mlp" else ScoreLSTM)
    x, t = _inputs(batch, max_len, n_channels)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.shape == (batch, max_len, n_channels)
    _assert_close(ours, ref)


@pytest.mark.parametrize("run,fourier", [("ref-lstm-freq42-e60", True),
                                         ("ref-lstm-time42-e60", False)])
def test_reference_lstm_weights_match_jax(run: str, fourier: bool) -> None:
    path = REPO / "runs_reference" / run / "model.pt"
    variables = _IMPORTERS["lstm"](load_torch_state_dict(path), 10)
    jmodel = JaxConfig(model_type="lstm").build(n_channels=1, max_len=100)
    model = load_reference_state_dict(
        ScoreModelConfig(model_type="lstm").build(1, 100), path).eval()
    x, t = _inputs(4, 100, 1, seed=2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    _assert_close(ours, ref)
    assert float(np.abs(ref).max()) > 0.1


def _jax_loss_draws(key, shape, scheduler):
    t_key, z_key = jax.random.split(key)
    t = jax.random.uniform(t_key, (shape[0],), jnp.float32) * (
        scheduler.T - scheduler.eps) + scheduler.eps
    return np.asarray(t), np.asarray(jax.random.normal(z_key, shape, jnp.float32))


@pytest.mark.parametrize("model_type", ["mlp", "lstm"])
def test_training_step_matches_jax(model_type: str) -> None:
    max_len, n_channels = 12, 2
    jmodel, variables, model = _models(model_type, max_len, n_channels, dropout_rate=0.0,
                                       **SMALL)
    x, _ = _inputs(4, max_len, n_channels, seed=3)
    jsched, sched = JaxVP(fourier_noise_scaling=True), VPScheduler(fourier_noise_scaling=True)
    key = jax.random.PRNGKey(5)

    def loss_fn(params):
        return jax_sde_loss(
            lambda b: jmodel.apply({"params": params, "constants": variables["constants"]},
                                   b.X, b.timesteps, deterministic=False),
            jsched, JaxBatch(X=jnp.asarray(x)), key)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(variables["params"])
    t, z = _jax_loss_draws(key, x.shape, jsched)
    trainer = Trainer(model, sched, device="cpu")
    assert not trainer.fused()
    loss, grads = trainer.loss_and_grads(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z),
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=REL)
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, ref_grads)},
                              SMALL["num_layers"])
    assert set(ref) == set(trainer.names)
    for name, grad in zip(trainer.names, grads):
        _assert_close(grad.numpy(), ref[name].numpy())


BF16_LOSS_REL = 1e-3
BF16_GRAD_REL = {"mlp": 2.0**-6, "lstm": 2.0**-5}


@pytest.mark.parametrize("model_type", ["mlp", "lstm"])
def test_bf16_training_step_matches_jax(model_type: str) -> None:
    """``test_training_step_matches_jax`` with both networks computing in
    bf16 (fp32 parameters): the loss and every gradient against JAX's, the
    parameters and gradients fp32."""
    max_len, n_channels = 12, 2
    jmodel, variables, model = _models(model_type, max_len, n_channels, dropout_rate=0.0,
                                       dtype="bfloat16", **SMALL)
    x, _ = _inputs(4, max_len, n_channels, seed=3)
    jsched, sched = JaxVP(fourier_noise_scaling=True), VPScheduler(fourier_noise_scaling=True)
    key = jax.random.PRNGKey(5)

    def loss_fn(params):
        return jax_sde_loss(
            lambda b: jmodel.apply({"params": params, "constants": variables["constants"]},
                                   b.X, b.timesteps, deterministic=False),
            jsched, JaxBatch(X=jnp.asarray(x)), key)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(variables["params"])
    t, z = _jax_loss_draws(key, x.shape, jsched)
    trainer = Trainer(model, sched, device="cpu")
    trainer.start(4)
    loss, grads = trainer.loss_and_grads(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z),
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=BF16_LOSS_REL)
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, ref_grads)},
                              SMALL["num_layers"])
    assert set(ref) == set(trainer.names)
    for name, grad in zip(trainer.names, grads):
        assert grad.dtype == torch.float32, name
        _assert_close(grad.numpy(), ref[name].numpy(), BF16_GRAD_REL[model_type])
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_mlp_dropout_draws_from_the_generator() -> None:
    model = ScoreModelConfig(model_type="mlp", **SMALL).build(2, 12, seed=0).train()
    x, t = (torch.from_numpy(a) for a in _inputs(3, 12, 2))
    out = [model(x, t, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    with torch.no_grad():
        assert torch.equal(model.eval()(x, t, torch.Generator().manual_seed(7)),
                           model(x, t, torch.Generator().manual_seed(8)))


def test_lstm_em_run_matches_jax() -> None:
    max_len, n_channels, batch, steps = 12, 2, 3, 20
    jmodel, variables, model = _models("lstm", max_len, n_channels, **SMALL)
    key = jax.random.PRNGKey(11)
    shape = (batch, max_len, n_channels)
    ref = jax_make_sample_fn(
        jmodel, JaxVP(fourier_noise_scaling=True), num_diffusion_steps=steps,
        batch_size=batch, max_len=max_len, n_channels=n_channels, fused=False, method="em",
    )(variables, key)
    prior_key, scan_key = jax.random.split(key)
    z0 = torch.from_numpy(np.array(jax.random.normal(prior_key, shape, jnp.float32)))
    zs = torch.from_numpy(np.array(jnp.stack(
        [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(scan_key, steps)])))
    sched = VPScheduler(fourier_noise_scaling=True)
    with torch.no_grad():
        ours = reverse_diffusion(model, sched, sched.prior_sampling(shape, z=z0),
                                 num_diffusion_steps=steps, method="em", z=zs)
    _assert_close(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("model_type", ["mlp", "lstm"])
def test_resumed_fit_equals_uninterrupted(tmp_path, model_type: str) -> None:
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=12, standardize=True,
                         random_seed=3)
    dm.setup()

    def trainer(where: str, *callbacks) -> Trainer:
        model = ScoreModelConfig(model_type=model_type, **SMALL).build(2, 12, seed=0)
        return Trainer(model, VPScheduler(), max_epochs=3, ema_decay=0.999,
                       accumulate_grad_batches=2, save_last_dir=tmp_path / where,
                       callbacks=callbacks, device="cpu")

    full = trainer("full")
    history = full.fit(dm)
    with pytest.raises(_Stop):
        trainer("cut", _stop_in(1)).fit(dm)
    resumed = trainer("cut")
    resumed_history = resumed.fit(dm, resume_from=tmp_path / "cut" / "last")
    assert [h["epoch"] for h in resumed_history] == [1, 2]
    assert [(h["train/loss"], h["val/loss"]) for h in history[1:]] == [
        (h["train/loss"], h["val/loss"]) for h in resumed_history]
    assert all(np.isfinite(h["val/loss"]) for h in history)
    _assert_same_state(full, resumed)


# ---- the entry points --------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _keep_logging():
    handlers, level = logging.root.handlers[:], logging.root.level
    yield
    logging.root.handlers[:] = handlers
    logging.root.setLevel(level)


CLI_SMALL = ["score_model.d_model=16", "score_model.num_layers=2", "score_model.d_mlp=32",
             "trainer.max_epochs=1", "trainer.callbacks.sampling.num_samples=8",
             "trainer.callbacks.sampling.num_diffusion_steps=3",
             "trainer.callbacks.sampling.num_directions=8", "datamodule.batch_size=16",
             "fourier_transform=true"]
CLI_RUNS = {"mlp-nasdaq": ["score_model=mlp", "datamodule=nasdaq"],
            "lstm-ecg": ["score_model=lstm", "datamodule=ecg"]}


def _check_converted(jax_run: Path, out_root: Path) -> None:
    """``scripts/convert_jax_run.py`` on a JAX MLP or LSTM run."""
    spec = importlib.util.spec_from_file_location(
        "convert_jax_run", REPO / "scripts" / "convert_jax_run.py")
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    out = conv.convert_run(jax_run, out_root)
    cfg = load_config(out / "train_config.yaml")
    best = get_best_checkpoint(out / "checkpoints")
    variables = conv.restore_on_cpu(jax_run / "checkpoints" / best.name)
    max_len, n_channels = {"nasdaq": (252, 5), "ecg": (187, 1)}[cfg["datamodule"]["name"]]
    jax_model = jax_build_model_config(jax_load_config(jax_run / "train_config.yaml")["score_model"])
    model = build_model_config(cfg["score_model"]).build(n_channels, max_len)
    model.load_state_dict(load_checkpoint(best))
    x, t = _inputs(3, max_len, n_channels, seed=4)
    want = np.asarray(jax_model.build(n_channels=n_channels, max_len=max_len).apply(
        {"params": variables["params"], "constants": variables["constants"]},
        jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        _assert_close(model.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy(), want)
    trainer = Trainer(model, VPScheduler(), device="cpu")
    trainer.start(10)
    state, _ = restore_train_state(out / "checkpoints" / "last")
    trainer.load_train_state(state)
    assert trainer.step == state["step"] > 0


def _records(run: Path) -> list[dict]:
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_cli_trains_and_samples_on_dataset_files(tmp_path, capsys, name: str) -> None:
    rng = np.random.default_rng(0)
    write_nasdaq(tmp_path / "data", rng, 20)
    write_mitbih(tmp_path / "data", rng, 40, 24)
    runs = {}
    for package, main in (("port", cli_train.main), ("jax", jax_cli_train.main)):
        argv = CLI_RUNS[name] + CLI_SMALL + [
            f"run_dir={tmp_path / package / 'runs'}",
            f"datamodule.data_dir={tmp_path / package / 'data'}"]
        if package == "port":
            argv.append("device=cpu")
        shutil.copytree(tmp_path / "data", tmp_path / package / "data")
        main(argv)
        run_id = capsys.readouterr().out.strip().splitlines()[-1].removeprefix("run_id=")
        runs[package] = tmp_path / package / "runs" / run_id
    ours, ref = _records(runs["port"]), _records(runs["jax"])
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"])
               for r in ours if "epoch" in r)
    _check_converted(runs["jax"], tmp_path / "converted")
    if name != "lstm-ecg":
        return
    cli_sample.main([f"model_path={runs['port'].parent}", f"model_id={runs['port'].name}",
                     "device=cpu", "num_samples=8", "num_diffusion_steps=3",
                     "sampler.sample_batch_size=8", "metrics.num_directions=8"])
    samples = np.load(runs["port"] / "samples.npy")
    assert samples.shape == (8, 187, 1) and np.isfinite(samples).all()
    assert (runs["port"] / "results.yaml").exists()
