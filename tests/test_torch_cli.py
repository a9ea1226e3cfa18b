"""The port's entry points, ``fdiff-torch-train`` and ``fdiff-torch-sample``
(``cli/train.py``, ``cli/sample.py``), end to end on the CPU (``device=cpu``)
at a small size (d_model 16, 1 layer, 2 heads, L=20).

* train then sample on ``dummy`` and ``synthetic``, in time and frequency:
  the run directory's artifacts, ``metrics.jsonl``'s records with the JAX
  package's keys, and ``results.yaml``'s key set equal to that of a
  committed ``results.yaml`` of the JAX sampling CLI;
* ``resume=<id>`` after an interruption gives the uninterrupted run's
  ``last`` bit for bit;
* the initial weights come from ``trainer.init_seed``, or else
  ``random_seed``, and the trainer's draws from ``random_seed`` alone;
* ``datamodule=ecg`` (on MIT-BIH files the test writes) and
  ``score_model=mlp``/``lstm`` train;
* ``checkpoint=last``, the noise-scaling assert, and a clear error for a
  CUDA device where there is none.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from fourierdiffusion_tpu_torch.cli import sample as cli_sample
from fourierdiffusion_tpu_torch.cli import train as cli_train
from fourierdiffusion_tpu_torch.data.raw_formats import write_mitbih
from fourierdiffusion_tpu_torch.utils import yamlio
from fourierdiffusion_tpu_torch.utils.config import compose
from fourierdiffusion_tpu_torch.utils.instantiate import build_model_config

REPO = Path(__file__).resolve().parents[1]
# A JAX sampling CLI result with the census (tagged with FDIFF_CENSUS_ARM),
# guard off, best checkpoint.
JAX_RESULTS = REPO / "runs" / "1aa28df3_10k_off" / "results.yaml"
JAX_EPOCH_KEYS = {"_time", "_step", "train/loss", "val/loss", "lr", "epoch", "step",
                  "steps_per_sec"}
SMALL = ["device=cpu", "score_model.d_model=16", "score_model.num_layers=1",
         "score_model.n_head=2", "score_model.dim_feedforward=32", "trainer.max_epochs=2",
         "trainer.ema_decay=0.999", "trainer.callbacks.sampling.every_n_epochs=1",
         "trainer.callbacks.sampling.num_samples=8",
         "trainer.callbacks.sampling.num_diffusion_steps=3",
         "trainer.callbacks.sampling.num_directions=8"]
DATA = {"dummy": ["datamodule=dummy", "datamodule.max_len=20", "datamodule.batch_size=16"],
        "synthetic": ["datamodule=synthetic", "datamodule.max_len=20",
                      "datamodule.num_samples=96", "datamodule.batch_size=32"]}


@pytest.fixture(autouse=True)
def _keep_logging():
    """The CLIs configure the root logger; put it back after each test."""
    handlers, level = logging.root.handlers[:], logging.root.level
    yield
    logging.root.handlers[:] = handlers
    logging.root.setLevel(level)


def _overrides(tmp: Path, data: str, fourier: bool) -> list[str]:
    return SMALL + DATA[data] + [f"run_dir={tmp / 'runs'}", f"datamodule.data_dir={tmp / 'data'}",
                                 f"fourier_transform={str(fourier).lower()}"]


def _train(capsys, argv: list[str]) -> str:
    cli_train.main(argv)
    out = capsys.readouterr().out
    return out.strip().splitlines()[-1].removeprefix("run_id=")


@pytest.mark.parametrize("fourier", [False, True], ids=["time", "freq"])
@pytest.mark.parametrize("data", ["dummy", "synthetic"])
def test_train_then_sample(tmp_path: Path, capsys, monkeypatch, data: str,
                           fourier: bool) -> None:
    monkeypatch.setenv("FDIFF_CENSUS_ARM", "port")
    overrides = _overrides(tmp_path, data, fourier)
    run_id = _train(capsys, overrides)
    run = tmp_path / "runs" / run_id
    assert yamlio.load(run / "train_config.yaml") == compose("train", overrides)
    assert yaml.safe_load((run / "train_config.yaml").read_text()) == compose("train", overrides)
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(JAX_EPOCH_KEYS <= set(r) for r in epochs)
    assert sum(any(k.startswith("metrics/") for k in r) for r in records) == 2
    best = [p.name for p in (run / "checkpoints").glob("epoch=*")]
    assert len(best) == 1
    assert sorted(p.name for p in (run / "checkpoints" / best[0]).iterdir()) == [
        "metadata.json", "model.pt"]
    assert sorted(p.name for p in (run / "checkpoints" / "last").iterdir()) == [
        "metadata.json", "train_state.pt"]

    cli_sample.main(["device=cpu", f"model_path={tmp_path / 'runs'}", f"model_id={run_id}",
                     "num_samples=12", "num_diffusion_steps=3", "sampler.sample_batch_size=8",
                     "metrics.num_directions=16"])
    assert (run / "sample_config.yaml").exists()
    samples = np.load(run / "samples.npy")
    channels = 3 if data == "dummy" else 1
    assert samples.shape == (12, 20, channels) and np.isfinite(samples).all()
    results = yaml.safe_load((run / "results.yaml").read_text())
    assert yamlio.load(run / "results.yaml") == results
    jax_results = yaml.safe_load(JAX_RESULTS.read_text())
    assert set(results) == set(jax_results)
    protocol = results["divergence_census_protocol"]
    assert set(protocol) == set(jax_results["divergence_census_protocol"])
    assert protocol["checkpoint"] == "best" and protocol["num_samples"] == 12
    assert protocol["arm"] == "port"
    assert len(results["time_sliced_wasserstein_all"]) == 16


def test_sample_last_checkpoint_and_guard(tmp_path: Path, capsys) -> None:
    run_id = _train(capsys, _overrides(tmp_path, "dummy", False))
    cli_sample.main(["device=cpu", f"model_path={tmp_path / 'runs'}", f"model_id={run_id}",
                     "num_samples=8", "num_diffusion_steps=3", "sampler.sample_batch_size=8",
                     "checkpoint=last", "sampler.divergence_threshold=8.0",
                     "metrics.include_baselines=false", "metrics.num_directions=8"])
    results = yaml.safe_load((tmp_path / "runs" / run_id / "results.yaml").read_text())
    assert results["divergence_census_protocol"]["checkpoint"] == "last"
    assert results["divergence_census_guard_active"] is True
    assert {"divergence_guard_resampled_chains", "divergence_guard_unresolved_chains",
            "divergence_guard_redraws"} <= set(results)
    assert not any(k.endswith("_self") for k in results)


def test_resume_equals_uninterrupted(tmp_path: Path, capsys) -> None:
    overrides = _overrides(tmp_path, "synthetic", True) + ["trainer.max_epochs=3"]
    full = _train(capsys, overrides)

    class Stop(Exception):
        pass

    def stop(trainer, epoch, params, constants, metrics):
        if epoch == 2:
            raise Stop

    runner = cli_train.TrainingRunner(compose("train", overrides))
    runner.trainer.callbacks = (stop,) + runner.trainer.callbacks
    with pytest.raises(Stop):
        runner.train()
    assert _train(capsys, [f"resume={runner.run_id}", f"run_dir={tmp_path / 'runs'}"]) == (
        runner.run_id)
    a, b = (torch.load(tmp_path / "runs" / rid / "checkpoints" / "last" / "train_state.pt",
                       weights_only=True) for rid in (full, runner.run_id))
    assert a["step"] == b["step"]
    for key in ("params", "ema_params"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])
    for key in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][key][n], b["opt_state"][key][n])
                   for n in a["opt_state"][key])


@pytest.mark.parametrize("init_seed", [None, 7], ids=["random_seed", "init_seed"])
def test_init_seed_draws_only_the_initial_weights(tmp_path: Path, init_seed) -> None:
    overrides = _overrides(tmp_path, "dummy", False) + ["random_seed=5"]
    if init_seed is not None:
        overrides.append(f"trainer.init_seed={init_seed}")
    runner = cli_train.TrainingRunner(compose("train", overrides))
    params = runner.datamodule.dataset_parameters
    want = build_model_config(runner.cfg["score_model"]).build(
        n_channels=params["n_channels"], max_len=params["max_len"],
        seed=5 if init_seed is None else init_seed).state_dict()
    got = runner.model.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert runner.trainer.seed == 5


def test_noise_scaling_needs_the_fourier_transform(tmp_path: Path) -> None:
    overrides = _overrides(tmp_path, "dummy", False) + ["score_model.fourier_noise_scaling=true"]
    with pytest.raises(AssertionError, match="noise scaling without the Fourier transform"):
        cli_train.main(overrides)


@pytest.fixture
def one_thread():
    """One intra-op thread: the LSTM's many small per-step operations slow
    down by an order of magnitude when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("override", ["datamodule=ecg", "score_model=mlp", "score_model=lstm"])
def test_dataset_and_network_options_train(tmp_path: Path, capsys, one_thread,
                                           override: str) -> None:
    """Options the CLI once refused: ECG (on MIT-BIH files written here) and
    the MLP and LSTM score networks each train through ``fdiff-torch-train``."""
    data = "dummy"
    if override == "datamodule=ecg":
        write_mitbih(tmp_path / "data", np.random.default_rng(0), 40, 24)
        data = "ecg"
    argv = [o for o in _overrides(tmp_path, "dummy", False) if not o.startswith("datamodule")]
    argv += DATA.get(data, ["datamodule=ecg", "datamodule.batch_size=16"])
    argv += [f"datamodule.data_dir={tmp_path / 'data'}", override, "score_model.d_mlp=32"]
    run_id = _train(capsys, argv)
    run = tmp_path / "runs" / run_id
    group, option = override.split("=")
    saved = yamlio.load(run / "train_config.yaml")[group]
    assert saved["name" if group == "datamodule" else "model_type"] == option
    epochs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in epochs if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in epochs)


def test_default_device_raises_without_cuda(tmp_path: Path) -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    overrides = [o for o in _overrides(tmp_path, "dummy", False) if o != "device=cpu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(overrides)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_sample.main([f"model_path={tmp_path}", "model_id=x"])


def test_sample_needs_a_model_id() -> None:
    with pytest.raises(SystemExit):
        cli_sample.main(["device=cpu"])
