"""The port's two entry points on two ranks (gloo on the CPU, ``device=cpu``;
the ``FDIFF_*`` variables set by ``parallel/launch.py::run_ranks``), at a
small size (d_model 16, 1 layer, 2 heads; batch 8, L=16, 2 channels):

* ``fdiff-torch-train`` on two ranks writes one run directory under the
  id every rank derives (``FDIFF_RUN_ID``): its config, one
  ``metrics.jsonl`` record per epoch and callback (not one per rank), one
  best checkpoint and ``last``; its losses are the one-process run's;
* ``resume=<id>`` on two ranks reads ``last`` on each and continues;
* ``fdiff-torch-sample`` on two ranks writes ``results.yaml`` and
  ``samples.npy`` once, equal to the one-process run's on the same run.

Tolerances: losses 1e-6 relative, as ``test_torch_parallel.py`` says why;
the samples 1e-6 of their largest |x| and the scores of ``results.yaml``
1e-5 relative (the samples part by an ulp where the CPU's products over 4
chains round otherwise than over 8; a W2 mean sums over the samples), the
census and every other entry exactly.
"""

from __future__ import annotations

import json
import logging
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from test_torch_cli import SMALL

from fourierdiffusion_tpu_torch.cli import sample as cli_sample
from fourierdiffusion_tpu_torch.cli import train as cli_train
from fourierdiffusion_tpu_torch.parallel.launch import run_ranks
from fourierdiffusion_tpu_torch.utils.config import load_config, save_config

DATA = ["datamodule=dummy", "datamodule.max_len=16", "datamodule.batch_size=8",
        "datamodule.n_channels=2"]
SAMPLE = ["device=cpu", "num_samples=12", "num_diffusion_steps=3", "sampler.sample_batch_size=8",
          "metrics.num_directions=16"]
RUN_ID = "dp2"
TIMEOUT = 240
LOSS_RTOL, SAMPLE_TOL, SCORE_RTOL = 1e-6, 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _keep_logging_and_threads():
    """The CLIs configure the root logger; put it back after each test."""
    handlers, level = logging.root.handlers[:], logging.root.level
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    logging.root.handlers[:] = handlers
    logging.root.setLevel(level)


def _two_ranks(module: str, argv: list[str]) -> list[str]:
    return run_ranks([sys.executable, "-m", f"fourierdiffusion_tpu_torch.cli.{module}", *argv],
                     2, timeout=TIMEOUT, env={"FDIFF_RUN_ID": RUN_ID, "OMP_NUM_THREADS": "2"})


def _records(run: Path) -> list[dict]:
    return [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]


def _files(run: Path) -> list[str]:
    return sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())


def _train_both(tmp_path: Path, capsys, extra: list[str] = ()) -> tuple[Path, Path]:
    overrides = SMALL + DATA + [f"datamodule.data_dir={tmp_path / 'data'}", *extra]
    outputs = _two_ranks("train", overrides + [f"run_dir={tmp_path / 'dp'}"])
    assert all(o.strip().splitlines()[-1] == f"run_id={RUN_ID}" for o in outputs)
    cli_train.main(overrides + [f"run_dir={tmp_path / 'one'}"])
    one_id = capsys.readouterr().out.strip().splitlines()[-1].removeprefix("run_id=")
    return tmp_path / "dp" / RUN_ID, tmp_path / "one" / one_id


def _assert_same_losses(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("train/loss", "val/loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)


def test_train_on_two_ranks_writes_one_run(tmp_path: Path, capsys) -> None:
    run, one = _train_both(tmp_path, capsys)
    assert [p.name for p in (tmp_path / "dp").iterdir()] == [RUN_ID]
    assert _files(run) == _files(one)
    best = [p.name for p in (run / "checkpoints").glob("epoch=*")]
    assert len(best) == 1 and (run / "checkpoints" / "last" / "train_state.pt").exists()
    config, one_config = (yaml.safe_load((r / "train_config.yaml").read_text())
                          for r in (run, one))
    assert {**config, "run_dir": None} == {**one_config, "run_dir": None}
    records, one_records = _records(run), _records(one)
    assert [sorted(r) for r in records] == [sorted(r) for r in one_records]
    assert sum("epoch" in r for r in records) == 2
    _assert_same_losses([r for r in records if "epoch" in r],
                        [r for r in one_records if "epoch" in r])


def test_resume_on_two_ranks_continues_from_last(tmp_path: Path, capsys) -> None:
    """Both runs are given a third epoch in their saved config (which
    ``resume=`` reloads as it is) and resumed: each rank reads ``last``, and
    the two-rank run's third epoch is the one-process run's."""
    run, one = _train_both(tmp_path, capsys)
    for r in (run, one):
        cfg = load_config(r / "train_config.yaml")
        cfg["trainer"]["max_epochs"] = 3
        save_config(cfg, r / "train_config.yaml")
    _two_ranks("train", [f"resume={RUN_ID}", f"run_dir={tmp_path / 'dp'}"])
    cli_train.main([f"resume={one.name}", f"run_dir={tmp_path / 'one'}"])
    capsys.readouterr()
    epochs = [r for r in _records(run) if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1, 2]
    _assert_same_losses(epochs, [r for r in _records(one) if "epoch" in r])
    state = torch.load(run / "checkpoints" / "last" / "train_state.pt")
    one_state = torch.load(one / "checkpoints" / "last" / "train_state.pt")
    assert state["step"] == one_state["step"] == 30


def test_sample_on_two_ranks_equals_one_process(tmp_path: Path, capsys) -> None:
    run, _ = _train_both(tmp_path, capsys)
    copy = tmp_path / "copy" / RUN_ID
    shutil.copytree(run, copy)
    _two_ranks("sample", SAMPLE + [f"model_path={tmp_path / 'dp'}", f"model_id={RUN_ID}"])
    cli_sample.main(SAMPLE + [f"model_path={tmp_path / 'copy'}", f"model_id={RUN_ID}"])
    assert _files(run) == _files(copy)
    samples, one = np.load(run / "samples.npy"), np.load(copy / "samples.npy")
    assert samples.shape == one.shape == (12, 16, 2)
    np.testing.assert_allclose(samples, one, rtol=0, atol=SAMPLE_TOL * np.abs(one).max())
    results, want = (yaml.safe_load((r / "results.yaml").read_text()) for r in (run, copy))
    assert set(results) == set(want)
    for key, value in want.items():
        if isinstance(value, float) or (isinstance(value, list) and value
                                        and isinstance(value[0], float)):
            np.testing.assert_allclose(results[key], value, rtol=SCORE_RTOL, err_msg=key)
        else:
            assert results[key] == value, key
