"""``scripts/convert_jax_run.py`` on the JAX package's flagship run
``runs/4ffeaa7e`` (orbax ``epoch=488-…`` and ``last``), on the CPU.

* The converted best checkpoint, loaded into the port's ``ScoreTransformer``
  at the flagship width (d_model 72, 10 layers, 12 heads, FFN 2048, L=100),
  gives the JAX forward's scores on the same 4 series and times to 1e-5 of
  the largest |score| (the same fp32 arithmetic in other orders).
* The converted ``last`` holds JAX's params, EMA, AdamW moments, count and
  step under the port's names, bit for bit, loads into the port's
  ``Trainer``, and ``load_last_checkpoint`` gives its EMA weights.
* The run's ``train_config.yaml``, ``metrics.jsonl`` and ``metadata.json``
  files are copied unchanged.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu.utils.config import load_config as jax_load_config
from fourierdiffusion_tpu.utils.instantiate import build_model_config as jax_build_model_config
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.utils.checkpoint import (
    get_best_checkpoint,
    load_checkpoint,
    load_last_checkpoint,
    restore_train_state,
)
from fourierdiffusion_tpu_torch.utils.config import load_config
from fourierdiffusion_tpu_torch.utils.instantiate import build_model_config
from fourierdiffusion_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "runs" / "4ffeaa7e"
L, C = 100, 1


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_run", REPO / "scripts" / "convert_jax_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def converted(tmp_path_factory) -> tuple[object, Path]:
    conv = _converter()
    out = conv.convert_run(RUN, tmp_path_factory.mktemp("converted"))
    return conv, out


def test_files_copied(converted) -> None:
    _, out = converted
    for name in ("train_config.yaml", "metrics.jsonl"):
        assert (out / name).read_bytes() == (RUN / name).read_bytes()
    for ckpt in (RUN / "checkpoints").iterdir():
        assert (out / "checkpoints" / ckpt.name / "metadata.json").read_bytes() == (
            ckpt / "metadata.json").read_bytes()
    assert get_best_checkpoint(out / "checkpoints").name == "epoch=488-val_loss=0.00"


def test_best_checkpoint_forward_equals_jax(converted) -> None:
    conv, out = converted
    variables = conv.restore_on_cpu(next((RUN / "checkpoints").glob("epoch=*")))
    jax_model = jax_build_model_config(jax_load_config(RUN / "train_config.yaml")["score_model"]
                                       ).build(n_channels=C, max_len=L)
    port = build_model_config(load_config(out / "train_config.yaml")["score_model"]).build(
        n_channels=C, max_len=L)
    port.load_state_dict(load_checkpoint(get_best_checkpoint(out / "checkpoints")))
    port.eval()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, L, C)).astype(np.float32)
    t = np.array([1e-4, 0.05, 0.5, 1.0], np.float32)
    want = np.asarray(jax_model.apply(
        {"params": variables["params"], "constants": variables["constants"]},
        jnp.asarray(x), jnp.asarray(t), deterministic=True))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (4, L, C)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_last_holds_jax_state_under_the_port_names(converted) -> None:
    conv, out = converted
    jax_state = conv.restore_on_cpu(RUN / "checkpoints" / "last")
    state, next_epoch = restore_train_state(out / "checkpoints" / "last")
    assert next_epoch == 600
    layers = 10
    adam = jax_state["opt_state"][1][0]
    assert state["step"] == int(jax_state["step"]) == 9600
    assert state["opt_state"]["count"] == int(adam["count"])
    for port_tree, jax_tree in ((state["params"], jax_state["params"]),
                                (state["ema_params"], jax_state["ema_params"]),
                                (state["opt_state"]["mu"], adam["mu"]),
                                (state["opt_state"]["nu"], adam["nu"])):
        want = state_dict_from_jax({"params": jax_tree}, layers)
        assert list(port_tree) == list(want)
        assert all(torch.equal(port_tree[k], want[k]) for k in want)
    np.testing.assert_array_equal(state["constants"]["time_encoder.W"].numpy(),
                                  np.asarray(jax_state["constants"]["time_encoder"]["W"]))
    # The JAX moments map onto the same arrays (a spot check on one leaf).
    np.testing.assert_array_equal(
        state["opt_state"]["nu"]["backbone.layers.3.linear1.weight"].numpy(),
        np.asarray(adam["nu"]["backbone"]["layers_3"]["linear1"]["kernel"]).T)


def test_converted_last_loads_into_the_port(converted) -> None:
    _, out = converted
    cfg = load_config(out / "train_config.yaml")
    model = build_model_config(cfg["score_model"]).build(n_channels=C, max_len=L)
    trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), max_epochs=600,
                      ema_decay=0.999, device="cpu")
    trainer.start(16 * 600)
    state, _ = restore_train_state(out / "checkpoints" / "last")
    trainer.load_train_state(state)
    assert trainer.step == 9600 and trainer.optimizer.count == 9600
    weights = load_last_checkpoint(out / "checkpoints")
    assert all(torch.equal(weights[k], state["ema_params"][k]) for k in state["ema_params"])
    model.load_state_dict(weights)
