"""The port's checkpoints (``utils/checkpoint.py``), on the CPU.

* ``save_checkpoint`` / ``load_checkpoint`` round-trip a state dict bit for
  bit, and the file is a plain state dict that ``load_reference_state_dict``
  loads into a ``ScoreTransformer``;
* ``get_best_checkpoint`` picks the lowest ``val_loss`` of ``metadata.json``
  (not of the two-decimal name) and skips ``last``;
* ``save_train_state`` replaces ``last`` whole, through ``last.tmp``, and a
  stale ``last.tmp`` is cleared; ``restore_train_state`` returns the next
  epoch;
* ``load_last_checkpoint`` gives the EMA weights where they exist;
* ``BestCheckpointCallback`` keeps one checkpoint, the best;
* every file loads with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.utils import checkpoint as ckpt
from fourierdiffusion_tpu_torch.utils.weights import load_reference_state_dict


def _model(seed: int = 0):
    return ScoreModelConfig(d_model=16, num_layers=1, n_head=2, dim_feedforward=32).build(
        n_channels=2, max_len=12, seed=seed)


def _split(model):
    return dict(model.named_parameters()), dict(model.named_buffers())


def _equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_round_trip(tmp_path: Path) -> None:
    model = _model()
    params, constants = _split(model)
    path = ckpt.save_checkpoint(tmp_path, epoch=3, step=48, val_loss=0.123456,
                                params=params, constants=constants)
    assert path.name == "epoch=3-val_loss=0.12"
    assert json.loads((path / "metadata.json").read_text()) == {
        "epoch": 3, "step": 48, "val_loss": 0.123456}
    state = ckpt.load_checkpoint(path)
    assert _equal(state, {**params, **constants})
    assert all(t.device.type == "cpu" for t in state.values())
    other = load_reference_state_dict(_model(seed=1), path / "model.pt")
    assert _equal(other.state_dict(), model.state_dict())
    torch.load(path / "model.pt", weights_only=True)


def test_best_checkpoint_by_metadata(tmp_path: Path) -> None:
    params, constants = _split(_model())
    for epoch, loss in ((0, 0.0049), (1, 0.0041), (2, 0.0044)):
        ckpt.save_checkpoint(tmp_path, epoch=epoch, step=epoch, val_loss=loss,
                             params=params, constants=constants)
    # All three names read val_loss=0.00; metadata.json decides.
    assert ckpt.get_best_checkpoint(tmp_path).name == "epoch=1-val_loss=0.00"
    ckpt.save_train_state(tmp_path, {"params": params, "constants": constants,
                                     "ema_params": {}, "opt_state": {}, "step": 0}, 2)
    assert ckpt.get_best_checkpoint(tmp_path).name == "epoch=1-val_loss=0.00"


def test_no_checkpoint_raises(tmp_path: Path) -> None:
    with pytest.raises(FileNotFoundError):
        ckpt.get_best_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_last_checkpoint(tmp_path)


def _train_state(model, ema_seed=None) -> dict:
    params, constants = _split(model)
    ema = _split(_model(ema_seed))[0] if ema_seed is not None else {}
    return {"params": params, "constants": constants, "ema_params": ema,
            "opt_state": {"count": 5, "mu": {k: torch.ones_like(v) for k, v in params.items()},
                          "nu": {k: torch.zeros_like(v) for k, v in params.items()}},
            "step": 5}


def test_last_replaced_atomically(tmp_path: Path) -> None:
    first = _train_state(_model(0))
    ckpt.save_train_state(tmp_path, first, epoch=0)
    (tmp_path / "last.tmp").mkdir()
    (tmp_path / "last.tmp" / "partial").write_text("a write cut short")
    second = _train_state(_model(1))
    path = ckpt.save_train_state(tmp_path, second, epoch=1)
    assert path == tmp_path / "last"
    assert not (tmp_path / "last.tmp").exists()
    assert sorted(p.name for p in path.iterdir()) == ["metadata.json", "train_state.pt"]
    state, next_epoch = ckpt.restore_train_state(path)
    assert next_epoch == 2
    assert _equal(state["params"], second["params"])
    assert state["opt_state"]["count"] == 5 and state["step"] == 5


def test_train_state_keeps_the_previous_last_until_the_rename(tmp_path: Path,
                                                              monkeypatch) -> None:
    ckpt.save_train_state(tmp_path, _train_state(_model(0)), epoch=0)

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    with pytest.raises(OSError):
        ckpt.save_train_state(tmp_path, _train_state(_model(1)), epoch=1)
    state, next_epoch = ckpt.restore_train_state(tmp_path / "last")
    assert next_epoch == 1
    assert _equal(state["params"], _split(_model(0))[0])


@pytest.mark.parametrize("with_ema", [True, False], ids=["ema", "no-ema"])
def test_load_last_prefers_ema(tmp_path: Path, with_ema: bool) -> None:
    model = _model(0)
    state = _train_state(model, ema_seed=7 if with_ema else None)
    ckpt.save_train_state(tmp_path, state, epoch=4)
    weights = ckpt.load_last_checkpoint(tmp_path)
    want = state["ema_params"] if with_ema else state["params"]
    assert _equal(weights, {**want, **state["constants"]})
    _model(3).load_state_dict(weights)  # a complete state dict


def test_best_callback_keeps_only_the_best(tmp_path: Path) -> None:
    params, constants = _split(_model())
    cb = ckpt.BestCheckpointCallback(tmp_path)
    for epoch, loss in enumerate((0.5, 0.3, 0.4, 0.2)):
        cb(None, epoch, params, constants, {"val/loss": loss, "step": 10 * (epoch + 1)})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["epoch=3-val_loss=0.20"]
    meta = json.loads((tmp_path / names[0] / "metadata.json").read_text())
    assert meta == {"epoch": 3, "step": 40, "val_loss": 0.2}
