"""Checkpoints in torch files, with the JAX package's run-directory layout
(port of ``fourierdiffusion_tpu/utils/checkpoint.py``, which writes orbax
checkpoints; the machine with the card has no orbax)::

    <run_dir>/<run_id>/
        train_config.yaml        resolved training config (source of truth)
        metrics.jsonl            one record per epoch, and the callbacks'
        checkpoints/
            epoch={e}-val_loss={v:.2f}/
                model.pt         the eval weights and buffers: a plain state
                                 dict, as ``load_reference_state_dict`` reads
                metadata.json    {"epoch", "step", "val_loss"}
            last/
                train_state.pt   the full training state, for resume
                metadata.json    {"epoch"}
        sample_config.yaml, results.yaml, samples.npy   (the sampling CLI's)

The best checkpoint is the one with the lowest ``val_loss`` recorded in its
``metadata.json`` (the two-decimal name is for people). ``train_state.pt``
holds only tensors, ints and name-keyed dicts::

    {"params": {name: tensor}, "constants": {name: tensor},
     "ema_params": {name: tensor} or {}, "step": int,
     "opt_state": {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}
                  or, with gradient accumulation,
                  {"mini_step": int, "gradient_step": int,
                   "acc": {name: tensor}, "inner": <the AdamW state>}}

Everything loads with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from fourierdiffusion_tpu_torch.parallel.distributed import is_primary

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def _load(path: Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(
    checkpoints_dir: Path,
    *,
    epoch: int,
    step: int,
    val_loss: float,
    params: Mapping[str, torch.Tensor],
    constants: Mapping[str, torch.Tensor],
) -> Path:
    """Write ``epoch={e}-val_loss={v:.2f}/`` with the weights and buffers as
    one state dict; returns its directory."""
    checkpoints_dir = Path(checkpoints_dir)
    path = checkpoints_dir / f"epoch={epoch}-val_loss={val_loss:.2f}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_to_cpu({**params, **constants}), path / MODEL_FILE)
    with open(path / "metadata.json", "w") as f:
        json.dump({"epoch": int(epoch), "step": int(step), "val_loss": float(val_loss)}, f)
    return path


def load_checkpoint(path: Path) -> dict[str, torch.Tensor]:
    """The state dict of a ``save_checkpoint`` directory (CPU tensors)."""
    return _load(Path(path) / MODEL_FILE)


def load_last_checkpoint(checkpoints_dir: Path) -> dict[str, torch.Tensor]:
    """The weights of ``<dir>/last`` as a state dict: the EMA weights where
    the run kept an EMA (the weights it validated and sampled with), else
    the raw ones, with the buffers."""
    last = Path(checkpoints_dir) / "last"
    if not last.exists():
        raise FileNotFoundError(f"No 'last' checkpoint under {checkpoints_dir}")
    state = _load(last / TRAIN_STATE_FILE)
    params = state.get("ema_params") or state["params"]
    return {**params, **state["constants"]}


def get_best_checkpoint(checkpoints_dir: Path) -> Path:
    """The checkpoint directory with the lowest recorded ``val_loss``."""
    checkpoints_dir = Path(checkpoints_dir)
    best: Optional[Path] = None
    best_loss = float("inf")
    for meta_path in sorted(checkpoints_dir.glob("*/metadata.json")):
        with open(meta_path) as f:
            meta = json.load(f)
        if "val_loss" not in meta:  # the full-state "last" checkpoint
            continue
        if meta["val_loss"] < best_loss:
            best_loss = meta["val_loss"]
            best = meta_path.parent
    if best is None:
        raise FileNotFoundError(f"No checkpoints under {checkpoints_dir}")
    return best


def save_train_state(checkpoints_dir: Path, state: Mapping[str, Any], epoch: int) -> Path:
    """Write the full training state to ``<dir>/last``: first to
    ``last.tmp``, then renamed over ``last``, so a kill mid-write leaves the
    previous ``last`` whole."""
    checkpoints_dir = Path(checkpoints_dir)
    checkpoints_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoints_dir / "last"
    tmp = checkpoints_dir / "last.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save(_to_cpu(dict(state)), tmp / TRAIN_STATE_FILE)
    with open(tmp / "metadata.json", "w") as f:
        json.dump({"epoch": int(epoch)}, f)
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def restore_train_state(last_dir: Path) -> tuple[dict[str, Any], int]:
    """``(state, next_epoch)`` of a ``save_train_state`` directory."""
    last_dir = Path(last_dir)
    state = _load(last_dir / TRAIN_STATE_FILE)
    with open(last_dir / "metadata.json") as f:
        epoch = json.load(f)["epoch"]
    return state, int(epoch) + 1


class BestCheckpointCallback:
    """Epoch callback: keep the checkpoint with the lowest ``val/loss``
    (Lightning ``ModelCheckpoint(monitor="val/loss")`` semantics); the
    previous best is deleted. In a multi-process run every rank tracks the
    best (the losses are reduced, so they agree) and the primary writes it."""

    def __init__(self, checkpoints_dir: Path) -> None:
        self.checkpoints_dir = Path(checkpoints_dir)
        self.best_loss = float("inf")
        self.best_path: Optional[Path] = None

    def __call__(self, trainer, epoch: int, params, constants, metrics) -> None:
        val_loss = metrics["val/loss"]
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            if not is_primary():
                return
            prev = self.best_path
            self.best_path = save_checkpoint(
                self.checkpoints_dir,
                epoch=epoch,
                step=int(metrics.get("step", epoch)),  # the optimiser step
                val_loss=val_loss,
                params=params,
                constants=constants,
            )
            if prev is not None and prev != self.best_path and prev.exists():
                shutil.rmtree(prev, ignore_errors=True)


__all__ = [
    "BestCheckpointCallback",
    "get_best_checkpoint",
    "load_checkpoint",
    "load_last_checkpoint",
    "restore_train_state",
    "save_checkpoint",
    "save_train_state",
]
