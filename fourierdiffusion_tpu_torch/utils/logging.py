"""Metrics writers: local JSONL always, wandb optionally (port of
``fourierdiffusion_tpu/utils/logging.py``).

The run id is generated locally and wandb is an optional sink: where wandb
is absent or fails to start, a warning is logged and a local id is used.
The record keys (``train/loss``, ``val/loss``, ``lr``, ``metrics/*``, and
``_time``/``_step`` in ``metrics.jsonl``) are the JAX package's.
"""

from __future__ import annotations

import json
import logging
import secrets
import time
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger(__name__)


def generate_run_id() -> str:
    """8-char lowercase hex id (wandb-style)."""
    return secrets.token_hex(4)


class JsonlWriter:
    """Appends one JSON object per log call to ``<run_dir>/metrics.jsonl``."""

    def __init__(self, run_dir: Path) -> None:
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        record: dict[str, Any] = {"_time": time.time()}
        if step is not None:
            record["_step"] = step
        record.update(metrics)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def finish(self) -> None:
        pass


class WandbWriter:
    """Optional wandb sink (project ``FourierDiffusion``)."""

    def __init__(self, config: dict, project: str = "FourierDiffusion") -> None:
        import wandb  # optional dependency, imported only when asked for

        self.run = wandb.init(project=project, config=config)

    @property
    def run_id(self) -> str:
        return str(self.run.id)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        self.run.log(metrics, step=step)

    def finish(self) -> None:
        self.run.finish()


class MultiWriter:
    def __init__(self, *writers) -> None:
        self.writers = [w for w in writers if w is not None]

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        for w in self.writers:
            w.log(metrics, step=step)

    def finish(self) -> None:
        for w in self.writers:
            w.finish()


def maybe_initialize_wandb(cfg: dict) -> tuple[Optional[WandbWriter], str]:
    """``(writer or None, run_id)``; a wandb failure falls back to a locally
    generated id instead of ending the run."""
    if cfg.get("use_wandb"):
        try:
            from fourierdiffusion_tpu_torch.utils.config import flatten_config

            writer = WandbWriter(flatten_config(cfg))
            return writer, writer.run_id
        except Exception as e:  # no wandb installed, or no network
            logger.warning("wandb init failed (%s); falling back to local id", e)
    return None, generate_run_id()


__all__ = ["JsonlWriter", "MultiWriter", "WandbWriter", "generate_run_id",
           "maybe_initialize_wandb"]
