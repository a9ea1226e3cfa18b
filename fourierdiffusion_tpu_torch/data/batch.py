"""Batch passed through the diffusion stack (port of
``fourierdiffusion_tpu/data/batch.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiffusableBatch(NamedTuple):
    X: torch.Tensor
    y: Optional[torch.Tensor] = None
    timesteps: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.X.shape[0]


__all__ = ["DiffusableBatch"]
