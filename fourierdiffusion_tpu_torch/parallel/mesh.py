"""The data mesh (port of ``fourierdiffusion_tpu/parallel/mesh.py``).

JAX's 1-D ``data`` mesh becomes the ranks of the process group: rank r of
W holds rows ``[r B/W, (r+1) B/W)`` of every batch of B. XLA partitions a
JAX program over the mesh and the one-device numbers come out; here the
trainer and the sampler do it themselves, and keep the same rule:

* every batch-led random tensor (the loss's ``t`` and ``z``, the unfused
  module's Bernoulli dropouts, the sampler's prior and per-step noise) is
  drawn at the global batch's shape from the stream all ranks share, and
  each rank keeps its rows (``ShardedGenerator``, ``batch_draw``);
* every hashed dropout mask is keyed by the global chain (its key is
  ``seed + chain*131071 + ...``), so rank r shifts each dropout seed by its
  first chain (``DataMesh.chain_seed``, ``batch_seed``);
* gradients, losses and the pc corrector's batch means are reduced over
  the ranks (``parallel/distributed.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

from fourierdiffusion_tpu_torch.ops.dropout_hash import shift_seed
from fourierdiffusion_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of the process group as a 1-D data mesh."""

    world_size: int
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        """JAX's ``mesh.size``."""
        return self.world_size

    def place(self, device: str | torch.device | None = None) -> torch.device:
        """The mesh's device, for a trainer or sampler asked for ``device``,
        which must name it where given (``cuda`` alone names this rank's
        card)."""
        if device is not None:
            dev = torch.device(device)
            if dev.type != self.device.type or dev.index not in (None, self.device.index):
                raise ValueError(f"device {dev} is not this rank's {self.device}")
        return self.device

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        if batch % self.world_size:
            raise ValueError(f"batch {batch} does not divide over {self.world_size} ranks")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def chain_seed(self, seed: torch.Tensor | int, batch: int) -> torch.Tensor | int:
        """A dropout seed (or seeds) of the whole batch, for this rank's
        ``batch`` rows: shifted to its first chain, so that the hashed masks
        of its chains are those of their global chains."""
        return shift_seed(seed, self.rank * batch)


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """A generator whose batch-led draws are made at the global batch (the
    local batch times the world size) and cut to this rank's rows, so that
    every rank draws what the one-process run draws for its chains. The
    score networks take it wherever they take a ``torch.Generator``."""

    generator: torch.Generator
    mesh: DataMesh


Stream = Optional[torch.Generator | ShardedGenerator]


def batch_draw(
    draw: Callable[[int, Optional[torch.Generator]], torch.Tensor], batch: int,
    generator: Stream,
) -> torch.Tensor:
    """``draw(n, gen)`` makes a tensor led by ``n`` rows from ``gen``: at
    the local ``batch``, or, from a ``ShardedGenerator``, at the global
    batch, cut to this rank's rows."""
    if isinstance(generator, ShardedGenerator):
        mesh = generator.mesh
        total = batch * mesh.world_size
        return draw(total, generator.generator)[mesh.rows(total)]
    return draw(batch, generator)


def batch_seed(
    draw: Callable[[Optional[torch.Generator]], torch.Tensor], batch: int, generator: Stream,
) -> torch.Tensor:
    """``draw(gen)`` makes the dropout seeds of hashed masks from ``gen``;
    from a ``ShardedGenerator`` they are made for this rank's ``batch``
    rows (``DataMesh.chain_seed``)."""
    if isinstance(generator, ShardedGenerator):
        return generator.mesh.chain_seed(draw(generator.generator), batch)
    return draw(generator)


def make_mesh() -> DataMesh:
    """The mesh over every rank of the process group
    (``parallel/distributed.py::maybe_initialize_distributed`` first)."""
    device = distributed.rank_device()
    if device is None:
        raise RuntimeError("make_mesh needs a process group: maybe_initialize_distributed first")
    return DataMesh(distributed.world_size(), distributed.rank(), device)


def auto_data_mesh(batch_size: Optional[int] = None) -> Optional[DataMesh]:
    """The mesh the CLIs and the trainer use: over every rank, or ``None``
    with one rank, or where ``batch_size`` does not divide over the ranks
    (then every rank runs the whole batch, replicated, as JAX does)."""
    n = distributed.world_size()
    if n < 2:
        return None
    if batch_size is not None and batch_size % n:
        logger.warning("batch %d does not divide over %d ranks: every rank runs the whole "
                       "batch, replicated", batch_size, n)
        return None
    return make_mesh()


def shard_batch(mesh: DataMesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch."""
    return batch[mesh.rows(batch.shape[0])]


__all__ = [
    "DataMesh",
    "ShardedGenerator",
    "Stream",
    "auto_data_mesh",
    "batch_draw",
    "batch_seed",
    "make_mesh",
    "shard_batch",
]
