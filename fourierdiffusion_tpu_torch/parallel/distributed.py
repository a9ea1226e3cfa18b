"""Multi-process runs on ``torch.distributed`` (port of
``fourierdiffusion_tpu/parallel/distributed.py``).

One process per card, where JAX runs one process per host over all its
chips. Launch the same command once per rank, with ``torchrun``::

    torchrun --nproc-per-node=2 -m fourierdiffusion_tpu_torch.cli.train ...

or with the JAX package's three variables, on each rank::

    FDIFF_COORDINATOR_ADDRESS=host0:8476 FDIFF_NUM_PROCESSES=2 \\
    FDIFF_PROCESS_ID=<i> fdiff-torch-train ...

Rank ``i``'s device is ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the
process id), its backend NCCL on a card and gloo on the CPU. Nothing falls
back: a failed initialisation raises, and an explicit ``backend="gloo"``
on CUDA (two ranks sharing one card, which NCCL refuses) is the caller's
choice, never a substitute for NCCL.

Under a mesh every rank holds the same state, built from the same seed
(``assert_replicated_equal`` checks that bit for bit: JAX's
``replicate_to_mesh`` and ``host_local_copy``); batch-sharded results are
gathered onto every rank with ``gather_to_host``; files are written by the
primary only.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from fourierdiffusion_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

_ENV_ADDRESS = "FDIFF_COORDINATOR_ADDRESS"
_ENV_NUM = "FDIFF_NUM_PROCESSES"
_ENV_ID = "FDIFF_PROCESS_ID"
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# Seconds a collective may wait for its peers before it fails: a rank that
# skips a collective fails the run instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0

# The device of this rank, set by maybe_initialize_distributed.
_device: Optional[torch.device] = None


def distributed_env(env: Mapping[str, str] = os.environ) -> Optional[dict]:
    """``{"init_method", "world_size", "rank", "local_rank"}`` from the
    JAX package's ``FDIFF_*`` variables or else from ``torchrun``'s, or
    ``None`` when neither set is present. A partial set raises."""
    if _ENV_ADDRESS in env or _ENV_NUM in env:
        missing = [k for k in (_ENV_ADDRESS, _ENV_NUM, _ENV_ID) if k not in env]
        if missing:
            raise ValueError(f"multi-process run: {', '.join(missing)} not set")
        rank = int(env[_ENV_ID])
        layout = {"init_method": f"tcp://{env[_ENV_ADDRESS]}",
                  "world_size": int(env[_ENV_NUM]), "rank": rank}
    elif any(k in env for k in _TORCHRUN):
        missing = [k for k in _TORCHRUN if k not in env]
        if missing:
            raise ValueError(f"torchrun variables incomplete: {', '.join(missing)} not set")
        rank = int(env["RANK"])
        layout = {"init_method": f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                  "world_size": int(env["WORLD_SIZE"]), "rank": rank}
    else:
        return None
    if not 0 <= rank < layout["world_size"]:
        raise ValueError(f"rank {rank} outside a world of {layout['world_size']}")
    layout["local_rank"] = int(env.get("LOCAL_RANK", rank))
    return layout


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` (``cuda`` alone meaning ``cuda:local_rank``), or
    ``cuda:local_rank`` where none is given; raises where that card is
    absent."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = local_rank if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank device cuda:{index} does not exist ({torch.cuda.device_count()} "
                "CUDA devices visible); pass device= to place ranks yourself"
            )
        dev = torch.device("cuda", index)
    return dev


def maybe_initialize_distributed(
    *, backend: Optional[str] = None, device: str | torch.device | None = None,
) -> bool:
    """Join the process group that the environment describes
    (``distributed_env``); a no-op that returns False where it describes
    none. Returns True in a multi-process run (also when already joined).

    ``device`` overrides the rank's device (``cuda:LOCAL_RANK``); ``backend``
    the default NCCL on CUDA and gloo on the CPU. Collectives time out after
    ``DEFAULT_TIMEOUT_S`` seconds.
    """
    global _device
    if dist.is_initialized():
        return True
    layout = distributed_env()
    if layout is None:
        return False
    dev = _rank_device(device, layout["local_rank"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=layout["init_method"], world_size=layout["world_size"],
        rank=layout["rank"], timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
    )
    _device = dev
    logger.info("torch.distributed: rank %d of %d on %s (%s)", layout["rank"],
                layout["world_size"], dev, backend)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> Optional[torch.device]:
    """This rank's device in a multi-process run, else None."""
    return _device if dist.is_initialized() else None


def is_primary() -> bool:
    """True on the process that writes files (logs, checkpoints, results)."""
    return rank() == 0


def barrier() -> None:
    """Return once every rank has called it: an all-reduce on the rank's
    device, waited for on the host (NCCL's collectives return at launch)."""
    if dist.is_initialized():
        flag = torch.zeros(1, device=_device)
        dist.all_reduce(flag)
        flag.item()


def all_reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over ranks of each tensor, through one all-reduce of one
    flat buffer (not one per tensor). Every rank gets the same bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world_size())
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_to_host(x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal shard of ``x`` (led by the batch), concatenated in
    rank order, on every rank's own device (JAX's ``gather_to_host``, whose
    name this keeps, fetches it to the host; this stays on the device)."""
    if not dist.is_initialized():
        return x
    x = x.contiguous()
    shards = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(shards, x)
    return torch.cat(shards)


def assert_replicated_equal(named: Mapping[str, torch.Tensor], what: str = "weights") -> None:
    """Raise on every rank unless every rank holds ``named`` bit for bit as
    rank 0 does (JAX's ``_assert_replicated_equal``). A collective: every
    rank calls it with the same names and shapes."""
    if not dist.is_initialized():
        return
    blobs = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in named.values()]
    sizes = [b.numel() for b in blobs]
    gathered = gather_to_host(torch.cat(blobs)[None]).split(sizes, dim=1)
    differ = [name for name, g in zip(named, gathered) if not bool((g == g[:1]).all())]
    if differ:
        raise AssertionError(f"{what}: ranks disagree with rank 0 on {differ}")


__all__ = [
    "DEFAULT_TIMEOUT_S",
    "all_reduce_mean",
    "assert_replicated_equal",
    "barrier",
    "distributed_env",
    "gather_to_host",
    "is_primary",
    "maybe_initialize_distributed",
    "rank",
    "rank_device",
    "shutdown",
    "world_size",
]
