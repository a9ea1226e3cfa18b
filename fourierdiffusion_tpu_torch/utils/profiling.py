"""Tracing hooks (port of ``fourierdiffusion_tpu/utils/profiling.py``).

Enable a trace around any region with::

    with trace_if_enabled("train"):
        trainer.fit(dm)

controlled by ``FDIFF_PROFILE_DIR``: where it is set, ``torch.profiler``
records the CPU and (on a CUDA device) the card's activity of the block
and writes a Chrome trace into ``$FDIFF_PROFILE_DIR/<name>/``; where it is
unset the block runs untouched. The trainer's ``steps_per_sec`` in
``metrics.jsonl`` is the standing step-time metric.

The JAX package's ``setup_compilation_cache`` and ``enable_nan_checks``
set options of JAX's compiler and have no counterpart here: the port
compiles its kernels once per source into ``_build/`` and runs eagerly.
Its ``annotate`` and ``StepTimer`` have none either, as nothing here would
call them.
"""

from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


def profile_dir() -> Optional[Path]:
    d = os.environ.get("FDIFF_PROFILE_DIR")
    return Path(d) if d else None


@contextlib.contextmanager
def trace_if_enabled(name: str) -> Iterator[None]:
    """``torch.profiler`` trace of this block when FDIFF_PROFILE_DIR is set."""
    d = profile_dir()
    if d is None:
        yield
        return
    out = d / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("Capturing torch.profiler trace into %s", out)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}.json"))


__all__ = ["profile_dir", "trace_if_enabled"]
