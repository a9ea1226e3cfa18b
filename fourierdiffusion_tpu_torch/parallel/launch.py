"""Run the ranks of one job as local processes (``dryrun_multichip``, the
multi-process tests and ``chip_smoke.py``): one command started once per
rank with the ``FDIFF_*`` variables of ``parallel/distributed.py`` on
``127.0.0.1``, waited for together.

A rank that fails ends the others at once, and so does the time limit, so
a rank that died, or skipped a collective, never leaves its peers waiting.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Mapping, Optional

REPO = Path(__file__).resolve().parents[2]
TAIL = 4000  # characters of each rank's output in an error


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank: int, port: int,
             env: Optional[Mapping[str, str]] = None) -> dict[str, str]:
    """The environment of ``rank``: this one's, the repository root on
    ``PYTHONPATH``, torchrun's variables dropped, the ``FDIFF_*`` ones set
    and ``env`` on top."""
    out = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    out["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)
    out.update(FDIFF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", FDIFF_NUM_PROCESSES=str(world),
               FDIFF_PROCESS_ID=str(rank))
    out.update(env or {})
    return out


def run_ranks(argv: list[str], world: int, *, timeout: float,
              env: Optional[Mapping[str, str]] = None, cwd: Path = REPO) -> list[str]:
    """Run ``argv`` as ranks 0 to ``world - 1`` and return each one's
    output (stdout and stderr). Raises ``RuntimeError`` with every rank's
    last output where a rank exits non-zero or they outlast ``timeout``
    seconds; every rank still running is then killed."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs: list[subprocess.Popen] = []
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(
                        argv, cwd=cwd, env=rank_env(world, r, port, env),
                        stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((f"rank {r} exited with {p.returncode}"
                               for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if failed is None and time.monotonic() > deadline:
                    failed = f"ranks outlasted {timeout:.0f} s"
                time.sleep(0.05)
            if failed is None:
                failed = next((f"rank {r} exited with {p.returncode}"
                               for r, p in enumerate(procs) if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = [log.read_text(errors="replace") for log in logs]
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n{o[-TAIL:]}" for r, o in enumerate(outputs))
        raise RuntimeError(f"{' '.join(argv)}: {failed}\n{tails}")
    return outputs


__all__ = ["free_port", "rank_env", "run_ranks"]
