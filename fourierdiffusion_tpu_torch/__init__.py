"""PyTorch/CUDA port of ``fourierdiffusion_tpu`` (score-based time-series
diffusion in the time and frequency domains).

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` only. Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``; on a CUDA tensor every kernel wrapper launches its
hand-written Hopper kernel (``csrc/``) and on a CPU tensor it runs the plain
PyTorch version of the same arithmetic.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no
    CUDA device is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


__all__ = ["resolve_device"]
