"""Divergent-chain census (port of ``fourierdiffusion_tpu/utils/census.py``):
the threshold past which a sampled chain counts as divergent, and the
``results.yaml`` fields that record the count and its provenance.

A chain is divergent when the largest |value| of its final time-domain
series passes ``DIVERGENCE_CENSUS_THRESHOLD`` (the data's largest |value|
is about 2; diverged chains land at 8 to 100 and more). The provenance
(protocol, guard state, seeds) lets runs be pooled by what they are: a run
with the divergence guard on is no raw census.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DIVERGENCE_CENSUS_THRESHOLD = 8.0


def census_fields(
    x: np.ndarray,
    *,
    guard_active: bool,
    num_samples: int,
    num_diffusion_steps: int,
    method: str,
    sampling_seed: int,
    train_seed: Optional[int] = None,
    checkpoint: Optional[str] = None,
    arm: Optional[str] = None,
) -> dict:
    """Census and provenance fields for ``results.yaml``.

    ``x`` is the final (un-standardised, time-domain) sample array, shape
    ``(n, ...)``. ``arm`` tags the training configuration the weights came
    from (e.g. "fused", "unfused", "reference") where the caller knows it.
    """
    x = np.asarray(x)
    absmax = np.max(np.abs(x), axis=tuple(range(1, x.ndim)))
    protocol = {
        "num_samples": int(num_samples),
        "num_diffusion_steps": int(num_diffusion_steps),
        "method": str(method),
        "sampling_seed": int(sampling_seed),
    }
    if train_seed is not None:
        protocol["train_seed"] = int(train_seed)
    if checkpoint is not None:
        protocol["checkpoint"] = str(checkpoint)
    if arm is not None:
        protocol["arm"] = str(arm)
    return {
        "divergence_census_threshold": DIVERGENCE_CENSUS_THRESHOLD,
        "divergence_census_count": int((absmax > DIVERGENCE_CENSUS_THRESHOLD).sum()),
        "divergence_census_max_absmax": float(absmax.max()),
        "divergence_census_guard_active": bool(guard_active),
        "divergence_census_protocol": protocol,
    }


__all__ = ["DIVERGENCE_CENSUS_THRESHOLD", "census_fields"]
