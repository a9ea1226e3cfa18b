"""Exact 1-D Wasserstein-2 distances, batched (port of
``fourierdiffusion_tpu/ops/wasserstein.py``).

For uniformly weighted empirical distributions the exact 1-D W2 has a
closed form through the quantile functions::

    W2(P, Q)^2 = int_0^1 (F^-1(u) - G^-1(u))^2 du

Both inverse CDFs are piecewise constant with breakpoints at ``i/n`` and
``j/m``, so the integral is evaluated exactly on the merged breakpoint
grid: one batched sort and gather over all projections at once. For
``n == m`` it is ``mean((sort(x) - sort(y))^2)``.

The distances run in fp32 on an explicit device (default ``"cuda"``; the
CPU tests pass ``"cpu"``). The projection directions are drawn with numpy
exactly as the JAX package draws them, so both project onto the same unit
vectors for a seed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _quantile_grid(n: int, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Segment weights and per-distribution indices on the merged grid."""
    levels = np.sort(np.concatenate([np.arange(1, n) / n, np.arange(1, m) / m]))
    bounds = np.concatenate([[0.0], levels, [1.0]])
    deltas = np.diff(bounds).astype(np.float32)
    mids = (bounds[:-1] + bounds[1:]) / 2
    ix = np.minimum((mids * n).astype(np.int32), n - 1)
    iy = np.minimum((mids * m).astype(np.int32), m - 1)
    return deltas, ix, iy


def _w2_equal(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xs = torch.sort(x, dim=-1).values
    ys = torch.sort(y, dim=-1).values
    return torch.sqrt(torch.mean((xs - ys) ** 2, dim=-1))


def w2_1d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact W2 between rows of ``x (..., n)`` and ``y (..., m)``."""
    n, m = x.shape[-1], y.shape[-1]
    if n == m:
        return _w2_equal(x, y)
    deltas, ix, iy = (torch.from_numpy(a).to(x.device) for a in _quantile_grid(n, m))
    xs = torch.sort(x, dim=-1).values[..., ix.long()]
    ys = torch.sort(y, dim=-1).values[..., iy.long()]
    return torch.sqrt(torch.sum((xs - ys) ** 2 * deltas, dim=-1))


def random_directions(dim: int, n_directions: int, seed: int | None) -> np.ndarray:
    """Unit vectors from sequential ``default_rng(seed).normal(size=dim)``
    draws, normalised: the JAX package's (and its reference's) directions,
    bit for bit, for a seed."""
    rng = np.random.default_rng(seed)
    dirs = np.empty((n_directions, dim), dtype=np.float64)
    for i in range(n_directions):
        v = rng.normal(size=dim)
        dirs[i] = v / np.linalg.norm(v)
    return dirs.astype(np.float32)


def _normalise(proj_orig: torch.Tensor, proj_other: torch.Tensor, normalisation: str):
    """Both sides divided by the (population) std of each projection of the
    original samples, or left as they are."""
    if normalisation == "none":
        return proj_orig, proj_other
    if normalisation == "standardise":
        sd = torch.std(proj_orig, dim=-1, keepdim=True, correction=0)
        return proj_orig / sd, proj_other / sd
    raise ValueError(f"Unrecognised normalisation type: {normalisation}")


def _f32(x, device: torch.device | str) -> torch.Tensor:
    """A numpy array or a tensor as an fp32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def sliced_w2(
    original,
    other,
    *,
    num_directions: int,
    seed: int | None,
    normalisation: str = "none",
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """W2 along ``num_directions`` random unit projections of ``(n, d)``
    and ``(m, d)`` samples: one product projects everything, one batched
    sort gives every distance. Returns ``(num_directions,)``."""
    original, other = _f32(original, device), _f32(other, device)
    dirs = _f32(random_directions(original.shape[1], num_directions, seed), device)
    proj_orig, proj_other = _normalise((original @ dirs.T).T, (other @ dirs.T).T,
                                       normalisation)
    return w2_1d(proj_orig, proj_other).cpu().numpy()


def marginal_w2(
    original, other, normalisation: str = "none", device: torch.device | str = "cuda"
) -> np.ndarray:
    """W2 along every standard basis direction (per flattened feature)."""
    original, other = _f32(original, device), _f32(other, device)
    proj_orig, proj_other = _normalise(original.T, other.T, normalisation)
    return w2_1d(proj_orig, proj_other).cpu().numpy()


def check_flat_array(x) -> np.ndarray:
    """``x`` (a numpy array or a tensor on any device) as a 2-D ``(n,
    features)`` numpy array."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if x.ndim != 2:
        raise ValueError(f"expected a 2d array, got {x.ndim}d")
    return x


__all__ = ["check_flat_array", "marginal_w2", "random_directions", "sliced_w2", "w2_1d"]
