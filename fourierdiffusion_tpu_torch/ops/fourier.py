"""Fourier mirror transform (port of ``fourierdiffusion_tpu/ops/fourier.py``).

``dft`` maps a real series ``(..., L, C)`` through an orthonormal real FFT
over axis ``-2`` into an equal-sized real representation::

    dft(x) = concat(Re(rfft(x))[0 .. n_real-1],  Im(rfft(x))[1 .. ])

with ``n_real = ceil((L + 1) / 2)``; for even ``L`` the structurally zero
imaginary part at the Nyquist frequency is dropped, so the packed tensor
has exactly ``L`` rows. ``idft`` re-inserts the zeros and inverts.
"""

from __future__ import annotations

import math

import torch


def n_real_components(max_len: int) -> int:
    """Number of real (cosine) coefficients in the packed representation."""
    return math.ceil((max_len + 1) / 2)


def dft(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal real-DFT mirror transform over axis ``-2``."""
    max_len = x.shape[-2]
    full = torch.fft.rfft(x.float(), dim=-2, norm="ortho")
    im = full.imag[..., 1:-1, :] if max_len % 2 == 0 else full.imag[..., 1:, :]
    return torch.cat((full.real, im), dim=-2).to(x.dtype)


def idft(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dft`."""
    max_len = x.shape[-2]
    n_real = n_real_components(max_len)
    xf = x.float()
    zero = torch.zeros_like(xf[..., :1, :])
    parts = [zero, xf[..., n_real:, :]]
    if max_len % 2 == 0:
        parts.append(zero)
    freq = torch.complex(xf[..., :n_real, :], torch.cat(parts, dim=-2))
    return torch.fft.irfft(freq, n=max_len, dim=-2, norm="ortho").to(x.dtype)


__all__ = ["dft", "idft", "n_real_components"]
