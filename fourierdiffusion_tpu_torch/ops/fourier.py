"""Fourier mirror transform and spectral utilities (port of
``fourierdiffusion_tpu/ops/fourier.py``).

``dft`` maps a real series ``(..., L, C)`` through an orthonormal real FFT
over axis ``-2`` into an equal-sized real representation::

    dft(x) = concat(Re(rfft(x))[0 .. n_real-1],  Im(rfft(x))[1 .. ])

with ``n_real = ceil((L + 1) / 2)``; for even ``L`` the structurally zero
imaginary part at the Nyquist frequency is dropped, so the packed tensor
has exactly ``L`` rows. ``idft`` re-inserts the zeros and inverts.
``spectral_density`` gives the power per frequency, ``localization_metrics``
the time and frequency delocalisation of each series, and
``smooth_frequency`` a Gaussian smoothing over the packed frequencies. All
run on the tensors' device.
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


def _imaginary(x: torch.Tensor) -> torch.Tensor:
    """The imaginary parts of a packed ``(..., L, C)`` tensor with the
    structural zeros put back (at DC, and at Nyquist for even L):
    ``(..., n_real, C)``."""
    max_len = x.shape[-2]
    zero = torch.zeros_like(x[..., :1, :])
    parts = [zero, x[..., n_real_components(max_len):, :]]
    if max_len % 2 == 0:
        parts.append(zero)
    return torch.cat(parts, dim=-2)


def idft(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dft`."""
    max_len = x.shape[-2]
    xf = x.float()
    freq = torch.complex(xf[..., :n_real_components(max_len), :], _imaginary(xf))
    return torch.fft.irfft(freq, n=max_len, dim=-2, norm="ortho").to(x.dtype)


def spectral_density(x: torch.Tensor, apply_dft: bool = True) -> torch.Tensor:
    """Power ``Re^2 + Im^2`` per frequency, ``(..., n_real, C)``, of a
    series (time domain if ``apply_dft``, packed frequencies otherwise)."""
    if apply_dft:
        x = dft(x)
    return x[..., :n_real_components(x.shape[-2]), :] ** 2 + _imaginary(x) ** 2


def _cyclic_distance_sq(max_len: int, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Squared cyclic distance matrix ``min(|i-j|, L-|i-j|)^2``."""
    t = torch.arange(max_len, dtype=dtype, device=device)
    d = torch.abs(t[:, None] - t[None, :])
    return torch.minimum(d, max_len - d) ** 2


def localization_metrics(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Time and frequency delocalisation of each series of ``(B, L, C)``:
    the energy over time, and over the spectrum mirrored past Nyquist to L
    bins, contracted with the squared cyclic distances and minimised over
    shifts. Returns two ``(B,)`` tensors."""
    max_len = x.shape[-2]
    energy = torch.sum(x**2, dim=2)
    energy = energy / torch.sum(energy, dim=1, keepdim=True)
    spec = spectral_density(x)
    mirror = torch.flip(spec[:, 1:-1, :] if max_len % 2 == 0 else spec[:, 1:, :], dims=(1,))
    spec = torch.sum(torch.cat((spec, mirror), dim=1), dim=2)
    spec = spec / torch.sum(spec, dim=1, keepdim=True)
    dist_sq = _cyclic_distance_sq(max_len, x.dtype, x.device)
    return torch.amin(energy @ dist_sq, dim=1), torch.amin(spec @ dist_sq, dim=1)


def smooth_frequency(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smoothing of width ``sigma`` over the packed frequencies of
    ``(B, L, C)`` time series, returned in time. The frequency index of
    each packed row mirrors across Nyquist, ``concat(arange(0, n_real),
    arange(1, L - n_real + 1))``, so even L address the Nyquist bin as the
    JAX package does."""
    max_len = x.shape[-2]
    n_real = n_real_components(max_len)
    k = torch.cat((torch.arange(0, n_real, dtype=torch.float32, device=x.device),
                   torch.arange(1, max_len - n_real + 1, dtype=torch.float32, device=x.device)))
    diff = (k[:, None] - k[None, :]) / sigma
    kernel = torch.exp(-(diff**2) / 2)
    kernel = kernel / torch.sum(kernel, dim=0, keepdim=True)
    x_freq = dft(x)
    return idft(torch.einsum("btc,ts->bsc", x_freq, kernel.to(x_freq.dtype)))


__all__ = [
    "dft",
    "idft",
    "localization_metrics",
    "n_real_components",
    "smooth_frequency",
    "spectral_density",
]
