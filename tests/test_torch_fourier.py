"""Port parity: ``fourierdiffusion_tpu_torch.ops.fourier`` against the JAX
``fourierdiffusion_tpu.ops.fourier`` on the same numpy inputs, on the CPU.

Tolerance: both run an orthonormal real FFT in fp32 with different FFT
libraries, so they agree to a few fp32 ulps of O(1) values: 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu.ops import fourier as jax_fourier
from fourierdiffusion_tpu_torch.ops import fourier

TOL = 1e-5


def _x(max_len: int, channels: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(4, max_len, channels)).astype(np.float32)


@pytest.mark.parametrize("max_len", [16, 19, 100, 187])
@pytest.mark.parametrize("channels", [1, 3])
def test_dft_matches_jax(max_len: int, channels: int) -> None:
    x = _x(max_len, channels)
    ours = fourier.dft(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_fourier.dft(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=TOL)


@pytest.mark.parametrize("max_len", [16, 19, 100])
def test_idft_matches_jax(max_len: int) -> None:
    x = _x(max_len, 2, seed=1)
    ours = fourier.idft(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_fourier.idft(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=TOL)


@pytest.mark.parametrize("max_len", [16, 19])
def test_round_trip(max_len: int) -> None:
    x = torch.from_numpy(_x(max_len, 3, seed=2))
    torch.testing.assert_close(fourier.idft(fourier.dft(x)), x, atol=TOL, rtol=0)
    torch.testing.assert_close(fourier.dft(fourier.idft(x)), x, atol=TOL, rtol=0)


@pytest.mark.parametrize("max_len", [16, 19, 100, 101])
def test_n_real_components(max_len: int) -> None:
    assert fourier.n_real_components(max_len) == jax_fourier.n_real_components(max_len)
