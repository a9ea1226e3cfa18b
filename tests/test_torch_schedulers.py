"""Port parity: ``fourierdiffusion_tpu_torch.schedulers`` against the JAX
``fourierdiffusion_tpu.schedulers`` on the CPU.

The noise comes from JAX: a test draws ``z`` from the key that the JAX
method splits or uses, and hands it to the port. Tolerance: the same fp32
formulas evaluated by two libraries, 1e-5 relative and absolute (the VE
scheduler's values reach sigma_max = 50, hence the relative part).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu import schedulers as jax_sched
from fourierdiffusion_tpu_torch import schedulers as sched

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE = (4, 16, 3)


def _pair(kind: str, fourier: bool):
    cls = {"vp": (jax_sched.VPScheduler, sched.VPScheduler),
           "ve": (jax_sched.VEScheduler, sched.VEScheduler)}[kind]
    return cls[0](fourier_noise_scaling=fourier), cls[1](fourier_noise_scaling=fourier)


def _inputs(seed: int, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    score = rng.normal(size=shape).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, size=(shape[0],)).astype(np.float32)
    return x, score, t


@pytest.mark.parametrize("max_len", [16, 19])
@pytest.mark.parametrize("fourier", [False, True])
def test_g_vector(max_len: int, fourier: bool) -> None:
    ours = sched.g_vector(max_len, fourier).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_sched.g_vector(max_len, fourier)))


@pytest.mark.parametrize("kind", ["vp", "ve"])
@pytest.mark.parametrize("fourier", [False, True])
def test_marginal_prob(kind: str, fourier: bool) -> None:
    j, p = _pair(kind, fourier)
    x, _, t = _inputs(0)
    mean, std = p.marginal_prob(torch.from_numpy(x), torch.from_numpy(t))
    jmean, jstd = j.marginal_prob(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), **TOL)


@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_timesteps_and_step_size(kind: str) -> None:
    j, p = _pair(kind, True)
    np.testing.assert_allclose(
        p.timesteps(50).numpy(), np.asarray(j.timesteps(50)), atol=1e-6
    )
    assert p.step_size(50) == pytest.approx(j.step_size(50), rel=1e-12)


@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_prior_sampling_with_jax_noise(kind: str) -> None:
    j, p = _pair(kind, True)
    key = jax.random.PRNGKey(3)
    z = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    ours = p.prior_sampling(SHAPE, z=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j.prior_sampling(key, SHAPE)), **TOL)


@pytest.mark.parametrize("kind", ["vp", "ve"])
@pytest.mark.parametrize("fourier", [False, True])
def test_step_with_jax_noise(kind: str, fourier: bool) -> None:
    j, p = _pair(kind, fourier)
    x, score, _ = _inputs(1)
    key = jax.random.PRNGKey(5)
    t, dt = 0.37, j.step_size(100)
    z = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    ours = p.step(
        torch.from_numpy(score), torch.tensor(t), torch.from_numpy(x), dt,
        z=torch.from_numpy(z),
    ).prev_sample
    ref = j.step(key, jnp.asarray(score), jnp.float32(t), jnp.asarray(x), dt).prev_sample
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_ode_step_and_drifts(kind: str) -> None:
    j, p = _pair(kind, True)
    x, score, _ = _inputs(2)
    t, dt = 0.81, j.step_size(20)
    args = (torch.from_numpy(score), torch.tensor(t), torch.from_numpy(x))
    jargs = (jnp.asarray(score), jnp.float32(t), jnp.asarray(x))
    np.testing.assert_allclose(
        p.reverse_drift_sde(*args).numpy(), np.asarray(j.reverse_drift_sde(*jargs)), **TOL
    )
    np.testing.assert_allclose(
        p.reverse_drift_ode(*args).numpy(), np.asarray(j.reverse_drift_ode(*jargs)), **TOL
    )
    np.testing.assert_allclose(
        p.ode_step(*args, dt).prev_sample.numpy(),
        np.asarray(j.ode_step(*jargs, dt).prev_sample), **TOL,
    )


def test_step_draws_from_generator() -> None:
    """Without ``z`` a step draws from the generator it is given."""
    p = sched.VPScheduler(fourier_noise_scaling=True)
    x, score, _ = (torch.from_numpy(a) for a in _inputs(4))
    a = p.step(score, torch.tensor(0.5), x, 0.01, generator=torch.Generator().manual_seed(0))
    b = p.step(score, torch.tensor(0.5), x, 0.01, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.prev_sample, b.prev_sample, rtol=0, atol=0)
