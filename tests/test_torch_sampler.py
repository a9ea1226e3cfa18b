"""Port parity: the reverse-diffusion sampler of ``fourierdiffusion_tpu_torch``
against JAX ``make_sample_fn(fused=True)``, on the CPU.

``jax.random`` and torch draw different numbers, so the test re-derives the
noise JAX drew from its own key splits (the prior from the first half of
``split(key)``, one step key per step from ``split(scan_key, K)``) and
hands it to ``reverse_diffusion``.

Tolerance: 1e-4 absolute and relative in fp32. Five reverse steps of the VP
SDE end at t = 1e-5, where the score is scaled up by 1/std(t); per-step
differences of ~1e-6 from other summation orders grow to ~1e-5 there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models

from fourierdiffusion_tpu.sampling.sampler import make_sample_fn as jax_make_sample_fn
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.sampling import (
    DiffusionSampler,
    make_sample_fn,
    reverse_diffusion,
)
from fourierdiffusion_tpu_torch.schedulers import VPScheduler

TOL = dict(atol=1e-4, rtol=1e-4)
K, BATCH, MAX_LEN, N_CHANNELS = 5, 3, 19, 1
SHAPE = (BATCH, MAX_LEN, N_CHANNELS)


def _jax_noise(key) -> tuple[torch.Tensor, torch.Tensor]:
    """The prior draw and the per-step draws of JAX's ``sample(variables, key)``."""
    prior_key, scan_key = jax.random.split(key)
    z0 = jax.random.normal(prior_key, SHAPE, jnp.float32)
    zs = [jax.random.normal(k, SHAPE, jnp.float32) for k in jax.random.split(scan_key, K)]
    return torch.from_numpy(np.array(z0)), torch.from_numpy(np.array(jnp.stack(zs)))


@pytest.mark.parametrize(
    "method,score_clip", [("em", None), ("ode", None), ("em", 2.0)]
)
def test_sampler_matches_jax(method: str, score_clip) -> None:
    jmodel, variables, model = jax_and_port_models(MAX_LEN, N_CHANNELS)
    key = jax.random.PRNGKey(11)
    ref = jax_make_sample_fn(
        jmodel, JaxVP(fourier_noise_scaling=True), num_diffusion_steps=K,
        batch_size=BATCH, max_len=MAX_LEN, n_channels=N_CHANNELS, fused=True,
        method=method, score_clip=score_clip,
    )(variables, key)

    scheduler = VPScheduler(fourier_noise_scaling=True)
    z0, zs = _jax_noise(key)
    packed = pack_score_transformer(model)
    ours = reverse_diffusion(
        lambda x, t: fused_score_forward(model, packed, x, t), scheduler,
        scheduler.prior_sampling(SHAPE, z=z0), num_diffusion_steps=K,
        method=method, score_clip=score_clip, z=zs if method == "em" else None,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_fused_and_unfused_sample_fns_agree() -> None:
    _, _, model = jax_and_port_models(MAX_LEN, N_CHANNELS)
    scheduler = VPScheduler(fourier_noise_scaling=True)
    outs = [
        make_sample_fn(
            model, scheduler, num_diffusion_steps=3, batch_size=BATCH, max_len=MAX_LEN,
            n_channels=N_CHANNELS, fused=fused, device="cpu",
        )(torch.Generator().manual_seed(0))
        for fused in (True, False)
    ]
    torch.testing.assert_close(outs[0], outs[1], **TOL)


def test_diffusion_sampler_rounds_up_and_trims() -> None:
    _, _, model = jax_and_port_models(MAX_LEN, N_CHANNELS)
    sampler = DiffusionSampler(
        model, VPScheduler(), max_len=MAX_LEN, n_channels=N_CHANNELS,
        sample_batch_size=2, device="cpu",
    )
    out = sampler.sample(5, num_diffusion_steps=2, generator=torch.Generator().manual_seed(1))
    assert out.shape == (5, MAX_LEN, N_CHANNELS)
    assert torch.isfinite(out).all()


def test_reverse_diffusion_checks_arguments() -> None:
    scheduler = VPScheduler()
    x_T = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="method"):
        reverse_diffusion(lambda x, t: x, scheduler, x_T, num_diffusion_steps=2, method="heun")
    with pytest.raises(ValueError, match="z must be"):
        reverse_diffusion(lambda x, t: x, scheduler, x_T, num_diffusion_steps=2,
                          z=torch.zeros(3, *SHAPE))
