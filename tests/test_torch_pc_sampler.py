"""Port parity: the predictor-corrector sampler, ``corrector_alpha`` and the
divergence guard of ``fourierdiffusion_tpu_torch.sampling`` against JAX, on
the CPU.

``jax.random`` and torch draw different numbers, so the test re-derives the
noise JAX drew from its own key splits and hands it to
``reverse_diffusion``: the prior from ``split(key)[0]``; per step
``pred_key, corr_key = split(step_key)``, the predictor draw from
``pred_key`` and corrector draw i from ``fold_in(corr_key, i)``.

The VP runs take K=25: the corrector's step scale is VP's
``alpha = 1 - beta(t) dt``, which is negative at t=1 below K=21 (-4 at
K=5), and then ``sqrt(2 eps)`` is NaN in JAX and in the port alike. The VE
scheduler (alpha 1) runs at K=5.

Tolerances: the VP samples, 1e-4 absolute and relative in fp32, as the
``em`` sampler's test (``tests/test_torch_sampler.py``): per-step
differences of ~1e-6 from other summation orders grow where the score is
scaled by 1/std(t) near t = eps. The VE samples, 5e-3 absolute and 1e-4
relative: VE's prior is 50 x N(0, I) (sigma_max), so the same relative
differences are 50 times VP's in absolute terms. ``corrector_alpha``, 1e-6
(one fp32 formula in two libraries).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models

from fourierdiffusion_tpu import schedulers as jax_sched
from fourierdiffusion_tpu.sampling.sampler import make_sample_fn as jax_make_sample_fn
from fourierdiffusion_tpu_torch import schedulers as sched
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.sampling import (
    DiffusionSampler,
    make_sample_fn,
    reverse_diffusion,
)

BATCH, MAX_LEN, N_CHANNELS = 3, 19, 1
SHAPE = (BATCH, MAX_LEN, N_CHANNELS)
# JAX scheduler, port scheduler, K, tolerance.
SCHEDULERS = {"vp": (jax_sched.VPScheduler, sched.VPScheduler, 25, dict(atol=1e-4, rtol=1e-4)),
              "ve": (jax_sched.VEScheduler, sched.VEScheduler, 5, dict(atol=5e-3, rtol=1e-4))}
# (fused, corrector_steps, score_clip): each value of each, fused and not.
CASES = [(True, 1, None), (True, 2, 2.0), (False, 2, None), (False, 1, 2.0)]


def _jax_pc_noise(key, corrector_steps: int, K: int):
    """The prior, predictor and corrector draws of JAX's pc ``sample``."""
    prior_key, scan_key = jax.random.split(key)
    z0 = jax.random.normal(prior_key, SHAPE, jnp.float32)
    zs, zc = [], []
    for step_key in jax.random.split(scan_key, K):
        pred_key, corr_key = jax.random.split(step_key)
        zs.append(jax.random.normal(pred_key, SHAPE, jnp.float32))
        zc.append([jax.random.normal(jax.random.fold_in(corr_key, i), SHAPE, jnp.float32)
                   for i in range(corrector_steps)])
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return as_t(z0), as_t(jnp.stack(zs)), as_t(jnp.stack([jnp.stack(c) for c in zc]))


@pytest.mark.parametrize("fused,corrector_steps,score_clip", CASES)
@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_pc_matches_jax(kind: str, fused: bool, corrector_steps: int, score_clip) -> None:
    jax_cls, cls, K, tol = SCHEDULERS[kind]
    jmodel, variables, model = jax_and_port_models(MAX_LEN, N_CHANNELS)
    key = jax.random.PRNGKey(13)
    ref = jax_make_sample_fn(
        jmodel, jax_cls(fourier_noise_scaling=True), num_diffusion_steps=K,
        batch_size=BATCH, max_len=MAX_LEN, n_channels=N_CHANNELS, fused=fused, method="pc",
        corrector_steps=corrector_steps, snr=0.16, score_clip=score_clip,
    )(variables, key)

    scheduler = cls(fourier_noise_scaling=True)
    z0, zs, zc = _jax_pc_noise(key, corrector_steps, K)
    if fused:
        packed = pack_score_transformer(model)
        score_fn = lambda x, t: fused_score_forward(model, packed, x, t)  # noqa: E731
    else:
        score_fn = model
    ours = reverse_diffusion(
        score_fn, scheduler, scheduler.prior_sampling(SHAPE, z=z0), num_diffusion_steps=K,
        method="pc", corrector_steps=corrector_steps, snr=0.16, score_clip=score_clip,
        z=zs, z_corr=zc,
    )
    assert np.isfinite(ours.numpy()).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_corrector_alpha_matches_jax(kind: str) -> None:
    ours, theirs = {"vp": (sched.VPScheduler(), jax_sched.VPScheduler()),
                    "ve": (sched.VEScheduler(), jax_sched.VEScheduler())}[kind]
    step_size = ours.step_size(250)
    for t in (1.0, 0.5, 1e-5):
        got = ours.corrector_alpha(torch.tensor(t), step_size)
        want = theirs.corrector_alpha(jnp.float32(t), step_size)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_pc_draws_from_generator_and_checks_shapes() -> None:
    _, _, model = jax_and_port_models(MAX_LEN, N_CHANNELS)
    scheduler = sched.VEScheduler(fourier_noise_scaling=True)
    outs = [
        make_sample_fn(
            model, scheduler, num_diffusion_steps=3, batch_size=BATCH, max_len=MAX_LEN,
            n_channels=N_CHANNELS, method="pc", corrector_steps=2, device="cpu",
        )(torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    torch.testing.assert_close(outs[0], outs[1], atol=0.0, rtol=0.0)
    assert torch.isfinite(outs[0]).all()
    with pytest.raises(ValueError, match="z_corr must be"):
        reverse_diffusion(lambda x, t: -x, scheduler, torch.zeros(SHAPE), num_diffusion_steps=2,
                          method="pc", corrector_steps=2, z_corr=torch.zeros(2, 1, *SHAPE))


GUARD_STEPS = 10


class _Diverging(torch.nn.Module):
    """A score network that sends the chains listed for each draw (a draw is
    ``k`` calls) far past any threshold; for every other chain it is the
    score of the VP prior N(0, I), so over ``GUARD_STEPS`` steps those
    chains stay near unit scale, far below the threshold of 8."""

    def __init__(self, bad: list[list[int]], k: int) -> None:
        super().__init__()
        self.bad, self.k, self.calls = bad, k, 0

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        draw = min(self.calls // self.k, len(self.bad) - 1)
        self.calls += 1
        score = -x
        score[self.bad[draw]] = 1e6
        return score


def _draws(bad: list[list[int]], n: int, seed: int) -> list[torch.Tensor]:
    """The first ``n`` batch draws of an unguarded sampler with that score."""
    sampler = DiffusionSampler(_Diverging(bad, GUARD_STEPS), sched.VPScheduler(),
                               max_len=MAX_LEN, n_channels=N_CHANNELS, sample_batch_size=4,
                               device="cpu")
    g = torch.Generator().manual_seed(seed)
    return [sampler.sample(4, num_diffusion_steps=GUARD_STEPS, generator=g) for _ in range(n)]


def test_divergence_guard_splices_and_counts(caplog) -> None:
    bad = [[1, 3], [0, 3], [3]]  # draw 0 flags 1 and 3; retry 1 fixes 1; retry 2 not 3
    first, retry1, retry2 = _draws(bad, 3, seed=5)
    sampler = DiffusionSampler(
        _Diverging(bad, GUARD_STEPS), sched.VPScheduler(), max_len=MAX_LEN,
        n_channels=N_CHANNELS, sample_batch_size=4, divergence_threshold=8.0,
        max_resample_retries=2, device="cpu",
    )
    with caplog.at_level(logging.WARNING):
        out = sampler.sample(4, num_diffusion_steps=GUARD_STEPS,
                             generator=torch.Generator().manual_seed(5))
    assert sampler.last_resample_stats == {"resampled_chains": 3, "unresolved_chains": 1,
                                           "redraws": 2}
    assert "divergence guard: 1 chains still past" in caplog.text
    torch.testing.assert_close(out[[0, 2]], first[[0, 2]], atol=0.0, rtol=0.0)  # unflagged
    torch.testing.assert_close(out[1], retry1[1], atol=0.0, rtol=0.0)  # spliced in
    torch.testing.assert_close(out[3], retry2[3], atol=0.0, rtol=0.0)  # kept, unresolved
    assert out[3].abs().max() > 8.0 and out[[0, 1, 2]].abs().max() <= 8.0


def test_divergence_guard_off_and_clean_batches() -> None:
    bad = [[2], []]
    plain = DiffusionSampler(_Diverging(bad, GUARD_STEPS), sched.VPScheduler(),
                             max_len=MAX_LEN, n_channels=N_CHANNELS, sample_batch_size=4,
                             device="cpu")
    out = plain.sample(4, num_diffusion_steps=GUARD_STEPS, generator=torch.Generator().manual_seed(6))
    assert out[2].abs().max() > 8.0  # off by default: nothing is redrawn
    assert plain.last_resample_stats == {"resampled_chains": 0, "unresolved_chains": 0,
                                         "redraws": 0}
    guarded = DiffusionSampler(
        _Diverging(bad, GUARD_STEPS), sched.VPScheduler(), max_len=MAX_LEN,
        n_channels=N_CHANNELS, sample_batch_size=4, divergence_threshold=8.0, device="cpu",
    )
    out = guarded.sample(4, num_diffusion_steps=GUARD_STEPS, generator=torch.Generator().manual_seed(6))
    assert guarded.last_resample_stats == {"resampled_chains": 1, "unresolved_chains": 0,
                                           "redraws": 1}
    assert out.abs().max() <= 8.0
