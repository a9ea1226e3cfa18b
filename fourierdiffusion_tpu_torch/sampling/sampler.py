"""Reverse-diffusion sampler (port of ``fourierdiffusion_tpu/sampling/sampler.py``).

``reverse_diffusion`` is the low-level loop: it takes the prior ``x_T``
and the per-step standard-normal draws, ``z`` for the ``em``/``pc``
predictor and ``z_corr`` for the ``pc`` corrector (or a ``torch.Generator``
to draw them from), so a test can replay the noise JAX drew.
``make_sample_fn`` and ``DiffusionSampler`` draw them all from a generator.
Methods: ``em`` (Euler–Maruyama), ``ode`` (probability flow) and ``pc``
(the EM predictor, then ``corrector_steps`` of SNR-scaled Langevin MCMC at
each time). For a ``ScoreTransformer`` on CUDA the fused forward (one
kernel launch per encoder layer and score evaluation; B1, or the int8
kernels B7/B8 under ``FDIFF_FUSED_INT8``) is selected automatically, as
the JAX sampler selects its Pallas path on the TPU; a ``ScoreMLP`` or
``ScoreLSTM`` runs its own forward, as in JAX. ``DiffusionSampler``
has JAX's divergence guard (``divergence_threshold``). The K steps run as
a Python loop; capturing them in a CUDA graph is not ported yet.

With ``mesh=`` (``parallel/mesh.py``) the chains of each batch are split
over the ranks: each rank integrates its rows (one kernel launch per layer
and step at B/W chains), draws the prior and every step's noise at the
batch's shape and keeps its rows, takes the pc corrector's batch means
over the whole batch (one gather per corrector step), and the finished
batch is gathered onto every rank before the divergence guard, which thus
decides and redraws on every rank together (JAX's order).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from fourierdiffusion_tpu_torch import resolve_device
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.models.score_models import ScoreNetwork, ScoreTransformer
from fourierdiffusion_tpu_torch.parallel.distributed import gather_to_host
from fourierdiffusion_tpu_torch.parallel.mesh import (
    DataMesh,
    ShardedGenerator,
    Stream,
    batch_draw,
)
from fourierdiffusion_tpu_torch.schedulers.sde import SDE

METHODS = ("em", "ode", "pc")
ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
logger = logging.getLogger(__name__)


def _clip_score(
    scheduler: SDE, score: torch.Tensor, t: torch.Tensor, score_clip: Optional[float]
) -> torch.Tensor:
    """Clamp the score to ``+-score_clip / std(t)`` per frequency."""
    if score_clip is None:
        return score
    _, std = scheduler.marginal_prob(score[:1] * 0, t.reshape(1).to(score.dtype))
    bound = score_clip / torch.clamp(std[0], min=1e-6)  # (L,)
    return torch.clamp(score, -bound[:, None], bound[:, None])


def _normal(shape: tuple[int, ...], generator: Stream, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Standard normal of ``shape`` (from a ``ShardedGenerator``: at the
    global batch, cut to this rank's rows)."""
    return batch_draw(
        lambda n, g: torch.randn((n, *shape[1:]), generator=g, dtype=dtype, device=device),
        shape[0], generator,
    )


def _draw(like: torch.Tensor, generator: Stream) -> torch.Tensor:
    return _normal(tuple(like.shape), generator, like.dtype, like.device)


def _stream(generator: Optional[torch.Generator], mesh: Optional[DataMesh]) -> Stream:
    return generator if mesh is None else ShardedGenerator(generator, mesh)


def _batch_means(*per_chain: torch.Tensor, mesh: Optional[DataMesh]) -> list[torch.Tensor]:
    """The mean over the batch of each per-chain vector; under a mesh over
    the whole batch, from one gather of every rank's rows."""
    if mesh is None:
        return [v.mean() for v in per_chain]
    gathered = gather_to_host(torch.stack(per_chain, dim=1)).t().contiguous()
    return [row.mean() for row in gathered]


def langevin_correct(
    score_fn: ScoreFn, scheduler: SDE, x: torch.Tensor, t: torch.Tensor, step_size: float,
    *, corrector_steps: int, snr: float, score_clip: Optional[float] = None,
    z: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    mesh: Optional[DataMesh] = None,
) -> torch.Tensor:
    """SNR-scaled Langevin MCMC at the fixed time ``t`` (Song et al.'s PC
    corrector, JAX ``langevin_correct``): ``corrector_steps`` updates
    ``x + eps * grad + sqrt(2 eps) z`` with ``eps = 2 alpha (snr |z| /
    |grad|)**2``, norms averaged over the batch. ``z`` ``(corrector_steps,
    *x.shape)`` holds the draws; without it each update draws from
    ``generator``. Under a ``mesh`` ``x`` is this rank's rows of the batch."""
    t_vec = t.expand(x.shape[0]).to(x.dtype)
    alpha = scheduler.corrector_alpha(t, step_size)
    stream = _stream(generator, mesh)
    for i in range(corrector_steps):
        grad = _clip_score(scheduler, score_fn(x, t_vec), t, score_clip)
        zi = _draw(x, stream) if z is None else z[i]
        grad_norm, noise_norm = _batch_means(
            grad.flatten(1).norm(dim=-1), zi.flatten(1).norm(dim=-1), mesh=mesh)
        # The floor keeps a degenerate (all-zero) score from giving 0/0.
        grad_norm = torch.clamp_min(grad_norm, 1e-12)
        eps = 2.0 * alpha * (snr * noise_norm / grad_norm) ** 2
        x = x + eps * grad + torch.sqrt(2.0 * eps) * zi
    return x


@torch.no_grad()
def reverse_diffusion(
    score_fn: ScoreFn,
    scheduler: SDE,
    x_T: torch.Tensor,
    *,
    num_diffusion_steps: int,
    method: str = "em",
    score_clip: Optional[float] = None,
    corrector_steps: int = 1,
    snr: float = 0.16,
    z: Optional[torch.Tensor] = None,
    z_corr: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[DataMesh] = None,
) -> torch.Tensor:
    """Run the K reverse steps from ``x_T`` ``(B, L, C)``.

    ``z`` ``(K, B, L, C)`` holds the predictor noise of every ``em``/``pc``
    step and ``z_corr`` ``(K, corrector_steps, B, L, C)`` the ``pc``
    corrector's; what is not given is drawn from ``generator`` (each step's
    predictor draw, then its corrector draws). ``ode`` draws nothing. Under
    a ``mesh`` ``x_T`` (and ``z``) hold this rank's rows of the batch and
    the draws are made at the batch's shape.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown sampling method: {method!r}")
    if z is not None and tuple(z.shape) != (num_diffusion_steps, *x_T.shape):
        raise ValueError(f"z must be (K, *x_T.shape), got {tuple(z.shape)}")
    if z_corr is not None and tuple(z_corr.shape) != (
        num_diffusion_steps, corrector_steps, *x_T.shape
    ):
        raise ValueError(
            f"z_corr must be (K, corrector_steps, *x_T.shape), got {tuple(z_corr.shape)}"
        )
    timesteps = scheduler.timesteps(num_diffusion_steps, device=x_T.device)
    step_size = scheduler.step_size(num_diffusion_steps)
    stream = _stream(generator, mesh)
    x = x_T
    for i in range(num_diffusion_steps):
        t = timesteps[i]
        t_vec = t.expand(x.shape[0]).to(x.dtype)
        score = _clip_score(scheduler, score_fn(x, t_vec), t, score_clip)
        if method == "ode":
            x = scheduler.ode_step(score, t, x, step_size).prev_sample
            continue
        zi = _draw(x, stream) if z is None else z[i]
        x = scheduler.step(score, t, x, step_size, z=zi).prev_sample
        if method == "pc":
            x = langevin_correct(
                score_fn, scheduler, x, t, step_size, corrector_steps=corrector_steps,
                snr=snr, score_clip=score_clip, z=None if z_corr is None else z_corr[i],
                generator=generator, mesh=mesh,
            )
    return x


def _score_fn(model: ScoreNetwork, fused: bool) -> ScoreFn:
    if not fused:
        return model
    packed = pack_score_transformer(model)
    return lambda x, t: fused_score_forward(model, packed, x, t)


def make_sample_fn(
    model: ScoreNetwork,
    scheduler: SDE,
    *,
    num_diffusion_steps: int,
    batch_size: int,
    max_len: int,
    n_channels: int,
    fused: Optional[bool] = None,
    method: str = "em",
    corrector_steps: int = 1,
    snr: float = 0.16,
    score_clip: Optional[float] = None,
    device: str | torch.device = "cuda",
    mesh: Optional[DataMesh] = None,
) -> Callable[[torch.Generator], torch.Tensor]:
    """Return ``sample(generator) -> (batch_size, max_len, n_channels)``.

    The model must already live on ``device``. ``fused=None`` takes the
    fused forward for a ``ScoreTransformer`` on CUDA and the module's own
    forward elsewhere. The weights are packed at each call, so a changed
    model is picked up, and so is ``FDIFF_FUSED_INT8`` (the int8 kernels).
    Under a ``mesh`` each rank integrates its rows of the ``batch_size``
    chains, and every rank returns the whole batch.
    """
    dev = resolve_device(device)
    if method not in METHODS:
        raise ValueError(f"Unknown sampling method: {method!r}")
    if fused is None:
        fused = isinstance(model, ScoreTransformer) and dev.type == "cuda"
    if fused and not isinstance(model, ScoreTransformer):
        raise ValueError(f"fused sampling unsupported for {type(model).__name__}")
    rows = batch_size if mesh is None else batch_size // mesh.world_size
    if mesh is not None:
        mesh.rows(batch_size)  # raises where the batch does not divide
    shape = (rows, max_len, n_channels)

    def sample(generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            z = _normal(shape, _stream(generator, mesh), torch.float32, dev)
            x_T = scheduler.prior_sampling(shape, z=z)
            x = reverse_diffusion(
                _score_fn(model, fused), scheduler, x_T,
                num_diffusion_steps=num_diffusion_steps, method=method,
                score_clip=score_clip, corrector_steps=corrector_steps, snr=snr,
                generator=generator, mesh=mesh,
            )
            return x if mesh is None else gather_to_host(x)

    return sample


class DiffusionSampler:
    """Batched sampling; the number of batches rounds up and the output is
    trimmed to exactly ``num_samples``.

    Moves ``model`` to ``device`` and puts it in eval mode.

    ``divergence_threshold`` (off by default) is JAX's divergence guard:
    chains whose largest |x| passes it are redrawn. Each retry draws the
    whole batch again, from the caller's generator, and splices in only the
    flagged rows, at most ``max_resample_retries`` times; chains still past
    the threshold are kept, with a warning. ``last_resample_stats`` counts,
    per ``sample()`` call, the redraw slots used (``resampled_chains``; a
    chain retried twice counts twice), the chains kept past the threshold
    (``unresolved_chains``) and the whole-batch redraws (``redraws``).

    With a ``mesh`` the chains of each batch are split over the ranks and
    gathered before the guard (``make_sample_fn``); a batch that does not
    divide over them runs whole on every rank. The device defaults to the
    mesh's, else CUDA.
    """

    def __init__(
        self,
        model: ScoreNetwork,
        scheduler: SDE,
        *,
        max_len: int,
        n_channels: int,
        sample_batch_size: int = 200,
        method: str = "em",
        corrector_steps: int = 1,
        snr: float = 0.16,
        score_clip: Optional[float] = None,
        fused: Optional[bool] = None,
        divergence_threshold: Optional[float] = None,
        max_resample_retries: int = 2,
        device: str | torch.device | None = None,
        mesh: Optional[DataMesh] = None,
    ) -> None:
        self.device = mesh.place(device) if mesh is not None else resolve_device(device or "cuda")
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.scheduler = scheduler
        self.max_len = max_len
        self.n_channels = n_channels
        self.sample_batch_size = sample_batch_size
        self.method = method
        self.corrector_steps = corrector_steps
        self.snr = snr
        self.score_clip = score_clip
        self.fused = fused
        self.divergence_threshold = divergence_threshold
        self.max_resample_retries = max_resample_retries
        self.last_resample_stats = {"resampled_chains": 0, "unresolved_chains": 0, "redraws": 0}

    def sample(
        self,
        num_samples: int,
        num_diffusion_steps: int = 1000,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``num_samples`` series ``(num_samples, max_len, n_channels)``."""
        if generator is None:
            generator = torch.Generator(device=self.device)
        batch = min(self.sample_batch_size, num_samples)
        mesh = self.mesh
        if mesh is not None and batch % mesh.world_size:
            logger.warning("sample batch %d does not divide over %d ranks: every rank runs "
                           "the whole batch", batch, mesh.world_size)
            mesh = None
        fn = make_sample_fn(
            self.model, self.scheduler,
            num_diffusion_steps=num_diffusion_steps, batch_size=batch,
            max_len=self.max_len, n_channels=self.n_channels, fused=self.fused,
            method=self.method, corrector_steps=self.corrector_steps, snr=self.snr,
            score_clip=self.score_clip, device=self.device, mesh=mesh,
        )
        self.last_resample_stats = {"resampled_chains": 0, "unresolved_chains": 0, "redraws": 0}
        outs = []
        for _ in range(-(-num_samples // batch)):
            out = fn(generator)
            if self.divergence_threshold is not None:
                out = self._resample_divergent(lambda: fn(generator), out)
            outs.append(out)
        return torch.cat(outs, dim=0)[:num_samples]

    def _flagged(self, x: torch.Tensor) -> torch.Tensor:
        return x.abs().flatten(1).amax(dim=1) > float(self.divergence_threshold)

    def _resample_divergent(self, draw: Callable[[], torch.Tensor],
                            out: torch.Tensor) -> torch.Tensor:
        """Redraw the chains of ``out`` past the threshold (JAX
        ``_resample_divergent``): chains are i.i.d. across the batch, so the
        result is a draw conditioned on not diverging."""
        x = out.clone()
        flagged = self._flagged(x)
        retries = 0
        while bool(flagged.any()) and retries < self.max_resample_retries:
            retries += 1
            redraw = draw()
            x[flagged] = redraw[flagged]
            self.last_resample_stats["resampled_chains"] += int(flagged.sum())
            self.last_resample_stats["redraws"] += 1
            flagged = self._flagged(x)
        if bool(flagged.any()):
            logger.warning(
                "divergence guard: %d chains still past |x|>%g after %d retries",
                int(flagged.sum()), float(self.divergence_threshold), retries,
            )
            self.last_resample_stats["unresolved_chains"] += int(flagged.sum())
        return x


__all__ = ["DiffusionSampler", "langevin_correct", "make_sample_fn", "reverse_diffusion"]
