"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``).

Run by ``fourierdiffusion_tpu_torch.parallel.launch.run_ranks`` as
``python tests/_torch_parallel_worker.py <case> <out_dir> [arg]``: it joins
the gloo process group that the ``FDIFF_*`` variables describe, runs the
case through the port's data mesh and saves what it got to
``<out_dir>/rank<r>.pt`` for the test to compare with the one-process run,
which the test computes with the same functions of this module. It
imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from fourierdiffusion_tpu_torch.data import DummyDatamodule
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.parallel import distributed
from fourierdiffusion_tpu_torch.parallel.mesh import DataMesh, make_mesh
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer

BATCH, L, C = 8, 16, 2
FIT_EPOCHS = 3
PATHS = ("fused", "unfused", "mlp")
METHODS = ("em", "ode", "pc")
# K=25: VP's pc corrector needs K >= 21 (its 1 - beta dt is negative below).
# 12 chains in batches of 8: the last batch is rounded up and trimmed.
SAMPLE_STEPS, SAMPLE_CHAINS, SAMPLE_BATCH = 25, 12, 8
# These random weights end each chain with its largest |x| between 160 and
# 530: 300 flags some chains of every method and leaves others, so the guard
# redraws, and keeps some chains past it after its retries.
SAMPLE_THRESHOLD = 300.0
# The rollback guard needs 5 recorded epochs before it acts.
ROLLBACK_EPOCHS, SPIKE_EPOCH = 8, 6


def datamodule() -> DummyDatamodule:
    dm = DummyDatamodule(batch_size=BATCH, n_channels=C, max_len=L, standardize=True,
                         random_seed=0)
    dm.prepare_data()
    dm.setup()
    return dm


def model(path: str):
    kind = "mlp" if path == "mlp" else "transformer"
    return ScoreModelConfig(model_type=kind, d_model=8, num_layers=2, n_head=2,
                            dim_feedforward=16, d_mlp=16, dropout_rate=0.1).build(C, L, seed=0)


def fit(path: str, mesh: DataMesh | None) -> dict:
    """``Trainer.fit`` on the path's network (``FDIFF_FUSED_TRAIN`` set by
    the caller): the history, the weights and the EMA."""
    trainer = Trainer(model(path), VPScheduler(fourier_noise_scaling=False),
                      max_epochs=FIT_EPOCHS, ema_decay=0.999, seed=0, device="cpu", mesh=mesh)
    history = trainer.fit(datamodule())
    keys = ("train/loss", "val/loss", "step")
    return {"history": [{k: h[k] for k in keys} for h in history],
            "params": {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)},
            "ema": {n: e.clone() for n, e in trainer.ema.items()}}


class RankSpikyTrainer(Trainer):
    """Multiplies rank 1's train losses of epoch ``SPIKE_EPOCH`` by 100 the
    first time that epoch runs: rank 0 learns of the spike only through the
    reduced loss, and must roll back with rank 1."""

    def fit(self, datamodule, **kwargs):
        self._calls, self._spiked = 0, False
        self._steps = datamodule.steps_per_epoch
        return super().fit(datamodule, **kwargs)

    def train_step(self, x, t, z, layer_seeds=None, *, generator=None):
        loss = super().train_step(x, t, z, layer_seeds, generator=generator)
        epoch = self._calls // self._steps
        self._calls += 1
        if self.mesh.rank == 1 and epoch == SPIKE_EPOCH and not self._spiked:
            self._spiked = self._calls % self._steps == 0
            return loss * 100.0
        return loss


def rollback(mesh: DataMesh) -> dict:
    """A fit whose spike only rank 1 sees before the losses are reduced."""
    trainer = RankSpikyTrainer(model("fused"), VPScheduler(fourier_noise_scaling=False),
                               max_epochs=ROLLBACK_EPOCHS, seed=0, device="cpu", mesh=mesh)
    history = trainer.fit(datamodule())
    return {"salts": [h.get("stream_salt", 0) for h in history],
            "epochs": [h["epoch"] for h in history], "step": trainer.step,
            "params": {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)},
            "ema": {}}


def sample(mesh: DataMesh | None) -> dict:
    """Each method, the divergence guard on: the samples and the guard's
    counts."""
    net = model("fused")
    out = {}
    for seed, method in enumerate(METHODS):
        sampler = DiffusionSampler(
            net, VPScheduler(fourier_noise_scaling=False), max_len=L, n_channels=C,
            sample_batch_size=SAMPLE_BATCH, method=method, device="cpu", mesh=mesh,
            divergence_threshold=SAMPLE_THRESHOLD, max_resample_retries=2,
        )
        x = sampler.sample(SAMPLE_CHAINS, SAMPLE_STEPS, torch.Generator().manual_seed(seed))
        out[method] = {"samples": x, "stats": dict(sampler.last_resample_stats)}
    return out


def jax_step(npz: Path, mesh: DataMesh) -> dict:
    """The JAX trainer's data-parallel steps, from JAX's draws: each rank
    takes its rows, its seeds shifted to its first chain, all-reduces the
    gradients and steps."""
    data = np.load(npz)
    net = ScoreModelConfig(d_model=8, num_layers=2, n_head=2, dim_feedforward=16,
                           dropout_rate=0.3).build(C, int(data["x"].shape[2]))
    net.load_state_dict({k.removeprefix("w/"): torch.from_numpy(data[k])
                         for k in data.files if k.startswith("w/")})
    trainer = Trainer(net, VPScheduler(fourier_noise_scaling=True), lr_max=1e-3,
                      ema_decay=0.999, device="cpu", mesh=mesh)
    trainer.start(int(data["n_total"]))
    losses = []
    for x, t, z, seeds in zip(data["x"], data["t"], data["z"], data["seeds"]):
        rows = mesh.rows(len(x))
        x, t, z = (torch.from_numpy(a[rows]) for a in (x, t, z))
        seeds = [mesh.chain_seed(int(s), len(x)) for s in seeds]
        losses.append(trainer.train_step(x, t, z, seeds))
    loss = distributed.all_reduce_mean([torch.stack(losses).mean().reshape(1)])[0]
    return {"loss": loss.item(), "step": trainer.step,
            "params": {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)},
            "ema": dict(trainer.ema)}


def disagree(mesh: DataMesh) -> bool:
    """Whether ``assert_replicated_equal`` raises here, naming exactly the
    tensor that differs, when one tensor holds the rank's number."""
    same = torch.arange(6.0)
    distributed.assert_replicated_equal({"same": same})
    try:
        distributed.assert_replicated_equal({"same": same, "rank": same + mesh.rank})
    except AssertionError as e:
        return "['rank']" in str(e)
    return False


def main(case: str, out_dir: Path, arg: str | None) -> None:
    torch.set_num_threads(2)
    if not distributed.maybe_initialize_distributed(device="cpu"):
        raise RuntimeError("no process group in the environment")
    mesh = make_mesh()
    if case == "fit":
        result = fit(arg, mesh)
    elif case == "sample":
        result = sample(mesh)
    elif case == "jax_step":
        result = jax_step(Path(arg), mesh)
    elif case == "rollback":
        result = rollback(mesh)
    elif case == "disagree":
        result = {"raised": disagree(mesh)}
    else:
        raise ValueError(case)
    if case == "sample":
        distributed.assert_replicated_equal({m: r["samples"] for m, r in result.items()})
    elif case != "disagree":
        distributed.assert_replicated_equal(
            {f"{k}/{n}": v for k in ("params", "ema") for n, v in result[k].items()})
    torch.save({"world_size": mesh.world_size, **result}, out_dir / f"rank{mesh.rank}.pt")
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), sys.argv[3] if len(sys.argv) > 3 else None)
