"""``dryrun_multichip(n)``: the data-parallel training and sampling paths
at the flagship's shape on ``n`` ranks (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

Each rank is a process of its own (``parallel/launch.py``): gloo on the
CPU, or on the card(s) where ``device`` says so. Every rank builds the
flagship (L=187, 1 channel, d_model 72, 10 layers, 12 heads, FFN 2048)
from seed 0 and takes its rows of a batch of 2n: two training steps on the
unfused path (``FDIFF_FUSED_TRAIN=0``) and two on the fused path, then
``em`` (3 steps, the fused forward), ``ode`` (2, fused) and ``pc`` (2, the
module's forward), and ``chains`` chains (512, ``bench.py``'s sampling
batch, unless asked for fewer) split evenly (``em``, 2 steps). Every
result must be finite (``pc`` on random weights excepted: its Langevin
step scales with 1 / |score|^2, as in JAX) and every rank must hold the
same bits (``assert_replicated_equal``).

Run it as ``python -c "from fourierdiffusion_tpu_torch.parallel.dryrun import
dryrun_multichip; dryrun_multichip(2)"`` (CPU), or with ``device="cuda"``
(rank r on ``cuda:r``) or ``device="cuda:0", backend="gloo"`` (every rank
on one card).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from fourierdiffusion_tpu_torch.losses import draw_loss_noise
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.parallel.distributed import (
    all_reduce_mean,
    assert_replicated_equal,
    maybe_initialize_distributed,
)
from fourierdiffusion_tpu_torch.parallel.launch import run_ranks
from fourierdiffusion_tpu_torch.parallel.mesh import ShardedGenerator, make_mesh, shard_batch
from fourierdiffusion_tpu_torch.sampling.sampler import make_sample_fn
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer

MAX_LEN, N_CHANNELS = 187, 1
PROD_BATCH = 512  # bench.py's sampling batch
TRAIN_STEPS = 2  # step 0 has learning rate 0: the second moves the weights
SAMPLERS = (("em", 3, True), ("ode", 2, True), ("pc", 2, False))


def dryrun_multichip(n_devices: int, *, device: str = "cpu", backend: Optional[str] = None,
                     chains: int = PROD_BATCH, timeout: float = 900.0) -> list[str]:
    """Run the dry run on ``n_devices`` ranks; returns their outputs and
    raises ``RuntimeError`` where any rank fails."""
    argv = [sys.executable, "-m", "fourierdiffusion_tpu_torch.parallel.dryrun", device,
            str(chains), backend or ""]
    return run_ranks(argv, n_devices, timeout=timeout)


def _rank(device: str, chains: int, backend: Optional[str]) -> None:
    if not maybe_initialize_distributed(device=None if device == "cuda" else device,
                                        backend=backend):
        raise RuntimeError("no process group: run the dry run through dryrun_multichip")
    mesh = make_mesh()
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world_size))
    scheduler = VPScheduler(fourier_noise_scaling=True)
    batch = 2 * mesh.world_size
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, MAX_LEN, N_CHANNELS), generator=g, device=dev)
    x, t, z = (shard_batch(mesh, v) for v in (x, *draw_loss_noise(scheduler, x, g)))

    for fused in (False, True):
        path = "fused" if fused else "unfused"
        model = ScoreModelConfig().build(N_CHANNELS, MAX_LEN, seed=0)
        trainer = Trainer(model, scheduler, mesh=mesh)
        trainer.start(100)
        os.environ["FDIFF_FUSED_TRAIN"] = "1" if fused else "0"  # this process's path
        seeds = torch.Generator().manual_seed(2)
        stream = ShardedGenerator(torch.Generator(device=dev).manual_seed(2), mesh)
        for _ in range(TRAIN_STEPS):
            if fused:
                loss = trainer.train_step(x, t, z, trainer.draw_layer_seeds(seeds, len(x)))
            else:
                loss = trainer.train_step(x, t, z, generator=stream)
        loss = all_reduce_mean([loss.reshape(1)])[0]
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"{path} training step produced {loss.item()}")
        assert_replicated_equal({"loss": loss, **dict(model.named_parameters())},
                                f"{path} step")
        print(f"rank {mesh.rank}: {path} training, loss {loss.item():.6f}", flush=True)

    model.eval()
    runs = [(m, steps, f, batch) for m, steps, f in SAMPLERS] + [("em", 2, None, chains)]
    for seed, (method, steps, fused, n) in enumerate(runs, start=3):
        fn = make_sample_fn(model, scheduler, num_diffusion_steps=steps, batch_size=n,
                            max_len=MAX_LEN, n_channels=N_CHANNELS, fused=fused,
                            method=method, device=dev, mesh=mesh)
        out = fn(torch.Generator(device=dev).manual_seed(seed))
        what = f"{method} sampler, {n} chains ({len(range(n)[mesh.rows(n)])} " \
               "per rank)"
        if tuple(out.shape) != (n, MAX_LEN, N_CHANNELS):
            raise AssertionError(f"{what}: shape {tuple(out.shape)}")
        if method != "pc" and not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: not finite")
        assert_replicated_equal({"samples": out}, what)
        print(f"rank {mesh.rank}: {what} OK", flush=True)
    print(f"rank {mesh.rank}: dryrun_multichip OK", flush=True)


if __name__ == "__main__":
    _rank(sys.argv[1], int(sys.argv[2]), sys.argv[3] or None)
