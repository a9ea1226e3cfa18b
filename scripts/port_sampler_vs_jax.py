"""The port's sampler against the JAX package's on the trained flagship, on
the CPU, with the same noise.

Loads ``runs_reference/ref-freq42-e200/model.pt`` into both packages, runs
JAX's ``make_sample_fn`` (unfused, Euler-Maruyama, VP SDE with Fourier noise
scaling) from a key, re-derives the prior and per-step draws it took from
that key's splits, hands them to the port's ``reverse_diffusion`` with the
port's unfused module, and prints the largest difference of the final
samples and each chain's relative L2 distance. Both run fp32 on the CPU;
this script imports JAX, the port's package does not.

    JAX_PLATFORMS=cpu python3 scripts/port_sampler_vs_jax.py [--steps 1000] [--chains 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fourierdiffusion_tpu.models import ScoreModelConfig as JaxScoreModelConfig  # noqa: E402
from fourierdiffusion_tpu.sampling.sampler import make_sample_fn  # noqa: E402
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP  # noqa: E402
from fourierdiffusion_tpu.utils.torch_import import (  # noqa: E402
    _IMPORTERS,
    load_torch_state_dict,
)
from fourierdiffusion_tpu_torch.sampling import reverse_diffusion  # noqa: E402
from fourierdiffusion_tpu_torch.schedulers import VPScheduler  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=cs.SAMPLE_STEPS)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    shape = (args.chains, cs.MAX_LEN, cs.N_CHANNELS)
    variables = _IMPORTERS["transformer"](load_torch_state_dict(cs.WEIGHTS),
                                          num_layers=cs.N_LAYERS)
    jax_model = JaxScoreModelConfig(model_type="transformer", d_model=72,
                                    num_layers=cs.N_LAYERS, n_head=cs.N_HEAD).build(
        n_channels=cs.N_CHANNELS, max_len=cs.MAX_LEN)
    key = jax.random.PRNGKey(args.seed)
    t0 = time.perf_counter()
    ref = np.asarray(make_sample_fn(
        jax_model, JaxVP(fourier_noise_scaling=True), num_diffusion_steps=args.steps,
        batch_size=args.chains, max_len=cs.MAX_LEN, n_channels=cs.N_CHANNELS, fused=False,
    )(variables, key))
    jax_s = time.perf_counter() - t0
    prior_key, scan_key = jax.random.split(key)
    z0 = torch.from_numpy(np.array(jax.random.normal(prior_key, shape, jnp.float32)))
    zs = torch.from_numpy(np.array(jnp.stack(
        [jax.random.normal(k, shape, jnp.float32)
         for k in jax.random.split(scan_key, args.steps)])))
    scheduler = VPScheduler(fourier_noise_scaling=True)
    t0 = time.perf_counter()
    ours = reverse_diffusion(cs.load_flagship(torch.float32, "cpu"), scheduler,
                             scheduler.prior_sampling(shape, z=z0),
                             num_diffusion_steps=args.steps, z=zs).numpy()
    port_s = time.perf_counter() - t0
    diff = (ours - ref).reshape(args.chains, -1)
    print(json.dumps({
        "steps": args.steps, "chains": args.chains, "max_abs_diff": float(np.abs(diff).max()),
        "max_abs_sample": float(np.abs(ref).max()),
        "chain_rel_l2": (np.linalg.norm(diff, axis=1)
                         / np.linalg.norm(ref.reshape(args.chains, -1), axis=1)).tolist(),
        "jax_s": jax_s, "port_s": port_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
