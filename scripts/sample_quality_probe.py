"""Where the port's samples of the trained flagship part from the reference's.

Samples ``runs_reference/ref-freq42-e200/model.pt`` (L=100, K=1000 Euler-
Maruyama steps, seed 42) on one CUDA card along several score paths,
batchings and compute dtypes, scores each as ``chip_smoke.py``'s phase 16 does (the
port's ``MetricCollection``: 1000 directions, baselines, spectral density,
against the synthetic training series of seed 42) and prints every gated
W2 mean beside ``results.yaml``'s (1000 samples of the reference's sampler)
and ``results_cross_our_sampler.yaml``'s (10,000 of the JAX package's), with
the count of chains whose largest |x| in time passes 2.5, 4 and 8, and the
largest. Before that it holds one score evaluation at batches of 32 and
1000 against the plain module on the CPU.

    python3 scripts/sample_quality_probe.py [--samples 1000] [--paths fused,unfused]
        [--dtypes float32,bfloat16] [--save DIR]

``--save`` writes each run's time-domain samples to ``DIR/<path>-<dtype>.npy``.

Paths: ``fused`` (B1 in every layer, one batch of all chains), ``fused-
b100`` (B1, batches of 100 chains), ``unfused`` (the module's own forward
on the card, whose attention runs B2, one batch). Prints one JSON object
last, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fourierdiffusion_tpu_torch.models.fused import (  # noqa: E402
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.ops import fourier  # noqa: E402
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler  # noqa: E402
from fourierdiffusion_tpu_torch.schedulers import VPScheduler  # noqa: E402

# (fused, chains per batch: None for QUALITY_BATCH)
PATHS = {"fused": (True, None), "fused-b100": (True, 100), "unfused": (False, None)}


def score_check(n: int) -> dict:
    """One score evaluation at batch ``n``: B1 and the module on the card
    against the module on the CPU (fp32), max |difference| and max |score|."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, cs.MAX_LEN, cs.N_CHANNELS, generator=g)
    t = torch.rand(n, generator=g) * 0.999 + 1e-3
    cpu = cs.load_flagship(torch.float32, "cpu")
    card = cs.load_flagship(torch.float32, "cuda")
    with torch.no_grad():
        plain = cpu(x, t)
        fused = fused_score_forward(card, pack_score_transformer(card), x.cuda(), t.cuda()).cpu()
        module = card(x.cuda(), t.cuda()).cpu()
    return {"max_abs_score": plain.abs().max().item(),
            "B1_vs_cpu": (fused - plain).abs().max().item(),
            "module_on_card_vs_cpu": (module - plain).abs().max().item()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=cs.QUALITY_SAMPLES)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--dtypes", default="float32")
    ap.add_argument("--save", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sample_quality_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": smi, "score_check": {str(b): score_check(b) for b in (32, cs.QUALITY_BATCH)}}
    print(json.dumps(out["score_check"]), flush=True)
    reference = cs.read_scalars(cs.REFERENCE_RESULTS)
    with tempfile.TemporaryDirectory() as root:
        dm = cs.synthetic_data(root)
        metrics = cs.quality_metrics(dm)
        mean, std = (t.cuda() for t in dm.feature_mean_and_std)
        for path, dtype in itertools.product(args.paths.split(","), args.dtypes.split(",")):
            fused, batch = PATHS[path]
            name = f"{path} {dtype}"
            sampler = DiffusionSampler(
                cs.load_flagship(getattr(torch, dtype), "cuda"),
                VPScheduler(fourier_noise_scaling=True), max_len=cs.MAX_LEN,
                n_channels=cs.N_CHANNELS, sample_batch_size=batch or cs.QUALITY_BATCH,
                method="em", fused=fused, device="cuda")
            g = torch.Generator(device="cuda").manual_seed(cs.QUALITY_SEED)
            t0 = time.perf_counter()
            x = sampler.sample(args.samples, num_diffusion_steps=cs.SAMPLE_STEPS, generator=g)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            series = fourier.idft(x.float() * std + mean)
            absmax = series.abs().flatten(1).amax(1)
            if args.save is not None:
                args.save.mkdir(parents=True, exist_ok=True)
                np.save(args.save / f"{path}-{dtype}.npy", series.cpu().numpy())
            results = metrics(series)
            out[name] = {"seconds": seconds,
                         **{k: results[k] for k in cs.QUALITY_KEYS},
                         "spectral_marginal_wasserstein_mean":
                             results["spectral_marginal_wasserstein_mean"],
                         **{f"chains_absmax_above_{c}": int((absmax > c).sum())
                            for c in (2.5, 4, 8)},
                         "max_absmax": absmax.max().item(),
                         "model_space_max_absmax": x.abs().max().item()}
            print(f"{name}: {json.dumps(out[name])}", flush=True)
    cross = cs.read_scalars(cs.CROSS_RESULTS)
    out["results.yaml"] = {k: reference[k] for k in cs.QUALITY_KEYS}
    out["results_cross_our_sampler.yaml"] = {k: cross[k] for k in cs.QUALITY_KEYS}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
