"""Compares two draws of time-domain samples of the flagship by the port's
metrics, on the CPU, to tell the bulk of a distribution from its rare
far chains.

For each ``.npy`` file of ``(n, L, C)`` samples: the four W2 means that
``chip_smoke.py``'s phase 16 gates and the spectral one (against the
synthetic training series of seed 42, 1000 directions, seed 42), for all
samples and for the samples without the chains whose largest |x| passes
``--far``; the count of such chains; and, over ``--subsets`` random subsets
of 1000 samples (seed 0), the mean, standard deviation and range of each
mean, as ``results.yaml``'s 1000-sample protocol reads them.

    python3 scripts/sample_quality_compare.py A.npy B.npy [--far 4] [--subsets 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fourierdiffusion_tpu_torch.sampling import MetricCollection  # noqa: E402

KEYS = cs.QUALITY_KEYS + ("spectral_marginal_wasserstein_mean",)


def means(metrics: MetricCollection, x: np.ndarray) -> dict[str, float]:
    results = metrics(x)
    return {k: results[k] for k in KEYS}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", type=Path, nargs="+")
    ap.add_argument("--far", type=float, default=4.0)
    ap.add_argument("--subsets", type=int, default=20)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as root:
        metrics = cs.quality_metrics(cs.synthetic_data(root), "cpu")
    out = {}
    for path in args.files:
        x = np.load(path)
        absmax = np.abs(x).reshape(len(x), -1).max(1)
        far = absmax > args.far
        rng = np.random.default_rng(0)
        subsets = [means(metrics, x[rng.choice(len(x), 1000, replace=False)])
                   for _ in range(args.subsets)]
        out[path.name] = {
            "n": len(x), f"chains_above_{args.far:g}": int(far.sum()),
            "max_absmax": float(absmax.max()),
            "all": means(metrics, x),
            f"without_chains_above_{args.far:g}": means(metrics, x[~far]),
            "subsets_of_1000": {k: {"mean": float(np.mean(v)), "sd": float(np.std(v)),
                                    "min": float(np.min(v)), "max": float(np.max(v))}
                                for k in KEYS for v in [[s[k] for s in subsets]]},
        }
        print(f"{path.name}: {json.dumps(out[path.name])}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
