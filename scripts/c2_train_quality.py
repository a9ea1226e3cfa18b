#!/usr/bin/env python3
"""Train the flagship to 600 epochs with the port on the card and hold its
loss and sample quality to the JAX package's runs of the same configuration.

Two runs, each through the port's entry points (``fdiff-torch-train``'s
``TrainingRunner``, resumed from the run directory's own
``train_config.yaml``, and ``fdiff-torch-sample``'s ``SamplingRunner``):

* ``fp32``: ``runs/4ffeaa7e/train_config.yaml`` (d_model 72, 10 layers, 12
  heads, dropout 0.1, sine, L=100, 600 epochs of 16 steps), sampled with
  ``runs/193c5e46/sample_config.yaml`` (1000 samples, K=1000, em, seed 42,
  checkpoint ``best``);
* ``bf16``: ``runs/94c6eb87/train_config.yaml``, sampled with
  ``runs/94c6eb87/sample_config.yaml``.

Only ``run_dir``, ``datamodule.data_dir`` (the synthetic set is made from
the seed into it), ``model_path`` and ``model_id`` are changed. The card's
copy of the repository holds no ``runs/``, so the configurations and the
JAX numbers travel in ``scripts/c2_reference.json``, which
``--write-reference`` makes from the ``runs/`` files and
``tests/test_torch_c2_quality.py`` holds equal to them:

* the band of the mean ``val/loss`` of the last 10 epochs over the six fp32
  runs of the flagship's training configuration (``FP32_RUNS``), and their
  values at epoch 100; the bf16 run's own;
* the four W2 means of ``results.yaml`` and their ``_dummy`` values of the
  JAX runs sampled with those configurations (``193c5e46`` and
  ``71a51d58`` in fp32, both trained with 6 heads; ``94c6eb87`` in bf16).

Limits (``check``): the port's last-10 mean in [LOSS_LOW, LOSS_HIGH] (the
fp32 band widened by 10 %, for both runs); each W2 mean at most W2_FACTOR
times the JAX run's (``193c5e46`` for fp32, ``94c6eb87`` for bf16) and
below its ``_dummy``. The value at epoch 100 is reported, not gated.

One JSON line per run: the readings beside the JAX numbers, the seconds of
training, validation and sampling, and the card's name and power limit.
The exit code is 1 when a run misses a limit.

On the card, from the repository root (a run takes about a quarter of an
hour; a run directory under ``--work`` that holds ``checkpoints/last``
is resumed from it, so a run can be split over calls)::

    python3 scripts/c2_train_quality.py --runs fp32 bf16

The run directories go to ``--work`` (default ``c2_runs/``, gitignored: the
checkpoints are large); each run's ``metrics.jsonl``, configs and
``results.yaml`` are copied to ``--out`` (default ``chiprun_out/c2``).

A rehearsal on the CPU at a tiny size (no limit holds there)::

    python3 scripts/c2_train_quality.py --runs fp32 --device cpu --work /tmp/c2 \\
        --set trainer.max_epochs=2 score_model.d_model=16 score_model.num_layers=1 \\
        score_model.n_head=2 --sample-set num_samples=16 num_diffusion_steps=3
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

REFERENCE = REPO / "scripts" / "c2_reference.json"
FP32_RUNS = ("11865b05", "193c5e46", "4ffeaa7e", "71a51d58", "73b82ae8", "cbcc1bbe")
BF16_RUN = "94c6eb87"
#: name: (training config's run, sampling config's run, JAX run gated against, others shown)
RUNS = {"fp32": ("4ffeaa7e", "193c5e46", "193c5e46", ("71a51d58",)),
        "bf16": (BF16_RUN, BF16_RUN, BF16_RUN, ())}
SAMPLED_RUNS = ("193c5e46", "71a51d58", BF16_RUN)
LAST_EPOCHS = 10
EPOCH_SHOWN = 100
LOSS_LOW, LOSS_HIGH = 2.80e-4, 3.59e-4
W2_FACTOR = 1.5
W2_KEYS = tuple(f"{d}_{m}_wasserstein_mean" for d in ("time", "freq")
                for m in ("marginal", "sliced"))


# ---- the JAX runs' numbers ---------------------------------------------------------


def epoch_losses(metrics_jsonl: Path) -> dict[int, float]:
    """``val/loss`` by epoch of a ``metrics.jsonl`` (the last record of an
    epoch, so a rolled-back epoch counts as it was retrained)."""
    out = {}
    for line in metrics_jsonl.read_text().splitlines():
        rec = json.loads(line)
        if "val/loss" in rec:
            out[int(rec["epoch"])] = float(rec["val/loss"])
    return out


def loss_summary(losses: dict[int, float]) -> dict:
    """The mean of the last LAST_EPOCHS epochs' ``val/loss`` and the value
    at EPOCH_SHOWN (None where the run is shorter)."""
    last = max(losses)
    tail = [losses[e] for e in range(max(0, last - LAST_EPOCHS + 1), last + 1)]
    return {"epochs": last + 1, "last10_mean": sum(tail) / len(tail),
            "epoch100": losses.get(EPOCH_SHOWN)}


def read_scalars(path: Path) -> dict[str, float]:
    """The top-level ``key: number`` lines of a ``results.yaml`` (its lists
    and maps are skipped)."""
    out = {}
    for line in path.read_text().splitlines():
        m = re.fullmatch(r"([a-z_0-9]+): (-?[0-9.]+(?:e[-+]?[0-9]+)?)", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def w2_of(scalars: dict[str, float]) -> dict:
    return {k: {"mean": scalars[k], "dummy": scalars[k + "_dummy"]} for k in W2_KEYS}


def reference_from_runs(runs: Path) -> dict:
    """What ``scripts/c2_reference.json`` holds, computed from ``runs``."""
    losses = {r: loss_summary(epoch_losses(runs / r / "metrics.jsonl"))
              for r in (*FP32_RUNS, BF16_RUN)}
    fp32 = [losses[r] for r in FP32_RUNS]
    configs = {name: {"train": (runs / tr / "train_config.yaml").read_text(),
                      "sample": (runs / sr / "sample_config.yaml").read_text()}
               for name, (tr, sr, _, _) in RUNS.items()}
    return {
        "losses": losses,
        "fp32_band": [min(x["last10_mean"] for x in fp32), max(x["last10_mean"] for x in fp32)],
        "fp32_epoch100_band": [min(x["epoch100"] for x in fp32),
                               max(x["epoch100"] for x in fp32)],
        "w2": {r: w2_of(read_scalars(runs / r / "results.yaml")) for r in SAMPLED_RUNS},
        "configs": configs,
    }


def load_reference() -> dict:
    return json.loads(REFERENCE.read_text())


# ---- the limits --------------------------------------------------------------------


def check(name: str, losses: dict, w2: dict, ref: dict) -> list[str]:
    """The limits a port run ``name`` misses (empty: it holds them all):
    ``losses`` as ``loss_summary`` gives them, ``w2`` the four means by key."""
    missed = []
    m = losses["last10_mean"]
    if not LOSS_LOW <= m <= LOSS_HIGH:
        missed.append(f"last-10 mean val/loss {m:.4e} outside [{LOSS_LOW:.2e}, {LOSS_HIGH:.2e}]")
    jax = ref["w2"][RUNS[name][2]]
    for k in W2_KEYS:
        got, base, dummy = w2[k], jax[k]["mean"], jax[k]["dummy"]
        if not got <= W2_FACTOR * base:
            missed.append(f"{k} {got:.4f} above {W2_FACTOR} x {base:.4f}")
        if not got < dummy:
            missed.append(f"{k} {got:.4f} not below _dummy {dummy:.4f}")
    return missed


def report(name: str, losses: dict, w2: dict, ref: dict, seconds: dict, card: str) -> dict:
    """One run's JSON line: its readings beside the JAX numbers."""
    gated = RUNS[name][2]
    jax = {r: ref["w2"][r] for r in (gated, *RUNS[name][3])}
    return {
        "run": name,
        "config": RUNS[name][0],
        "card": card,
        "epochs": losses["epochs"],
        "last10_mean_val_loss": losses["last10_mean"],
        "jax_fp32_band": ref["fp32_band"],
        "jax_bf16_last10": ref["losses"][BF16_RUN]["last10_mean"],
        "limits": [LOSS_LOW, LOSS_HIGH],
        "epoch100_val_loss": losses["epoch100"],
        "jax_fp32_epoch100_band": ref["fp32_epoch100_band"],
        "jax_bf16_epoch100": ref["losses"][BF16_RUN]["epoch100"],
        "w2": {k: {"port": w2[k], **{f"jax_{r}": v[k]["mean"] for r, v in jax.items()},
                   "ratio": w2[k] / jax[gated][k]["mean"], "dummy": jax[gated][k]["dummy"]}
               for k in W2_KEYS},
        "seconds": seconds,
        "missed": check(name, losses, w2, ref),
    }


# ---- the run on the card -----------------------------------------------------------


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card (empty off a card)."""
    if shutil.which("nvidia-smi") is None:
        return ""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def parse_sets(items: list[str]) -> list[tuple[str, object]]:
    from fourierdiffusion_tpu_torch.utils.config import parse_override_value

    return [(k, parse_override_value(v)) for k, v in (s.split("=", 1) for s in items)]


def set_dotted(cfg: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for key in path:
        cfg = cfg.setdefault(key, {})
    cfg[last] = value


def train(name: str, ref: dict, work: Path, device: str, sets: list) -> tuple[dict, dict]:
    """Train run ``name`` in ``work/runs/c2-<name>`` (resumed from its
    ``last`` where one is there): its ``val/loss`` by epoch and the seconds
    of this call's training and validation."""
    from fourierdiffusion_tpu_torch.cli.train import TrainingRunner, init_distributed
    from fourierdiffusion_tpu_torch.utils import yamlio
    from fourierdiffusion_tpu_torch.utils.config import load_config, save_config

    run_id = f"c2-{name}"
    run_dir = work / "runs" / run_id
    run_dir.mkdir(parents=True, exist_ok=True)
    config = run_dir / "train_config.yaml"
    if not config.exists():
        cfg = yamlio.loads(ref["configs"][name]["train"])
        cfg["run_dir"] = str(work / "runs")
        cfg["datamodule"]["data_dir"] = str(work / "data")
        cfg["device"] = device
        for key, value in sets:
            set_dotted(cfg, key, value)
        save_config(cfg, config)
    # fdiff-torch-train resume=<run_id> run_dir=<work/runs>, keeping the history
    cfg = load_config(config)
    init_distributed(cfg)
    runner = TrainingRunner(cfg, run_id=run_id)
    last = runner.run_dir / "checkpoints" / "last"
    history = runner.train(resume_from=last if last.exists() else None)
    seconds = {"train": sum(h["train_seconds"] for h in history),
               "validation": sum(h["val_seconds"] for h in history),
               "epochs_this_call": len(history)}
    return epoch_losses(run_dir / "metrics.jsonl"), seconds


def sample(name: str, ref: dict, work: Path, device: str, sets: list) -> tuple[dict, float]:
    """``fdiff-torch-sample`` of run ``name`` with its sampling config:
    the four W2 means of the ``results.yaml`` it writes, and its seconds."""
    from fourierdiffusion_tpu_torch.cli.sample import SamplingRunner
    from fourierdiffusion_tpu_torch.utils import yamlio

    cfg = yamlio.loads(ref["configs"][name]["sample"])
    cfg["model_path"] = str(work / "runs")
    cfg["model_id"] = f"c2-{name}"
    cfg["device"] = device
    for key, value in sets:
        set_dotted(cfg, key, value)
    t0 = time.perf_counter()
    SamplingRunner(cfg).sample()
    seconds = time.perf_counter() - t0
    scalars = read_scalars(work / "runs" / cfg["model_id"] / "results.yaml")
    return {k: scalars[k] for k in W2_KEYS}, seconds


def build_libraries() -> None:
    """The kernels the runs take (B1, B2, B3/B4 in fp32 and bf16), one
    ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fourierdiffusion_tpu_torch.ops import _build

    names = ("fused_encoder", "flash_attention", "fused_encoder_train",
             "fused_encoder_train_bf16")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))


KEPT = ("metrics.jsonl", "train_config.yaml", "sample_config.yaml", "results.yaml")


def keep(name: str, work: Path, out: Path) -> None:
    """Copy run ``name``'s small files from ``work`` to ``out/<name>``."""
    src, dst = work / "runs" / f"c2-{name}", out / name
    dst.mkdir(parents=True, exist_ok=True)
    for f in KEPT:
        if (src / f).exists():
            shutil.copy2(src / f, dst / f)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", choices=sorted(RUNS), default=["fp32", "bf16"])
    ap.add_argument("--work", type=Path, default=REPO / "c2_runs")
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "c2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], help="training config key=value (rehearsal)")
    ap.add_argument("--sample-set", nargs="*", default=[],
                    help="sampling config key=value (rehearsal)")
    ap.add_argument("--write-reference", action="store_true",
                    help="write scripts/c2_reference.json from runs/ and exit")
    args = ap.parse_args(argv)
    if args.write_reference:
        REFERENCE.write_text(json.dumps(reference_from_runs(REPO / "runs"), indent=1) + "\n")
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("c2_train_quality: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = load_reference()
    if args.device == "cuda":
        t0 = time.perf_counter()
        build_libraries()
        print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    card = card_name()
    print(card, flush=True)
    failed = False
    for name in args.runs:
        losses, seconds = train(name, ref, args.work, args.device, parse_sets(args.set))
        w2, seconds["sampling"] = sample(name, ref, args.work, args.device,
                                         parse_sets(args.sample_set))
        line = report(name, loss_summary(losses), w2, ref, seconds, card)
        failed |= bool(line["missed"])
        keep(name, args.work, args.out)
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
