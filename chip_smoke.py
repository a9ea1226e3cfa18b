#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``fourierdiffusion_tpu_torch``)
on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed with its seconds as it ends:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: ``csrc/fused_encoder.cu`` with nvcc (reused when already built).
3. kernel: the trained flagship's layer 0 at L=100, fp32 and bf16, at
   batch 64 and at the main path's batch of 32: the kernel against its
   plain PyTorch version on the card, and the times of the kernel, the
   plain version and one eval-mode ``nn.TransformerEncoderLayer`` call on
   the same weights (a yardstick the port never calls).
4. main path: ``DiffusionSampler`` (Euler-Maruyama, VP SDE with Fourier
   noise scaling, K=1000) on the trained ``ref-freq42-e200`` weights,
   32 chains, in fp32 and then in bf16 compute. Every layer of every step
   must go through the kernel: the launch count must be K x 10.
5. trajectory: K=20, 8 chains, fp32, one prior and one set of per-step
   draws, through the kernel and through the unfused module.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero; it exits
non-zero too when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from fourierdiffusion_tpu_torch.models import ScoreModelConfig, ScoreTransformer
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.ops import _build, fourier
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler, reverse_diffusion
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.utils.weights import load_reference_state_dict

REPO = Path(__file__).resolve().parent
WEIGHTS = REPO / "runs_reference" / "ref-freq42-e200" / "model.pt"
MAX_LEN, N_CHANNELS, N_LAYERS, N_HEAD = 100, 1, 10, 12
SAMPLE_CHAINS, SAMPLE_STEPS = 32, 1000
KERNEL_BATCHES = (64, SAMPLE_CHAINS)
TRAJ_CHAINS, TRAJ_STEPS = 8, 20

# Kernel against its plain version, max abs error over the layer output
# (|y| < 8 after LayerNorm at these weights).
# fp32: both accumulate in fp32, in other orders; sums of up to 2048 terms
# differ by a few ulps of fp32, far below 1e-4.
# bf16: both round at the same points, but a different fp32 sum order can
# flip one rounding of an intermediate, which moves an output by at most
# about one bf16 ulp: 2**-4 is two ulps at |y| in [4, 8).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-4}
# Kernel path against the unfused module over 20 fp32 reverse steps:
# per-step differences of ~1e-6 grow through the score near t = eps.
TRAJ_TOL = 1e-3

# H100 SXM data sheet, dense, at 700 W: fp32 on the CUDA cores (the kernel
# does not use the tensor cores yet) and bf16 on the tensor cores, HBM3.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
REPLACES = "fourierdiffusion_tpu/ops/fused_encoder.py:172"
SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder.cu"


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def load_flagship(dtype: torch.dtype, device: str) -> ScoreTransformer:
    cfg = ScoreModelConfig(
        d_model=72, num_layers=N_LAYERS, n_head=N_HEAD, dim_feedforward=2048,
        dtype=str(dtype).removeprefix("torch."),
    )
    model = cfg.build(n_channels=N_CHANNELS, max_len=MAX_LEN)
    return load_reference_state_dict(model, WEIGHTS).to(device).eval()


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_bound_ms(b: int, l: int, d: int, d_ff: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one layer call: its operations over the peak rate for
    the input dtype, or its bytes (x in, y out, weights and fp32 vectors
    read once) over the memory rate, whichever is larger."""
    flops = 2 * b * l * (3 * d * d + d * d + 2 * d * d_ff) + 2 * 2 * b * l * l * d
    size = torch.finfo(dtype).bits // 8
    weights = (3 * d * d + d * d + 2 * d * d_ff) * size
    vectors = (3 * d + d + 4 * d + d_ff + d) * 4
    bytes_ = 2 * b * l * d * size + weights + vectors
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_kernel(model: ScoreTransformer, dtype: torch.dtype, batch: int) -> dict:
    layer0 = model.backbone.layers[0]
    packed = fe.pack_encoder_layer(layer0, N_HEAD, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, MAX_LEN, 72), generator=g, device="cuda").to(dtype)
    with torch.no_grad():
        out = fe.fused_encoder_layer(x, packed, n_head=N_HEAD)
        ref = fe.fused_encoder_layer_reference(x, packed, N_HEAD)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{dtype}: kernel output is not finite")
        err = (out.float() - ref.float()).abs().max().item()
        print(
            f"  {dtype} B={batch}: max |kernel - plain| = {err:.3e} "
            f"(tol {TOL[dtype]:.3e})", flush=True,
        )
        if not err <= TOL[dtype]:
            raise AssertionError(f"{dtype}: kernel disagrees with plain version: {err}")

        library = torch.nn.TransformerEncoderLayer(
            72, N_HEAD, 2048, batch_first=True
        ).to("cuda").eval()
        library.load_state_dict(layer0.state_dict())
        library = library.to(dtype)
        kernel_ms = time_ms(lambda: fe.fused_encoder_layer(x, packed, n_head=N_HEAD))
        plain_ms = time_ms(lambda: fe.fused_encoder_layer_reference(x, packed, N_HEAD))
        library_ms = time_ms(lambda: library(x))
    bound_ms, bound_by = layer_bound_ms(batch, MAX_LEN, 72, 2048, dtype)
    print(
        f"  {dtype} B={batch}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
        flush=True,
    )
    return {
        "max_abs_err": err, "tol": TOL[dtype], "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def run_main_path(dtype: torch.dtype) -> dict:
    model = load_flagship(dtype, "cuda")
    sampler = DiffusionSampler(
        model, VPScheduler(fourier_noise_scaling=True), max_len=MAX_LEN,
        n_channels=N_CHANNELS, sample_batch_size=SAMPLE_CHAINS, method="em",
        device="cuda",
    )
    g = torch.Generator(device="cuda").manual_seed(42)
    sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=2, generator=g)  # warm-up
    torch.cuda.synchronize()
    fe.launches = 0
    t0 = time.perf_counter()
    out = sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=SAMPLE_STEPS, generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fe.launches
    expected = SAMPLE_STEPS * N_LAYERS
    if launches != expected:
        raise AssertionError(f"{dtype}: {launches} kernel launches, expected {expected}")
    if tuple(out.shape) != (SAMPLE_CHAINS, MAX_LEN, N_CHANNELS):
        raise AssertionError(f"{dtype}: samples have shape {tuple(out.shape)}")
    series = fourier.idft(out)  # the frequency-domain model's samples in time
    if not (torch.isfinite(out).all() and torch.isfinite(series).all()):
        raise AssertionError(f"{dtype}: samples are not finite")
    rate = SAMPLE_CHAINS / seconds
    print(
        f"  {dtype}: {SAMPLE_CHAINS} chains x {SAMPLE_STEPS} steps in {seconds:.3f} s "
        f"= {rate:.3f} samples/s, {launches} launches, "
        f"std after idft {series.std().item():.4f}",
        flush=True,
    )
    return {"launches": launches, "seconds": seconds, "samples_per_s": rate}


def check_trajectory() -> float:
    model = load_flagship(torch.float32, "cuda")
    scheduler = VPScheduler(fourier_noise_scaling=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAJ_CHAINS, MAX_LEN, N_CHANNELS)
    x_T = scheduler.prior_sampling(shape, generator=g, device="cuda")
    z = torch.randn((TRAJ_STEPS, *shape), generator=g, device="cuda")
    packed = pack_score_transformer(model)
    kw = dict(num_diffusion_steps=TRAJ_STEPS, z=z)
    fused = reverse_diffusion(
        lambda x, t: fused_score_forward(model, packed, x, t), scheduler, x_T, **kw
    )
    with torch.no_grad():
        plain = reverse_diffusion(model, scheduler, x_T, **kw)
    diff = (fused - plain).abs().max().item()
    print(f"  max |kernel path - unfused| = {diff:.3e} (tol {TRAJ_TOL:.0e})", flush=True)
    if not diff <= TRAJ_TOL:
        raise AssertionError(f"trajectories disagree: {diff}")
    return diff


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(
        f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}"
    )
    print(smi, flush=True)
    phase("1 device", t0)

    t0 = time.perf_counter()
    cached = _build.library_path("fused_encoder").exists()
    lib = _build.build("fused_encoder")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"  {lib.name} ({'reused' if cached else 'built'})")
    phase("2 build", t0)

    t0 = time.perf_counter()
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = load_flagship(dtype, "cuda")
        checks[dtype] = {b: check_kernel(model, dtype, b) for b in KERNEL_BATCHES}
    phase("3 kernel vs plain", t0)

    t0 = time.perf_counter()
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        main[dtype] = run_main_path(dtype)
        kernel_s = checks[dtype][SAMPLE_CHAINS]["kernel_ms"] * main[dtype]["launches"] / 1e3
        print(
            f"  {dtype}: the kernel's share of the run, from its B={SAMPLE_CHAINS} time: "
            f"{kernel_s:.3f} s of {main[dtype]['seconds']:.3f} s", flush=True,
        )
    phase("4 main path", t0)

    t0 = time.perf_counter()
    check_trajectory()
    phase("5 trajectory", t0)

    kernels = []
    for dtype, by_batch in checks.items():
        r = by_batch[SAMPLE_CHAINS]  # the main path's shape
        kernels.append({
            "name": f"fused_encoder_layer/{str(dtype).removeprefix('torch.')}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": main[dtype]["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in by_batch.values()),
            "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B={SAMPLE_CHAINS} L={MAX_LEN} D=72 H={N_HEAD} F=2048",
            "samples_per_s": main[dtype]["samples_per_s"],
            "by_batch": {str(b): c for b, c in by_batch.items()},
        })
    print(f"total: {time.perf_counter() - t_all:.2f} s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
