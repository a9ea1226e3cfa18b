#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``fourierdiffusion_tpu_torch``)
on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed with its seconds as it ends:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: ``csrc/fused_encoder.cu`` (B1), ``csrc/flash_attention.cu`` (B2)
   and ``csrc/fused_encoder_train.cu`` (B3, B4), one ``nvcc`` each, all
   started together (a library already built is reused).
3. kernel: the trained flagship's layer 0 at L=100, fp32 and bf16, at
   batch 64 and at the main path's batch of 32: the kernel B1 against its
   plain PyTorch version on the card, and the times of the kernel, the
   plain version and one eval-mode ``nn.TransformerEncoderLayer`` call on
   the same weights (a yardstick the port never calls).
4. main path: ``DiffusionSampler`` (Euler-Maruyama, VP SDE with Fourier
   noise scaling, K=1000) on the trained ``ref-freq42-e200`` weights,
   32 chains, in fp32 and then in bf16 compute. Every layer of every step
   must go through the kernel: the launch count must be K x 10.
5. trajectory: K=20, 8 chains, fp32, one prior and one set of per-step
   draws, through the kernel B1, through the unfused module on the card
   (whose attention runs the kernel B2) and through the unfused module on
   the CPU (plain PyTorch), each pair held to one tolerance.
6. training kernels: at the flagship's training shape (B=64, L=100; B3 and
   B4 also at L=187) the attention forward B2 (fp32 and bf16), the training
   forward B3 and backward B4 (fp32, dropout 0.1) against their plain
   versions on the card, the dropout masks bit for bit, and the times of
   each kernel, its plain version, its bound and a PyTorch yardstick
   (``F.scaled_dot_product_attention``; a train-mode
   ``nn.TransformerEncoderLayer(72, 12, 2048, 0.1)`` forward and backward).
7. training check: the first 3 steps of the flagship's training through
   the kernels and through the plain versions, from the same weights, with
   the same batches, ``t``, ``z`` and layer seeds: losses and the first
   step's gradients must agree.
8. training main path: ``Trainer.fit`` with the flagship's training
   configuration (``runs/4ffeaa7e/train_config.yaml``: synthetic sine data,
   1000 series of L=100, DFT and standardisation; d_model 72, 10 layers,
   12 heads, FFN 2048, dropout 0.1; batch 64, lr 1e-3, clip 1.0, EMA
   0.999; VP SDE with Fourier noise scaling), random weights from a seed,
   cut to 2 epochs (32 steps), the data generated into a temporary
   directory. B3 and B4 must run steps x 10 times and B2 epochs x 16
   validation batches x 4 draws x 10 times; all losses must be finite.
   Then the steps/s of ``Trainer.train_step`` through the kernels and
   through the plain versions, on the same 8 batches.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero; it exits
non-zero too when no CUDA device is present.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from fourierdiffusion_tpu_torch.data import SyntheticDatamodule
from fourierdiffusion_tpu_torch.losses import draw_loss_noise
from fourierdiffusion_tpu_torch.models import ScoreModelConfig, ScoreTransformer
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.ops import _build, fourier
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler, reverse_diffusion
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.training.trainer import SEED_MAX
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
# The trajectories of the kernel path, the unfused module on the card and
# the plain module on the CPU, pairwise, over 20 fp32 reverse steps:
# per-step differences of ~1e-6 grow through the score near t = eps.
TRAJ_TOL = 1e-3

# H100 SXM data sheet, dense, at 700 W: fp32 on the CUDA cores (the kernel
# does not use the tensor cores yet) and bf16 on the tensor cores, HBM3.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
REPLACES = "fourierdiffusion_tpu/ops/fused_encoder.py:172"
SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder.cu"
SOURCES = ("fused_encoder", "flash_attention", "fused_encoder_train")

# The training slice: the flagship's training configuration
# (runs/4ffeaa7e/train_config.yaml), cut to TRAIN_EPOCHS epochs.
TRAIN_BATCH, TRAIN_SERIES, DROPOUT, TRAIN_EPOCHS = 64, 1000, 0.1, 2
VAL_DRAWS, CHECK_STEPS, RATE_STEPS = 4, 3, 8
TRAIN_LENGTHS = (MAX_LEN, 187)  # the synthetic runs' L and the ECG length
# B3 output against its plain version: fp32 in other summation orders
# (sums of up to 2048 terms), |y| < 8 after LayerNorm: 1e-4 as for B1.
TRAIN_TOL = 1e-4
# B4 and the first step's gradients, max |diff| / max |grad| per tensor,
# against autograd of the plain version: the weight gradients are sums over
# 64 x 100 positions (64 x 187) taken in another order, of terms of both
# signs, so their relative error is well above one fp32 ulp.
GRAD_TOL = 1e-3
# One exception, located and not assumed. A ReLU gate of the FFN whose input
# lies within fp32 rounding of 0 can open in the kernel's sum order and stay
# shut in the plain version's (or the reverse); that one element of dh then
# moves a column of dW1, an entry of db1 and the rows of dx of its chain. The
# script finds the gates whose fp64 input is within GATE_BAND x sum |terms|
# of 0 (the terms of x1 W1 + b1, and the dropout keeps the unit), picks from
# them the flips that explain the kernel's db1 against fp64, reruns the plain
# version in fp64 with exactly those gates flipped and holds every tensor to
# GRAD_TOL against that run. Each located flip is printed. A tensor passes if
# it meets GRAD_TOL against the plain version or, where flips were located,
# against the gate-matched fp64 run; a wrong kernel fails both.
# GATE_BAND: sums of 72 terms in fp32 and x1's own rounding (after two
# LayerNorms and attention) put the kernel's pre-activation within a few
# 1e-6 of the fp64 one, relative to the sum of |terms|.
GATE_BAND = 1e-5
MAX_FLIPS_PER_UNIT = 12
# Train losses of the first 3 steps, kernel path against plain path: the
# same weights and draws; step 0 has learning rate 0 and the updates of
# steps 1-2 move the weights by ~lr, so the losses agree to fp32 sums.
LOSS_TOL = 1e-4
FLASH_REPLACES = "fourierdiffusion_tpu/ops/flash_attention.py:92"
FLASH_FAST_REPLACES = "fourierdiffusion_tpu/ops/flash_attention.py:108"
TRAIN_FWD_REPLACES = "fourierdiffusion_tpu/ops/fused_encoder_train.py:135"
TRAIN_BWD_REPLACES = "fourierdiffusion_tpu/ops/fused_encoder_train.py:234"
FLASH_SOURCE = "fourierdiffusion_tpu_torch/csrc/flash_attention.cu"
TRAIN_SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder_train.cu"


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
    size = torch.finfo(dtype).bits // 8
    weights = (3 * d * d + d * d + 2 * d * d_ff) * size
    vectors = (3 * d + d + 4 * d + d_ff + d) * 4
    bytes_ = 2 * b * l * d * size + weights + vectors
    return bound(train_layer_flops(b, l, d, d_ff), bytes_, dtype)


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


def check_trajectory() -> dict:
    """One prior and one set of per-step draws through three score paths:
    the kernel B1 (fused), the unfused module on the card (its attention
    runs B2) and the unfused module on the CPU, plain PyTorch throughout."""
    model = load_flagship(torch.float32, "cuda")
    scheduler = VPScheduler(fourier_noise_scaling=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAJ_CHAINS, MAX_LEN, N_CHANNELS)
    x_T = scheduler.prior_sampling(shape, generator=g, device="cuda")
    z = torch.randn((TRAJ_STEPS, *shape), generator=g, device="cuda")
    packed = pack_score_transformer(model)
    kw = dict(num_diffusion_steps=TRAJ_STEPS)
    fused = reverse_diffusion(
        lambda x, t: fused_score_forward(model, packed, x, t), scheduler, x_T, z=z, **kw
    )
    with torch.no_grad():
        unfused = reverse_diffusion(model, scheduler, x_T, z=z, **kw)
        plain = reverse_diffusion(
            load_flagship(torch.float32, "cpu"), scheduler, x_T.cpu(), z=z.cpu(), **kw)
    diffs = {
        "B1_vs_plain": (fused.cpu() - plain).abs().max().item(),
        "B1_vs_unfused_B2": (fused - unfused).abs().max().item(),
        "unfused_B2_vs_plain": (unfused.cpu() - plain).abs().max().item(),
    }
    print(f"  max |difference| of the trajectories: {json.dumps(diffs)} "
          f"(tol {TRAJ_TOL:.0e} each)", flush=True)
    if not all(d <= TRAJ_TOL for d in diffs.values()):
        raise AssertionError(f"trajectories disagree: {diffs}")
    return diffs


def bound(flops: float, bytes_: float, dtype: torch.dtype) -> tuple[float, str]:
    """Least milliseconds: operations over the peak rate of ``dtype`` or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def train_layer_flops(b: int, l: int, d: int, d_ff: int) -> float:
    """Multiply-adds x 2 of one training-layer forward: the four projections
    and the two attention products."""
    return 2 * b * l * (3 * d * d + d * d + 2 * d * d_ff) + 2 * 2 * b * l * l * d


def build_all() -> None:
    """One nvcc per source, all started together."""
    def one(name: str) -> tuple[str, float, bool]:
        t0 = time.perf_counter()
        cached = _build.library_path(name).exists()
        _build.build(name)
        return name, time.perf_counter() - t0, cached

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    for name, seconds, cached in results:
        lib = _build.library_path(name)
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
        print(f"  {lib.name} ({'reused' if cached else 'built'} in {seconds:.2f} s)", flush=True)


def check_attention(model: ScoreTransformer, dtype: torch.dtype) -> dict:
    """B2 on the flagship layer 0's q, k, v at the training shape."""
    layer0 = model.backbone.layers[0].self_attn
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((TRAIN_BATCH, MAX_LEN, 72), generator=g, device="cuda")
    dh = 72 // N_HEAD
    with torch.no_grad():
        qkv = F.linear(x, layer0.in_proj_weight, layer0.in_proj_bias)
        q, k, v = (t.reshape(TRAIN_BATCH, MAX_LEN, N_HEAD, dh).transpose(1, 2)
                   .contiguous().to(dtype) for t in qkv.split(72, dim=-1))
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (torch.isfinite(out.float()).all() and err <= TOL[dtype]):
            raise AssertionError(f"B2 {dtype}: kernel disagrees with plain version: {err}")
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    size = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(
        4 * TRAIN_BATCH * N_HEAD * MAX_LEN * MAX_LEN * dh, 4 * q.numel() * size, dtype
    )
    r = {"max_abs_err": err, "tol": TOL[dtype], "ms": kernel_ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  B2 {dtype} B={TRAIN_BATCH}: {json.dumps(r)}", flush=True)
    return r


def check_train_layer(model: ScoreTransformer, l: int) -> dict:
    """B3 and B4 on the flagship layer 0 (dropout 0.1) against the plain
    version and its autograd, with the masks bit for bit."""
    packed = {k: t.detach().requires_grad_(True) for k, t in
              fet.pack_encoder_layer_train(model.backbone.layers[0], N_HEAD).items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((TRAIN_BATCH, l, 72), generator=g, device="cuda").requires_grad_(True)
    dy = torch.randn((TRAIN_BATCH, l, 72), generator=g, device="cuda")
    seed = 123456789
    kernel_masks = fet.dropout_masks_cuda(TRAIN_BATCH, l, 72, 2048, N_HEAD, seed, DROPOUT)
    masks = fet.dropout_masks(TRAIN_BATCH, l, 72, 2048, N_HEAD, seed, DROPOUT, "cuda")
    for key in masks:
        if not torch.equal(kernel_masks[key], masks[key]):
            raise AssertionError(f"L={l}: the {key} masks of the kernel and plain differ")
    inputs = [x, *packed.values()]
    out = fet.fused_encoder_layer_train(x, packed, seed, n_head=N_HEAD, rate=DROPOUT)
    grads = torch.autograd.grad(out, inputs, dy)
    ref = fet.fused_encoder_layer_train_reference(x, packed, seed, n_head=N_HEAD, rate=DROPOUT)
    ref_grads = torch.autograd.grad(ref, inputs, dy, retain_graph=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not (torch.isfinite(out).all() and err <= TRAIN_TOL):
        raise AssertionError(f"B3 L={l}: kernel disagrees with plain version: {err}")
    names = ["x", *packed]
    matched, flips, n_near = gate_matched_grads(
        x, dy, packed, seed, grads[names.index("b1")], masks, N_HEAD)
    rel, abs_err = {}, 0.0
    for name, k, p, m in zip(names, grads, ref_grads, matched):
        abs_err = max(abs_err, (k - p).abs().max().item())
        rel[name] = {"vs_plain": rel_err(k, p), "vs_gate_matched_fp64": rel_err(k, m)}
        r = rel[name]
        if not (r["vs_plain"] <= GRAD_TOL
                or (flips and r["vs_gate_matched_fp64"] <= GRAD_TOL)):
            raise AssertionError(f"B4 L={l}: gradient {name} disagrees: {r}")
    worst = max(r["vs_plain"] for r in rel.values())
    print(f"  B3/B4 L={l}: max |fwd - plain| {err:.3e} (tol {TRAIN_TOL:.0e}); "
          f"max |grad - plain| / max |grad| {worst:.3e}; ReLU gates within rounding of "
          f"0: {n_near}, flips located: {json.dumps(flips)}; per tensor {json.dumps(rel)}",
          flush=True)
    if l != MAX_LEN:
        return {"fwd_err": err, "grad_abs_err": abs_err}

    xd, layer = x.detach(), {k: t.detach() for k, t in packed.items()}
    fwd_ms = time_ms(lambda: fet._launch_fwd(xd, layer, seed, N_HEAD, DROPOUT), iters=20)
    bwd_ms = time_ms(lambda: fet._launch_bwd(xd, dy, layer, seed, N_HEAD, DROPOUT), iters=10)
    plain_fwd_ms = time_ms(lambda: fet.fused_encoder_layer_train_reference(
        xd, layer, seed, n_head=N_HEAD, rate=DROPOUT), iters=10)
    plain_bwd_ms = time_ms(
        lambda: torch.autograd.grad(ref, inputs, dy, retain_graph=True), iters=10)
    library = torch.nn.TransformerEncoderLayer(
        72, N_HEAD, 2048, DROPOUT, batch_first=True).to("cuda").train()
    lib_out = library(x)
    lib_params = [x, *library.parameters()]
    lib_fwd_ms = time_ms(lambda: library(x), iters=10)
    lib_bwd_ms = time_ms(
        lambda: torch.autograd.grad(lib_out, lib_params, dy, retain_graph=True), iters=10)
    flops = train_layer_flops(TRAIN_BATCH, l, 72, 2048)
    weights = sum(t.numel() for t in layer.values()) * 4
    act = TRAIN_BATCH * l * 72 * 4
    fwd_bound = bound(flops, 2 * act + weights, torch.float32)
    # The backward from (x, dy, weights) recomputes the forward and then
    # does two products for each product of the forward.
    bwd_bound = bound(3 * flops, 3 * act + 2 * weights, torch.float32)
    r = {
        "fwd": {"max_abs_err": err, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
                "library_ms": lib_fwd_ms, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
        "bwd": {"max_abs_err": abs_err, "max_rel_err": worst, "gate_flips": flips,
                "ms": bwd_ms, "plain_ms": plain_bwd_ms,
                "library_ms": lib_bwd_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},
    }
    print(f"  B3/B4 L={l} B={TRAIN_BATCH} times: {json.dumps(r)}", flush=True)
    return r


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in fp64."""
    b = b.double()
    return (a.double() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def gate_matched_grads(
    x, dy, layer, seed: int, kernel_db1: torch.Tensor, masks, n_head: int
) -> tuple:
    """The plain version's gradients in fp64 with the FFN's ReLU gates that
    the kernel flipped flipped too (see GATE_BAND).

    Only a gate whose fp64 input lies within GATE_BAND x sum |terms| of 0,
    and whose unit the dropout keeps, may flip. Flipping gate (b, l, f)
    moves db1[f] by -+dL/dhidden at (b, l, f), so for each unit f the flips
    are the subset of its near-zero gates that best explains the kernel's
    db1[f] against fp64. Returns the gradients (x first, then the 12 packed
    weights), the located flips and the number of near-zero gates."""
    x64 = x.detach().double().requires_grad_(True)
    lay = {k: t.detach().double().requires_grad_(True) for k, t in layer.items()}
    dy64 = dy.double()

    def run(flip):
        x1 = fet.attention_sublayer(x64, lay, masks, n_head)
        pre = x1 @ lay["w1"] + lay["b1"]
        hidden = pre * ((pre.detach() > 0) ^ flip)
        y = fet.ffn_sublayer(x1, hidden, lay, masks)
        *grads, d_hidden = torch.autograd.grad(y, [x64, *lay.values(), hidden], dy64)
        return x1.detach(), pre.detach(), grads, d_hidden

    flip = torch.zeros(x.shape[0], x.shape[1], lay["w1"].shape[1], dtype=torch.bool,
                       device=x.device)
    x1, pre, grads, d_hidden = run(flip)
    terms = x1.abs() @ lay["w1"].detach().abs() + lay["b1"].detach().abs()
    near = (pre.abs() <= GATE_BAND * terms) & (masks["ff"] > 0)
    cand = near.nonzero().tolist()
    # db1 change if the gate flips: + dL/dhidden opening, - closing
    shift = torch.where(pre[near] > 0, -d_hidden[near], d_hidden[near]).tolist()
    resid = kernel_db1.double() - grads[1 + fet.LAYER_KEYS.index("b1")]
    by_unit: dict[int, list[int]] = {}
    for i, (_, _, f) in enumerate(cand):
        by_unit.setdefault(f, []).append(i)
    located = []
    for f, idx in by_unit.items():
        if len(idx) > MAX_FLIPS_PER_UNIT:
            raise AssertionError(f"B4: {len(idx)} near-zero ReLU gates in unit {f}")
        target = resid[f].item()
        best = min(  # the fewest flips among the closest fits
            (abs(target - sum(shift[i] for i in sub)), len(sub), sub)
            for n in range(len(idx) + 1) for sub in itertools.combinations(idx, n)
        )[2]
        for i in best:
            b, l, _ = cand[i]
            flip[b, l, f] = True
            located.append({"chain": b, "row": l, "unit": f, "pre_fp64": pre[b, l, f].item(),
                            "terms": terms[b, l, f].item(), "db1_shift": shift[i],
                            "db1_kernel_minus_fp64": target})
    if located:
        grads = run(flip)[2]
    return grads, located, len(cand)


def flagship_model(dtype: str = "float32") -> ScoreTransformer:
    """The flagship with random weights from seed 0 (the same for any dtype)."""
    torch.manual_seed(0)
    model = ScoreModelConfig(
        d_model=72, num_layers=N_LAYERS, n_head=N_HEAD, dim_feedforward=2048,
        dropout_rate=DROPOUT, dtype=dtype,
    ).build(n_channels=N_CHANNELS, max_len=MAX_LEN)
    return model.to(getattr(torch, dtype))


def flagship_trainer(plain: bool = False) -> Trainer:
    model = flagship_model()
    return Trainer(
        model, VPScheduler(fourier_noise_scaling=True), max_epochs=TRAIN_EPOCHS,
        lr_max=1e-3, gradient_clip_val=1.0, ema_decay=0.999, spike_rollback_factor=2.5,
        spike_rollback_retries=2, val_noise_draws=VAL_DRAWS, seed=42, device="cuda",
        plain=plain,
    )


def synthetic_data(root: str) -> SyntheticDatamodule:
    dm = SyntheticDatamodule(
        data_dir=root, random_seed=42, batch_size=TRAIN_BATCH, fourier_transform=True,
        standardize=True, max_len=MAX_LEN, num_samples=TRAIN_SERIES, family="sine",
    )
    dm.prepare_data()
    dm.setup()
    return dm


def draw_steps(dm: SyntheticDatamodule, n: int) -> list[tuple]:
    """``n`` train steps' inputs from a seed: a batch, its ``t`` and ``z``
    and one dropout seed per layer."""
    x_all = dm.train_arrays().standardized().to("cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    seeds = torch.Generator().manual_seed(5)
    steps = []
    for _ in range(n):
        idx = torch.randperm(x_all.shape[0], generator=g, device="cuda")[:TRAIN_BATCH]
        t, z = draw_loss_noise(VPScheduler(), x_all[idx], g)
        layer_seeds = torch.randint(0, SEED_MAX, (N_LAYERS,), generator=seeds).tolist()
        steps.append((x_all[idx], t, z, layer_seeds))
    return steps


def check_training(dm: SyntheticDatamodule) -> dict:
    """The first steps through the kernels and through the plain versions."""
    steps = draw_steps(dm, CHECK_STEPS)
    kernel, plain = flagship_trainer(), flagship_trainer(plain=True)
    n_steps = dm.steps_per_epoch * TRAIN_EPOCHS
    losses, grads = {}, {}
    for name, trainer in (("kernel", kernel), ("plain", plain)):
        trainer.start(n_steps)
        grads[name] = trainer.loss_and_grads(*steps[0])[1]
        losses[name] = [trainer.train_step(*step).item() for step in steps]
    exact = Trainer(flagship_model("float64"), VPScheduler(fourier_noise_scaling=True),
                    device="cuda", plain=True)
    x0, t0, z0, seeds0 = steps[0]
    grads["fp64"] = exact.loss_and_grads(x0.double(), t0.double(), z0.double(), seeds0)[1]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"]))
    print(f"  losses kernel {losses['kernel']} plain {losses['plain']}: max rel diff "
          f"{rel_loss:.3e} (tol {LOSS_TOL:.0e})", flush=True)
    if not all(math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        raise AssertionError(f"training check: losses not finite: {losses}")
    if not rel_loss <= LOSS_TOL:
        raise AssertionError(f"training check: losses disagree: {rel_loss}")
    rel = {}
    for name, k, p, e in zip(kernel.names, grads["kernel"], grads["plain"], grads["fp64"]):
        rel[name] = {"vs_plain": rel_err(k, p), "kernel_vs_fp64": rel_err(k, e),
                     "plain_vs_fp64": rel_err(p, e)}
        if not rel[name]["vs_plain"] <= GRAD_TOL:
            raise AssertionError(f"training check: gradient {name} disagrees: {rel[name]}")
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_plain"])
    print(f"  step-0 gradients: worst against plain {worst[0]} {json.dumps(worst[1])}; "
          f"per tensor {json.dumps(rel)}", flush=True)
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_plain"]}


def run_training(dm: SyntheticDatamodule) -> dict:
    """The training main path; the counts are read around ``fit`` alone."""
    trainer = flagship_trainer()
    torch.cuda.synchronize()
    fet.fwd_launches = fet.bwd_launches = fa.launches = fe.launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(dm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"B3": fet.fwd_launches, "B4": fet.bwd_launches, "B2": fa.launches,
              "B1": fe.launches}
    steps = dm.steps_per_epoch * TRAIN_EPOCHS
    val_batches = -(-TRAIN_SERIES // TRAIN_BATCH)
    expected = {"B3": steps * N_LAYERS, "B4": steps * N_LAYERS,
                "B2": TRAIN_EPOCHS * val_batches * VAL_DRAWS * N_LAYERS}
    for h in history:
        print(f"  epoch {h['epoch']}: {json.dumps(h)}", flush=True)
    for name, n in expected.items():
        if counts[name] != n:
            raise AssertionError(f"training: {counts[name]} {name} launches, expected {n}")
    if len(history) != TRAIN_EPOCHS or not all(
        math.isfinite(h["train/loss"]) and math.isfinite(h["val/loss"]) for h in history
    ):
        raise AssertionError(f"training: epochs or losses wrong: {history}")
    if not all(torch.isfinite(p).all() for p in trainer.params):
        raise AssertionError("training: parameters are not finite")
    train_s = sum(h["train_seconds"] for h in history)
    val_s = sum(h["val_seconds"] for h in history)
    r = {"launches": counts, "seconds": seconds, "steps": steps,
         "steps_per_s": steps / train_s, "step_ms": 1e3 * train_s / steps,
         "val_pass_s": val_s / TRAIN_EPOCHS, "losses": [
             (h["train/loss"], h["val/loss"]) for h in history]}
    print(f"  training: {steps} steps in {train_s:.3f} s = {r['steps_per_s']:.3f} steps/s "
          f"({r['step_ms']:.2f} ms/step); validation {r['val_pass_s']:.3f} s per pass; "
          f"launches {counts}", flush=True)
    return r


def step_rates(dm: SyntheticDatamodule) -> dict:
    """Train steps per second through the kernels and through the plain
    versions (``Trainer(plain=True)``), on the same RATE_STEPS batches after
    one warm-up step, each timed by the host clock around synchronised steps."""
    steps = draw_steps(dm, RATE_STEPS + 1)
    rates = {}
    for name, plain in (("kernel", False), ("plain", True)):
        trainer = flagship_trainer(plain=plain)
        trainer.start(dm.steps_per_epoch * TRAIN_EPOCHS)
        trainer.train_step(*steps[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in steps[1:]:
            trainer.train_step(*step)
        torch.cuda.synchronize()
        rates[name] = RATE_STEPS / (time.perf_counter() - t0)
    print(f"  train_step, {RATE_STEPS} steps each: {rates['kernel']:.3f} steps/s through "
          f"the kernels, {rates['plain']:.3f} steps/s through the plain versions", flush=True)
    return {"kernel_steps_per_s": rates["kernel"], "plain_steps_per_s": rates["plain"]}


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
    build_all()
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
    fa.launches = 0
    check_trajectory()
    print(f"  B2 launches in the unfused trajectory: {fa.launches}", flush=True)
    if fa.launches != TRAJ_STEPS * N_LAYERS:
        raise AssertionError(f"trajectory: {fa.launches} B2 launches")
    phase("5 trajectory", t0)

    t0 = time.perf_counter()
    flagship = load_flagship(torch.float32, "cuda")
    attention = {dtype: check_attention(flagship, dtype)
                 for dtype in (torch.float32, torch.bfloat16)}
    train_layer = {l: check_train_layer(flagship, l) for l in TRAIN_LENGTHS}
    phase("6 training kernels vs plain", t0)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dm = synthetic_data(root)
        train_check = check_training(dm)
        phase("7 training check", t0)

        t0 = time.perf_counter()
        training = run_training(dm)
        timed = train_layer[MAX_LEN]
        kernel_ms = N_LAYERS * (timed["fwd"]["ms"] + timed["bwd"]["ms"])
        print(f"  the kernels' share of a step, from their B={TRAIN_BATCH} times: "
              f"{kernel_ms:.3f} ms of {training['step_ms']:.3f} ms "
              f"({100 * kernel_ms / training['step_ms']:.1f} %)", flush=True)
        training.update(step_rates(dm))
        phase("8 training main path", t0)

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
    f32 = attention[torch.float32]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": training["launches"]["B2"],
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} float32",
        "bfloat16": {**attention[torch.bfloat16], "replaces": FLASH_FAST_REPLACES},
    })
    for key, name, replaces, count in (
        ("fwd", "fused_encoder_layer_train_fwd", TRAIN_FWD_REPLACES, "B3"),
        ("bwd", "fused_encoder_layer_train_bwd", TRAIN_BWD_REPLACES, "B4"),
    ):
        r = timed[key]
        kernels.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCE, "replaces": replaces,
            "launches": training["launches"][count],
            "max_abs_err": max(r["max_abs_err"], train_layer[187][
                "fwd_err" if key == "fwd" else "grad_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"B={TRAIN_BATCH} L={MAX_LEN} D=72 H={N_HEAD} F=2048 fp32 dropout {DROPOUT}",
            "steps_per_s": training["steps_per_s"],
        })
    print(f"training: {json.dumps({**training, **train_check})}", flush=True)
    print(f"total: {time.perf_counter() - t_all:.2f} s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
