#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``fourierdiffusion_tpu_torch``)
on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed with its seconds as it ends:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: ``csrc/fused_encoder.cu`` (B1), ``csrc/flash_attention.cu`` (B2,
   B5, B6), ``csrc/fused_encoder_train.cu`` (B3, B4) and
   ``csrc/fused_encoder_int8.cu`` (B7, B8), one ``nvcc`` each, all started
   together (a library already built is reused), with ptxas's registers,
   stack and spills for every kernel instance, and, from ``cuobjdump
   -sass``, the instructions and tensor-core instructions (HMMA) of each
   kernel of B1, B2, B3 and B4; every kernel that runs a tile product must
   have HMMA, and B2's kernel and the training tail must be among them.
3. kernel: the trained flagship's layer 0 at L=100, fp32 and bf16, at
   batch 64 and at the main path's batch of 32: the kernel B1 against its
   plain PyTorch version on the card, and the times of the kernel (beside
   its time before the tensor-core redesign, PRIOR_MS), the plain version
   and one eval-mode ``nn.TransformerEncoderLayer`` call on the same
   weights (a yardstick the port never calls), its bounds (and, in fp32,
   three times its products over the TF32 peak) and launches per call.
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
   versions on the card, the dropout masks bit for bit, B4's stages (dF2,
   dx1, da, dqkv) against the staged plain backward, and the times of
   each kernel (beside its time before its redesign, PRIOR_MS), its plain
   version, its bound and a PyTorch yardstick
   (``F.scaled_dot_product_attention``; a train-mode
   ``nn.TransformerEncoderLayer(72, 12, 2048, 0.1)`` forward and backward),
   with the CUDA launches of one B3 and one B4 call as their plans count
   them; at L=100 also B3 and B4 each called twice on the same inputs
   (bit-identical) and B4's time per stage (CUDA events), and the device
   time and the launches of each kernel of one B1 call (B=32, fp32 and
   bf16), one B3 and one B4 call (B=64), from ``torch.profiler``: the
   launches of one B3 and one B4 call must be those of their plans.
7. training check: the first 3 steps of the flagship's training through
   the kernels and through the plain versions, from the same weights, with
   the same batches, ``t``, ``z`` and layer seeds: losses and the first
   step's gradients must agree (FFN ReLU gates that flipped between the two
   paths located and matched, as in phase 11).
8. training main path: ``Trainer.fit`` with the flagship's training
   configuration (``runs/4ffeaa7e/train_config.yaml``: synthetic sine data,
   1000 series of L=100, DFT and standardisation; d_model 72, 10 layers,
   12 heads, FFN 2048, dropout 0.1; batch 64, lr 1e-3, clip 1.0, EMA
   0.999; VP SDE with Fourier noise scaling), random weights from a seed,
   cut to 2 epochs (32 steps), the data generated into a temporary
   directory. B3 and B4 must run steps x 10 times and B2 epochs x 16
   validation batches x 4 draws x 10 times; all losses must be finite.
   Its fused steps/s and seconds per validation pass (with B2's share of
   it), then the steps/s of ``Trainer.train_step`` through the kernels and
   through the plain versions, on the same 8 batches.
9. long sequences and wide layers: B1 (fp32, bf16), B3 and B4 against their
   plain versions (today's gates, masks bit for bit) at B=8 where their
   shared-memory plan does not fit: L=365 at d_model 72 (USDroughts), and
   L=187 at d_model 128 with 8 heads and FFN 2048 and 512
   (``configs/score_model/fast.yaml``, ``fast512.yaml``), with their times
   beside phase 3's L=100 ones; B2 (fp32, bf16) at B=8 at each dataset
   length and shipped head width (B2_SHAPES), at dh 64, and at L 3616 and
   438 (dh 6 and 64: longer than a kernel that stages the whole head takes),
   against its plain version (bf16: to B2_BF16_ULPS ulps of the largest
   output), with its time, its plain version's and SDPA's.
10. unfused attention kernels: B5 (backward), B6-fwd and B6-bwd (dropout
   0.1) against their plain versions at (64, 12, 100, 6) and (8, 12, 365, 6),
   fp32, with the masks bit for bit, and the times of each kernel, its plain
   version, its bound and a yardstick the port never calls: the autograd
   backward of ``F.scaled_dot_product_attention`` for B5, SDPA with
   ``dropout_p=0.1`` forward and backward for B6 (the SDPA backend printed);
   B2's fp32 time on the same heads beside SDPA's without dropout.
11. unfused training check (``FDIFF_FUSED_TRAIN=0``): the first 3 steps of
   the flagship's training configuration through the kernels and through
   ``Trainer(plain=True)``, from the same weights, batches, ``t``, ``z`` and
   generator (so the same attention seeds and FFN-site draws), at dropout
   0.1 (B6) and 0 (B2 + B5): losses and the first step's gradients.
12. unfused training main path: ``Trainer.fit`` as in phase 8, with
   ``FDIFF_FUSED_TRAIN=0``, cut to 1 epoch (16 steps), at dropout 0.1 (B6-fwd
   = B6-bwd = steps x 10) and at dropout 0 (B5 = steps x 10), B2 for
   validation; all losses finite; its steps/s beside phase 8's.
13. int8 kernels: B7 (``FDIFF_FUSED_INT8=1``) and B8 (``=2``) against their
   plain versions on the trained flagship's layer 0 at L=100, B=64 and 32,
   fp32 and bf16, and at B=8 on phase 9's shapes (random weights). The
   kernel writes the int8 codes of every quantization site; the plain
   version is run with those codes put in, site by site, and every code
   where the two part is located (``locate_code_flips``) and held to a
   band around a rounding boundary (INT8_FLIP_BAND); the output is held
   to B1's tolerance against that run. Times of each kernel, its plain
   version and B1 at the same shape and dtype, and the bound.
14. int8 main path: phase 4's sampler in bf16 with ``FDIFF_FUSED_INT8=1``
   and then ``=2``: B7 (or B8) K x 10 launches and B1 none; the samples
   finite, their samples/s and relative L2 distance from phase 4's bf16
   samples (the same generator seed); a 20-step fp32 trajectory through
   B7/B8 and through their plain versions on the card and on the CPU with
   the kernel's int8 codes of every layer and step put in (every flip
   located), pairwise.
15. pc main path: ``DiffusionSampler(method="pc", corrector_steps=1,
   snr=0.16, divergence_threshold=8.0)``, K=250 (``bench.py``'s pc250), 32
   chains, bf16, the same weights: B1 K x 2 x 10 launches for each draw of
   the batch (the first and each redraw the guard makes, from
   ``last_resample_stats``); its samples/s.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero; it exits
non-zero too when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
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
from fourierdiffusion_tpu_torch.models import fused as fused_models
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
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

# H100 SXM data sheet, dense, at 700 W: fp32 on the CUDA cores and bf16 on
# the tensor cores, HBM3; and TF32 on the tensor cores, for the second bound
# of the fp32 products that B1 and B4 run as 3xTF32 (three TF32 products
# per fp32 product).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
# B1 and B4 before their tensor-core redesign, as this script measured them
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6). Printed beside
# this run's times, never compared with them in a gate.
PRIOR_MS = {
    "B1": {"float32 B=32 L=100": 0.4242, "bfloat16 B=32 L=100": 0.3704,
           "float32 L=365 D=72 H=12 F=2048": 1.3330, "bfloat16 L=365 D=72 H=12 F=2048": 0.8087,
           "float32 L=187 D=128 H=8 F=2048": 1.4954, "bfloat16 L=187 D=128 H=8 F=2048": 1.1081,
           "float32 L=187 D=128 H=8 F=512": 1.0256, "bfloat16 L=187 D=128 H=8 F=512": 0.7411},
    "B4": {"L=100 D=72 H=12 F=2048": 7.5089, "L=365 D=72 H=12 F=2048": 34.2,
           "L=187 D=128 H=8 F=2048": 26.4, "L=187 D=128 H=8 F=512": 11.4},
    # B2 and B3 before their redesign on the tensor cores (PERF.md, section
    # 6; the same card and power limit).
    "B2": {"float32 B=64 H=12 L=100 dh=6": 0.1287, "bfloat16 B=64 H=12 L=100 dh=6": 0.1294},
    "B3": {"L=100 D=72 H=12 F=2048": 0.9166},
}
# The kernels that run tile products (B1, B2, B3, B4): each must show
# tensor-core instructions (HMMA) in its SASS.
PRODUCT_KERNELS = ("gemm_kernel", "gemm_pair_kernel", "layer_tail_kernel",
                   "attention_fwd_mma_kernel")
# ... and these must be among them: B2's kernel, and the tail that B3 runs.
REQUIRED_PRODUCT_KERNELS = {"flash_attention": "attention_fwd_mma_kernel",
                            "fused_encoder_train": "layer_tail_kernel"}
REPLACES = "fourierdiffusion_tpu/ops/fused_encoder.py:172"
SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder.cu"
SOURCES = ("fused_encoder", "flash_attention", "fused_encoder_train", "fused_encoder_int8")

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
FLASH_BWD_REPLACES = "fourierdiffusion_tpu/ops/flash_attention.py:167"
DROPOUT_FWD_REPLACES = "fourierdiffusion_tpu/ops/flash_attention.py:326"
DROPOUT_BWD_REPLACES = "fourierdiffusion_tpu/ops/flash_attention.py:342"

# The lengths and widths where the layer kernels' shared-memory plan does not
# fit (their K|V, or B4's x1 and f2, go to device memory), (L, D, H, F):
# USDroughts' L=365 at the flagship width, and configs/score_model/fast.yaml
# (F 2048) and fast512.yaml (F 512) at ECG's L=187.
COVERAGE = ((365, 72, 12, 2048), (187, 128, 8, 2048), (187, 128, 8, 512))
COVERAGE_BATCH = 8
# The unfused attention kernels' shapes, (B, L): the training batch at the
# flagship's L, and USDroughts' L (three head groups of 4 in the masks).
ATTN_SHAPES = ((TRAIN_BATCH, MAX_LEN), (8, 365))
# Attention outputs against the plain version: fp32 sums of 100-365 terms in
# other orders, |o| < 4: 1e-4 as for B1. Gradients: GRAD_TOL, as for B4.
ATTN_TOL = 1e-4
# B2 beyond the flagship's heads, (B, H, L, dh) at B=8: the dataset lengths
# (MIMIC 24, ECG 187, USDroughts 365) at the shipped head widths (6 in
# default.yaml, 12 in heads6.yaml, 16 in fast.yaml) and the widest head the
# kernel takes (64); each in fp32 and bf16 (dh < 16: the fast form).
B2_SHAPES = ((8, 12, 24, 6), (8, 6, 24, 12), (8, 12, 187, 6), (8, 8, 187, 16),
             (8, 12, 365, 6), (8, 6, 365, 12), (8, 2, 100, 64), (1, 4, 3616, 6),
             (1, 4, 438, 64))
# B2 in bf16 against its plain version: both round P and O at the same
# points, and a rounding that flips between their fp32 sum orders moves an
# output by about one bf16 ulp of |o| (the largest this script read on an
# NVIDIA H100 80GB HBM3 before this tolerance: 2**-9 = 1.95e-3, at B=8 H=12
# L=187 dh=6; 4.9e-4 to 9.8e-4 at the other B2_SHAPES). Attention outputs on random heads are far below
# LayerNorm's |y| < 8, where TOL's 2**-4 could hide a lost key block, so
# the tolerance is B2_BF16_ULPS ulps of the plain version's largest |o|;
# fp32 keeps TOL.
B2_BF16_ULPS = 4
UNFUSED_EPOCHS = 1

# The int8 layers B7 (level 1) and B8 (level 2).
INT8_LEVELS = (1, 2)
INT8_NAMES = {1: "B7", 2: "B8"}
INT8_SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder_int8.cu"
INT8_REPLACES = {1: "fourierdiffusion_tpu/ops/fused_encoder.py:238",
                 2: "fourierdiffusion_tpu/ops/fused_encoder.py:384"}
PEAK_INT8_OPS = 1979e12  # H100 SXM data sheet, dense int8 tensor cores, 700 W
# Kernel against its plain version run with the kernel's own int8 codes put
# in (locate_code_flips): then the two differ only by float rounding, so
# B1's TOL holds. Each code where they part is located at its site:
# - fp32: the two versions' fp32 inputs to a quantization are sums taken in
#   other orders, ~1e-6 relative apart, so ~1e-4 of a code at |x/scale| up
#   to 127: a flipped code must move by one and its plain input lie within
#   INT8_FLIP_BAND of a rounding boundary (k + 1/2).
# - bf16: a bf16 rounding upstream that flipped between the two (q, k, P or
#   O, B1's own case under its 2**-4 tolerance) moves a quantizer's input by
#   up to about a code, so the band does not apply; at most
#   INT8_BF16_FLIP_SHARE of a site's codes may flip.
# - the sites whose inputs both compute alike (x; V from exact integer sums
#   dequantized in one order) flip nowhere, in either dtype.
INT8_FLIP_BAND = 1e-3
INT8_BF16_FLIP_SHARE = 1e-2
INT8_EXACT_SITES = ("x", "v")
# The 20-step fp32 trajectories through B7/B8 and through their plain
# versions on the card and on the CPU are compared with the kernel's int8
# codes of every layer and step put into the plain versions, each flip
# located, and then held to TRAJ_TOL like phase 5's. Each version follows
# its own states (and every layer after the first its own input), so the
# inputs of a quantization differ by the trajectories' own distance, not
# by one layer's rounding: a flip there must move by one code, and the
# band and the exact sites of phase 13 (same inputs) do not apply. (With their own codes,
# a flip moves a layer output by up to a quantization step, and the last
# steps near t = eps, where the score is scaled by 1/std(t), carry it into
# the samples: the two plain versions alone, the same code on an H100 and
# on the CPU, ended 1.1e-2 apart in relative L2.)
PC_STEPS, PC_CORRECTOR_STEPS, PC_SNR = 250, 1, 0.16
# configs/sampler/default.yaml of the JAX package recommends 8.0.
DIVERGENCE_THRESHOLD = 8.0


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


def tf32x3_bound_ms(flops: float) -> float:
    """Least time of fp32 products run as 3xTF32: three times the products
    over the TF32 tensor-core peak."""
    return 3 * flops / PEAK_TF32 * 1e3


def layer_vs_plain(layer, n_head: int, dtype: torch.dtype, batch: int, l: int,
                   library=None, prior: str | None = None) -> dict:
    """B1 on one encoder layer at (batch, l) against its plain version, and
    the times of the kernel, the plain version and ``library`` (if given),
    beside B1's time before its redesign (``PRIOR_MS["B1"][prior]``)."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    packed = fe.pack_encoder_layer(layer, n_head, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, l, d), generator=g, device="cuda").to(dtype)
    shape = f"{dtype} B={batch} L={l} D={d} H={n_head} F={d_ff}"
    with torch.no_grad():
        out = fe.fused_encoder_layer(x, packed, n_head=n_head)
        ref = fe.fused_encoder_layer_reference(x, packed, n_head)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"B1 {shape}: kernel output is not finite")
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  B1 {shape}: max |kernel - plain| = {err:.3e} (tol {TOL[dtype]:.3e})",
              flush=True)
        if not err <= TOL[dtype]:
            raise AssertionError(f"B1 {shape}: kernel disagrees with plain version: {err}")
        kernel_ms = time_ms(lambda: fe.fused_encoder_layer(x, packed, n_head=n_head))
        plain_ms = time_ms(lambda: fe.fused_encoder_layer_reference(x, packed, n_head))
        library_ms = time_ms(lambda: library(x)) if library is not None else None
    bound_ms, bound_by = layer_bound_ms(batch, l, d, d_ff, dtype)
    prior_ms = PRIOR_MS["B1"].get(prior) if prior else None
    tf32x3 = tf32x3_bound_ms(train_layer_flops(batch, l, d, d_ff)) \
        if dtype == torch.float32 else None
    print(f"  B1 {shape}: kernel {kernel_ms:.4f} ms (before the redesign: {prior_ms} ms), "
          f"plain {plain_ms:.4f} ms, library "
          f"{library_ms if library_ms is None else round(library_ms, 4)} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), 3xTF32 bound {tf32x3} ms, "
          f"{fe.sample_plan(batch, l, d, n_head, d_ff, dtype)['launches']} launches per call",
          flush=True)
    return {
        "max_abs_err": err, "tol": TOL[dtype], "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def kernel_name(demangled: str) -> str:
    """A demangled kernel name without ``void``, anonymous namespaces and its
    parameter list (template arguments such as ``(fdiff::TailMode)1`` kept)."""
    name = demangled.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def device_us_by_kernel(fn, calls: int = 10) -> tuple[dict[str, float], float]:
    """Device microseconds per call of ``fn`` by CUDA kernel (summed over a
    kernel's launches in one call), and the kernel launches per call, from
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, launches = {}, 0
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", 0.0)
        if device_us > 0:
            name = kernel_name(event.key)
            out[name] = out.get(name, 0.0) + device_us / calls
            launches += event.count
    if not out:
        raise AssertionError("torch.profiler recorded no device time")
    return out, launches / calls


def kernel_breakdown(layer, n_head: int) -> dict:
    """Device time per CUDA kernel and kernel launches of one B1 call (fp32
    and bf16) at the sampling batch and of one B3 and one B4 call at the
    training batch, L=100, from ``torch.profiler``; B3's and B4's launches
    must be those their plans count."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        packed = fe.pack_encoder_layer(layer, n_head, dtype)
        x = torch.randn((SAMPLE_CHAINS, MAX_LEN, d), device="cuda").to(dtype)
        with torch.no_grad():
            out[f"B1 {str(dtype).removeprefix('torch.')}"] = device_us_by_kernel(
                lambda: fe.fused_encoder_layer(x, packed, n_head=n_head))
    lay = {k: t.detach() for k, t in fet.pack_encoder_layer_train(layer, n_head).items()}
    x = torch.randn((TRAIN_BATCH, MAX_LEN, d), device="cuda")
    dy = torch.randn_like(x)
    out["B3"] = device_us_by_kernel(lambda: fet._launch_fwd(x, lay, 5, n_head, DROPOUT))
    out["B4"] = device_us_by_kernel(
        lambda: fet._launch_bwd(x, dy, lay, 5, n_head, DROPOUT), calls=5)
    plans = {"B3": fet.train_fwd_plan(TRAIN_BATCH, MAX_LEN, d, n_head, d_ff)["launches"],
             "B4": fet.train_bwd_plan(TRAIN_BATCH, MAX_LEN, d, n_head, d_ff)["launches"]}
    for name, (kernels, launches) in out.items():
        batch = TRAIN_BATCH if name in ("B3", "B4") else SAMPLE_CHAINS
        print(f"  {name} B={batch} L={MAX_LEN}: device us per call by kernel (torch.profiler): "
              f"{json.dumps({k: round(v, 1) for k, v in kernels.items()})}; total "
              f"{sum(kernels.values()):.1f}; {launches} kernel launches per call "
              f"(plan: {plans.get(name, '-')})", flush=True)
        if name in plans and launches != plans[name]:
            raise AssertionError(f"{name}: {launches} kernel launches per call, the plan "
                                 f"counts {plans[name]}")
    return {name: {"device_us_by_kernel": kernels, "launches_per_call": launches}
            for name, (kernels, launches) in out.items()}


def check_kernel(model: ScoreTransformer, dtype: torch.dtype, batch: int) -> dict:
    """B1 on the trained flagship's layer 0 at L=100, with the eval-mode
    ``nn.TransformerEncoderLayer`` yardstick on the same weights."""
    layer0 = model.backbone.layers[0]
    library = torch.nn.TransformerEncoderLayer(
        72, N_HEAD, 2048, batch_first=True
    ).to("cuda").eval()
    library.load_state_dict(layer0.state_dict())
    prior = f"{str(dtype).removeprefix('torch.')} B={batch} L={MAX_LEN}"
    return layer_vs_plain(layer0, N_HEAD, dtype, batch, MAX_LEN, library.to(dtype), prior)


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
    return {"launches": launches, "seconds": seconds, "samples_per_s": rate, "samples": out}


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


def build_all() -> dict:
    """One nvcc per source, all started together; returns the SASS counts
    (instructions, HMMA) of the kernels of B1, B2, B3 and B4 and fails if a
    product kernel has no tensor-core instruction, or if B2's kernel or the
    training tail is missing from them."""
    def one(name: str) -> tuple[str, float, bool]:
        t0 = time.perf_counter()
        cached = _build.library_path(name).exists()
        _build.build(name)
        return name, time.perf_counter() - t0, cached

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    sass = {}
    for name, seconds, cached in results:
        lib = _build.library_path(name)
        log = lib.with_suffix(".log")
        for kernel, usage in ptxas_usage(log.read_text() if log.exists() else ""):
            print(f"  ptxas {name}: {kernel}: {usage}")
        print(f"  {lib.name} ({'reused' if cached else 'built'} in {seconds:.2f} s)", flush=True)
        if name in ("fused_encoder", "flash_attention", "fused_encoder_train"):
            for kernel, counts in sass_counts(lib).items():
                if any(k in kernel for k in PRODUCT_KERNELS + ("attention",)):
                    sass[f"{name}: {kernel}"] = counts
                    print(f"  sass {name}: {kernel}: {counts['instructions']} instructions, "
                          f"{counts['hmma']} HMMA", flush=True)
    no_hmma = [k for k, c in sass.items()
               if any(p in k for p in PRODUCT_KERNELS) and c["hmma"] == 0]
    missing = [f"{lib}: {kernel}" for lib, kernel in REQUIRED_PRODUCT_KERNELS.items()
               if not any(k.startswith(f"{lib}: ") and kernel in k for k in sass)]
    if no_hmma or missing:
        raise AssertionError(f"product kernels without tensor-core instructions: {no_hmma}; "
                             f"missing: {missing}")
    return sass


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, stack/spills") for each kernel in a ``-Xptxas
    -v`` report, the kernel's name demangled by ``c++filt`` where present."""
    out, name, frame = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, f"{regs.group(1) if regs else '?'} registers; {frame}"))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        out = [(kernel_name(d) or n, u) for d, (n, u) in zip(names, out)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


def cuobjdump_path() -> str | None:
    """``cuobjdump`` beside the ``nvcc`` that builds the kernels, if any."""
    path = Path(_build.nvcc_path()).with_name("cuobjdump")
    return str(path) if path.is_file() else None


def sass_counts(library: Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library, from ``cuobjdump -sass``: its SASS
    instructions and its tensor-core instructions (HMMA), the kernel's
    name demangled where ``c++filt`` is present."""
    tool = cuobjdump_path()
    if tool is None:
        raise RuntimeError("cuobjdump not found beside nvcc")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"instructions": 0, "hmma": 0}
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name]["instructions"] += 1
            counts[name]["hmma"] += "HMMA" in line
    try:
        names = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                               text=True, check=True).stdout.split("\n")
        counts = {kernel_name(d) or n: c for d, (n, c) in zip(names, counts.items())}
    except (OSError, subprocess.CalledProcessError):
        pass
    return counts


def check_attention(model: ScoreTransformer, dtype: torch.dtype) -> dict:
    """B2 on the flagship layer 0's q, k, v at the training shape, its time
    beside its time before its redesign (PRIOR_MS), and its device time from
    ``torch.profiler`` (the call's time less that is the host's)."""
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
        err, tol = (out.float() - ref.float()).abs().max().item(), b2_tol(dtype, ref)
        if not (torch.isfinite(out.float()).all() and err <= tol):
            raise AssertionError(f"B2 {dtype}: kernel disagrees with plain version: {err}")
        ulps = err / bf16_ulp(ref.float().abs().max().item())
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        device_us, _ = device_us_by_kernel(lambda: fa.flash_attention(q, k, v))
    size = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(
        4 * TRAIN_BATCH * N_HEAD * MAX_LEN * MAX_LEN * dh, 4 * q.numel() * size, dtype
    )
    r = {"max_abs_err": err, "tol": tol, "err_bf16_ulps_of_max": ulps, "ms": kernel_ms,
         "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "device_us_by_kernel": device_us}
    prior = PRIOR_MS["B2"][f"{str(dtype).removeprefix('torch.')} B={TRAIN_BATCH} H={N_HEAD} "
                           f"L={MAX_LEN} dh={dh}"]
    print(f"  B2 {dtype} B={TRAIN_BATCH}: {json.dumps(r)}; before the redesign {prior} ms, "
          f"1 launch per call", flush=True)
    return r


def b2_tol(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """B2's tolerance against its plain version output ``ref``."""
    if dtype == torch.float32:
        return TOL[dtype]
    return B2_BF16_ULPS * bf16_ulp(ref.float().abs().max().item())


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def attention_vs_plain(b: int, h: int, l: int, dh: int, dtype: torch.dtype) -> dict:
    """B2 on random (b, h, l, dh) heads against its plain version, with the
    times of the kernel, its plain version and SDPA."""
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn((b, h, l, dh), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    shape = f"{str(dtype).removeprefix('torch.')} B={b} H={h} L={l} dh={dh}"
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), b2_tol(dtype, ref)
        if not (torch.isfinite(out.float()).all() and err <= tol):
            raise AssertionError(f"B2 {shape}: kernel disagrees with plain version: {err}")
        r = {"max_abs_err": err, "tol": tol,
             "err_bf16_ulps_of_max": err / bf16_ulp(ref.float().abs().max().item()),
             "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
             "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
             "device_us_by_kernel": device_us_by_kernel(lambda: fa.flash_attention(q, k, v))[0]}
    size = torch.finfo(dtype).bits // 8
    r["bound_ms"], r["bound_by"] = bound(4 * b * h * l * l * dh, 4 * q.numel() * size, dtype)
    print(f"  B2 {shape}: {json.dumps(r)}", flush=True)
    return r


def check_attention_shapes() -> dict:
    """Phase 9's B2: B2_SHAPES in fp32 and bf16."""
    return {f"{str(dtype).removeprefix('torch.')} B={b} H={h} L={l} dh={dh}":
            attention_vs_plain(b, h, l, dh, dtype)
            for b, h, l, dh in B2_SHAPES for dtype in TOL}


def check_train_layer(layer, n_head: int, batch: int, l: int, timed: bool,
                      library: bool = False) -> dict:
    """B3 and B4 on one encoder layer (dropout 0.1) at (batch, l) against
    the plain version and its autograd, with the masks bit for bit; with
    ``timed``, the times of both kernels, the plain versions, their bounds
    and (with ``library``) a train-mode ``nn.TransformerEncoderLayer``."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    shape = f"B={batch} L={l} D={d} H={n_head} F={d_ff}"
    packed = {k: t.detach().requires_grad_(True) for k, t in
              fet.pack_encoder_layer_train(layer, n_head).items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((batch, l, d), generator=g, device="cuda").requires_grad_(True)
    dy = torch.randn((batch, l, d), generator=g, device="cuda")
    seed = 123456789
    kernel_masks = fet.dropout_masks_cuda(batch, l, d, d_ff, n_head, seed, DROPOUT)
    masks = fet.dropout_masks(batch, l, d, d_ff, n_head, seed, DROPOUT, "cuda")
    for key in masks:
        if not torch.equal(kernel_masks[key], masks[key]):
            raise AssertionError(f"{shape}: the {key} masks of the kernel and plain differ")
    inputs = [x, *packed.values()]
    out = fet.fused_encoder_layer_train(x, packed, seed, n_head=n_head, rate=DROPOUT)
    grads = torch.autograd.grad(out, inputs, dy)
    ref = fet.fused_encoder_layer_train_reference(x, packed, seed, n_head=n_head, rate=DROPOUT)
    ref_grads = torch.autograd.grad(ref, inputs, dy, retain_graph=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not (torch.isfinite(out).all() and err <= TRAIN_TOL):
        raise AssertionError(f"B3 {shape}: kernel disagrees with plain version: {err}")
    names = ["x", *packed]
    matched, flips, n_near = gate_matched_grads(
        x, dy, packed, seed, grads[names.index("b1")], masks, n_head)
    rel, abs_err = {}, 0.0
    for name, k, p, m in zip(names, grads, ref_grads, matched):
        abs_err = max(abs_err, (k - p).abs().max().item())
        rel[name] = {"vs_plain": rel_err(k, p), "vs_gate_matched_fp64": rel_err(k, m)}
        r = rel[name]
        if not (r["vs_plain"] <= GRAD_TOL
                or (flips and r["vs_gate_matched_fp64"] <= GRAD_TOL)):
            raise AssertionError(f"B4 {shape}: gradient {name} disagrees: {r}")
    worst = max(r["vs_plain"] for r in rel.values())
    print(f"  B3/B4 {shape}: max |fwd - plain| {err:.3e} (tol {TRAIN_TOL:.0e}); "
          f"max |grad - plain| / max |grad| {worst:.3e}; ReLU gates within rounding of "
          f"0: {n_near}, flips located: {json.dumps(flips)}; per tensor {json.dumps(rel)}",
          flush=True)
    xd, lay = x.detach(), {k: t.detach() for k, t in packed.items()}
    stage_check = check_bwd_stages(xd, dy, lay, seed, n_head, masks, shape)
    r = {"fwd": {"max_abs_err": err},
         "bwd": {"max_abs_err": abs_err, "max_rel_err": worst, "gate_flips": flips,
                 "stages": stage_check}}
    if not timed:
        return r

    first = fet._launch_bwd(xd, dy, lay, seed, n_head, DROPOUT)
    second = fet._launch_bwd(xd, dy, lay, seed, n_head, DROPOUT)
    fwd_first = fet._launch_fwd(xd, lay, seed, n_head, DROPOUT)
    fwd_second = fet._launch_fwd(xd, lay, seed, n_head, DROPOUT)
    torch.cuda.synchronize()
    identical = {"B3": torch.equal(fwd_first, fwd_second),
                 "B4": all(torch.equal(a, b) for a, b in zip([first[0], *first[1]],
                                                             [second[0], *second[1]]))}
    print(f"  B3/B4 {shape}: two calls on the same inputs bit-identical: {identical}",
          flush=True)
    if not all(identical.values()):
        raise AssertionError(f"B3/B4 {shape}: a repeated call gave other results: {identical}")
    del first, second, fwd_first, fwd_second
    r["bwd"]["stage_ms"] = bwd_stage_ms(xd, dy, lay, seed, n_head)
    r["fwd"]["ms"] = time_ms(lambda: fet._launch_fwd(xd, lay, seed, n_head, DROPOUT), iters=20)
    r["bwd"]["ms"] = time_ms(
        lambda: fet._launch_bwd(xd, dy, lay, seed, n_head, DROPOUT), iters=10)
    r["fwd"]["plain_ms"] = time_ms(lambda: fet.fused_encoder_layer_train_reference(
        xd, lay, seed, n_head=n_head, rate=DROPOUT), iters=10)
    r["bwd"]["plain_ms"] = time_ms(
        lambda: torch.autograd.grad(ref, inputs, dy, retain_graph=True), iters=10)
    r["fwd"]["library_ms"] = r["bwd"]["library_ms"] = None
    if library:
        lib = torch.nn.TransformerEncoderLayer(
            d, n_head, d_ff, DROPOUT, batch_first=True).to("cuda").train()
        lib_out = lib(x)
        lib_params = [x, *lib.parameters()]
        r["fwd"]["library_ms"] = time_ms(lambda: lib(x), iters=10)
        r["bwd"]["library_ms"] = time_ms(
            lambda: torch.autograd.grad(lib_out, lib_params, dy, retain_graph=True), iters=10)
    flops = train_layer_flops(batch, l, d, d_ff)
    weights = sum(t.numel() for t in lay.values()) * 4
    act = batch * l * d * 4
    fwd_bound = bound(flops, 2 * act + weights, torch.float32)
    # The backward from (x, dy, weights) recomputes the forward and then
    # does two products for each product of the forward.
    bwd_bound = bound(3 * flops, 3 * act + 2 * weights, torch.float32)
    r["fwd"].update(bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
    r["bwd"].update(bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    key = f"L={l} D={d} H={n_head} F={d_ff}"
    launches = {"B3": fet.train_fwd_plan(batch, l, d, n_head, d_ff)["launches"],
                "B4": fet.train_bwd_plan(batch, l, d, n_head, d_ff)["launches"]}
    print(f"  B3 {shape}: {r['fwd']['ms']:.4f} ms (before the redesign: "
          f"{PRIOR_MS['B3'].get(key)} ms), 3xTF32 bound {tf32x3_bound_ms(flops):.4f} ms, in "
          f"{launches['B3']} CUDA launches per call (its plan)", flush=True)
    print(f"  B4 {shape}: {r['bwd']['ms']:.4f} ms (before the redesign: "
          f"{PRIOR_MS['B4'].get(key)} ms), 3xTF32 bound "
          f"{tf32x3_bound_ms(3 * flops):.4f} ms, in {launches['B4']} CUDA launches per call "
          f"(its plan); per stage {json.dumps(r['bwd']['stage_ms'])}", flush=True)
    print(f"  B3/B4 {shape} times: {json.dumps(r)}", flush=True)
    return r


def check_bwd_stages(x, dy, layer, seed: int, n_head: int, masks, shape: str) -> dict:
    """B4's workspace after each stage (dF2, dx1, da, dqkv), dx and the
    gradients against the staged plain backward (``train_backward_staged``),
    each to GRAD_TOL of its largest, so that a failing gate names its stage.
    ReLU gates that flipped between the two (as in ``gate_matched_grads``)
    are located, must lie within GATE_BAND x sum |terms| of 0, and the
    staged version then takes the kernel's gates."""
    dx, grads, stages = fet._launch_bwd(x, dy, layer, seed, n_head, DROPOUT, stages=True)
    torch.cuda.synchronize()
    _, _, plain = fet.train_backward_staged(x, dy, layer, seed, n_head=n_head, rate=DROPOUT)
    kept = masks["ff"] > 0
    flips = (stages["gates"] != plain["gates"]) & kept
    n_flips = int(flips.sum())
    if n_flips:
        lay64 = {k: t.double() for k, t in layer.items()}
        x1 = fet.attention_sublayer(x.double(), lay64, masks, n_head)
        pre = x1 @ lay64["w1"] + lay64["b1"]
        terms = x1.abs() @ lay64["w1"].abs() + lay64["b1"].abs()
        far = int((pre.abs() > GATE_BAND * terms)[flips].sum())
        if far:
            raise AssertionError(f"B4 {shape}: {far} ReLU gates flipped away from 0")
    gates = stages["gates"] | (~kept & plain["gates"])
    ref_dx, ref_grads, ref = fet.train_backward_staged(x, dy, layer, seed, n_head=n_head,
                                                        rate=DROPOUT, gates=gates)
    rel = {name: rel_err(stages[name], ref[name]) for name in ("df2", "dx1", "da", "dqkv")}
    rel.update({name: rel_err(g, r) for name, g, r in
                zip(["dx", *fet.LAYER_KEYS], [dx, *grads], [ref_dx, *ref_grads])})
    print(f"  B4 {shape} stages against the staged plain version (max |diff| / max, tol "
          f"{GRAD_TOL:.0e}; ReLU gates matched: {n_flips}): {json.dumps(rel)}", flush=True)
    bad = {k: v for k, v in rel.items() if not v <= GRAD_TOL}
    if bad:
        raise AssertionError(f"B4 {shape}: stages disagree with the staged plain version: {bad}")
    return {"max_rel_err": max(rel.values()), "gates_matched": n_flips}


def bwd_stage_ms(x, dy, layer, seed: int, n_head: int, calls: int = 5) -> dict:
    """B4's milliseconds per stage (CUDA events between its launches),
    averaged over ``calls`` calls."""
    total = dict.fromkeys(fet.BWD_STAGES, 0.0)
    for _ in range(calls):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fet.BWD_STAGES) + 1)]
        fet._launch_bwd(x, dy, layer, seed, n_head, DROPOUT, events=events)
        torch.cuda.synchronize()
        for i, name in enumerate(fet.BWD_STAGES):
            total[name] += events[i].elapsed_time(events[i + 1]) / calls
    return total


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


def flagship_model(dtype: str = "float32", rate: float = DROPOUT) -> ScoreTransformer:
    """The flagship with random weights from seed 0 (the same for any dtype)."""
    torch.manual_seed(0)
    model = ScoreModelConfig(
        d_model=72, num_layers=N_LAYERS, n_head=N_HEAD, dim_feedforward=2048,
        dropout_rate=rate, dtype=dtype,
    ).build(n_channels=N_CHANNELS, max_len=MAX_LEN)
    return model.to(getattr(torch, dtype))


def flagship_trainer(plain: bool = False, rate: float = DROPOUT,
                     epochs: int = TRAIN_EPOCHS) -> Trainer:
    model = flagship_model(rate=rate)
    return Trainer(
        model, VPScheduler(fourier_noise_scaling=True), max_epochs=epochs,
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


@contextlib.contextmanager
def kernel_gates(store: dict):
    """Inside the block, each B4 call also stores the FFN ReLU gates it took
    (``h > 0`` where dropout kept the unit), by the layer's seed."""
    launch = fet._launch_bwd

    def recording(x, dy, layer, seed, n_head, rate, events=None, stages=False):
        dx, grads, ws = launch(x, dy, layer, seed, n_head, rate, events=events, stages=True)
        store[seed] = ws["gates"].clone()
        return (dx, grads, ws) if stages else (dx, grads)

    fet._launch_bwd = recording
    try:
        yield
    finally:
        fet._launch_bwd = launch


@contextlib.contextmanager
def plain_gates(record: dict, force: dict | None = None):
    """Inside the block, the plain training layer of the fused path records,
    by the layer's seed, its FFN pre-activations, their sums of |terms|,
    its gates and the kept units; with ``force`` ({seed: gates}) it takes
    those gates (the value keeps its size, the gradient passes an open gate
    and not a shut one). Without ``force`` it computes what
    ``fused_encoder_layer_train_reference`` computes, in the same order."""
    reference = fused_models.fused_encoder_layer_train_reference

    def layer_fn(x, layer, seed, *, n_head, rate):
        b, l, d = x.shape
        masks = fet.dropout_masks(b, l, d, layer["w1"].shape[1], n_head, seed, rate, x.device)
        x1 = fet.attention_sublayer(x, layer, masks, n_head)
        pre = x1 @ layer["w1"] + layer["b1"]
        with torch.no_grad():
            terms = x1.abs() @ layer["w1"].abs() + layer["b1"].abs()
        record[seed] = (pre.detach(), terms, pre.detach() > 0, masks["ff"] > 0)
        hidden = torch.relu(pre) if force is None else pre * force[seed]
        return fet.ffn_sublayer(x1, hidden, layer, masks)

    fused_models.fused_encoder_layer_train_reference = layer_fn
    try:
        yield
    finally:
        fused_models.fused_encoder_layer_train_reference = reference


def check_training(dm: SyntheticDatamodule) -> dict:
    """The first steps through the kernels and through the plain versions.
    The step-0 gradients are held to GRAD_TOL per tensor against the plain
    path's or, where FFN ReLU gates flipped between the two paths, against
    the plain path with exactly the kernels' gates (as phase 11 does for the
    unfused path); every flip is located, printed and must lie within
    GATE_BAND x sum |terms| of 0."""
    steps = draw_steps(dm, CHECK_STEPS)
    kernel, plain = flagship_trainer(), flagship_trainer(plain=True)
    n_steps = dm.steps_per_epoch * TRAIN_EPOCHS
    losses, grads, k_gates, p_record = {}, {}, {}, {}
    for name, trainer in (("kernel", kernel), ("plain", plain)):
        trainer.start(n_steps)
        with kernel_gates(k_gates), plain_gates(p_record):
            grads[name] = trainer.loss_and_grads(*steps[0])[1]
        losses[name] = [trainer.train_step(*step).item() for step in steps]
    located, force = [], {}
    for seed, (pre, terms, gates, kept) in p_record.items():
        flips = (k_gates[seed] != gates) & kept
        force[seed] = k_gates[seed] | (gates & ~kept)
        for b, l, u in flips.nonzero().tolist():
            located.append({"layer_seed": seed, "chain": b, "row": l, "unit": u,
                            "pre_plain": pre[b, l, u].item(), "terms": terms[b, l, u].item(),
                            "kernel_open": bool(k_gates[seed][b, l, u])})
    del k_gates, p_record
    far = [f for f in located if abs(f["pre_plain"]) > GATE_BAND * f["terms"]]
    if far:
        raise AssertionError(f"training check: ReLU gates flipped away from 0: {far}")
    grads["gate_matched"] = grads["plain"]
    if located:
        matched = flagship_trainer(plain=True)
        matched.start(n_steps)
        with plain_gates({}, force):
            grads["gate_matched"] = matched.loss_and_grads(*steps[0])[1]
    del force
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
    for name, k, p, m, e in zip(kernel.names, grads["kernel"], grads["plain"],
                                grads["gate_matched"], grads["fp64"]):
        rel[name] = {"vs_plain": rel_err(k, p), "vs_gate_matched": rel_err(k, m),
                     "kernel_vs_fp64": rel_err(k, e), "plain_vs_fp64": rel_err(p, e)}
        r = rel[name]
        if not (r["vs_plain"] <= GRAD_TOL or (located and r["vs_gate_matched"] <= GRAD_TOL)):
            raise AssertionError(f"training check: gradient {name} disagrees: {r}")
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_plain"])
    worst_m = max(r["vs_gate_matched"] for r in rel.values())
    print(f"  step-0 gradients: worst against plain {worst[0]} {json.dumps(worst[1])}, worst "
          f"against gate-matched plain {worst_m:.3e} (tol {GRAD_TOL:.0e}); ReLU gates flipped "
          f"between the paths: {len(located)}: {json.dumps(located)}; per tensor "
          f"{json.dumps(rel)}", flush=True)
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_plain"],
            "grad_rel_err_gate_matched": worst_m, "gate_flips": located}


def run_training(dm: SyntheticDatamodule) -> dict:
    """The training main path; the counts are read around ``fit`` alone."""
    trainer = flagship_trainer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.fit(dm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = dm.steps_per_epoch * TRAIN_EPOCHS
    val_batches = -(-TRAIN_SERIES // TRAIN_BATCH)
    expected = {"B3": steps * N_LAYERS, "B4": steps * N_LAYERS,
                "B2": TRAIN_EPOCHS * val_batches * VAL_DRAWS * N_LAYERS,
                "B1": 0, "B5": 0, "B6-fwd": 0, "B6-bwd": 0, "B7": 0, "B8": 0}
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
         "epoch_steps_per_sec": [h["steps_per_sec"] for h in history],
         "val_pass_s": val_s / TRAIN_EPOCHS, "losses": [
             (h["train/loss"], h["val/loss"]) for h in history]}
    print(f"  training: {steps} steps in {train_s:.3f} s = {r['steps_per_s']:.3f} steps/s "
          f"({r['step_ms']:.2f} ms/step); validation {r['val_pass_s']:.3f} s per pass; "
          f"launches {counts}", flush=True)
    return r


def check_coverage(phase3: dict) -> dict:
    """B1 (fp32, bf16), B3 and B4 at the long and wide shapes (COVERAGE),
    at B=8, random weights; B1's times beside phase 3's."""
    out = {}
    for l, d, n_head, d_ff in COVERAGE:
        torch.manual_seed(0)
        layer = TransformerEncoderLayer(d, n_head, d_ff).to("cuda")
        key = f"L={l} D={d} H={n_head} F={d_ff}"
        out[key] = {
            "B1": {str(dtype).removeprefix("torch."): layer_vs_plain(
                layer, n_head, dtype, COVERAGE_BATCH, l,
                prior=f"{str(dtype).removeprefix('torch.')} {key}") for dtype in TOL},
            **check_train_layer(layer, n_head, COVERAGE_BATCH, l, timed=True),
        }
        plan = fet.train_bwd_plan(COVERAGE_BATCH, l, d, n_head, d_ff)
        fwd_plan = fet.train_fwd_plan(COVERAGE_BATCH, l, d, n_head, d_ff)
        sizes = {"B1 tail smem bytes (fp32, bf16)": [
                     fe.tail_plan(d, t)["bytes"] for t in TOL],
                 "B3 tail smem bytes": fwd_plan["tail"]["bytes"],
                 "B3 workspace floats": fwd_plan["workspace_floats"],
                 "B4 tail smem bytes": plan["tail"]["bytes"],
                 "B4 workspace floats": plan["workspace_floats"]}
        out[key]["sizes"] = sizes
        print(f"  {key}: {json.dumps(sizes)}", flush=True)
    for dtype, by_batch in phase3.items():
        name = str(dtype).removeprefix("torch.")
        times = {f"L={MAX_LEN} B={b}": round(c["kernel_ms"], 4) for b, c in by_batch.items()}
        times.update({f"{k} B={COVERAGE_BATCH}": round(v["B1"][name]["kernel_ms"], 4)
                      for k, v in out.items()})
        print(f"  B1 {name} ms: {json.dumps(times)}", flush=True)
    return out


def sdpa_backend(q, k, v, dropout_p: float) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these inputs."""
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, None, dropout_p, False)).name
    except Exception as e:  # a private API: report, never fail on it
        return f"unknown ({type(e).__name__}: {e})"


def check_attention_kernels(b: int, l: int, timed: bool) -> dict:
    """B5, B6-fwd and B6-bwd on random fp32 (b, 12, l, 6) heads against their
    plain versions (and B5 also against autograd of the plain forward), the
    masks bit for bit; with ``timed``, their times, bounds and yardsticks,
    and B2's time on the same heads beside SDPA's."""
    dh = 72 // N_HEAD
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((b, N_HEAD, l, dh), generator=g, device="cuda")
                   for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    shape = f"B={b} H={N_HEAD} L={l} dh={dh}"
    kernel_keep = fa.attention_keep_cuda(b, N_HEAD, l, seed, DROPOUT)
    if not torch.equal(kernel_keep, fa.attention_keep(b, N_HEAD, l, seed, DROPOUT, "cuda")):
        raise AssertionError(f"B6 {shape}: the masks of the kernel and plain differ")
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    autograd_plain = torch.autograd.grad(fa.flash_attention_reference(qg, kg, vg),
                                         (qg, kg, vg), do)
    b5, b5_plain = fa._launch_bwd(q, k, v, do), fa.flash_attention_bwd_reference(q, k, v, do)
    b6f = fa._launch_fwd(q, k, v, seed, DROPOUT)
    b6f_plain = fa.flash_attention_dropout_reference(q, k, v, seed, DROPOUT)
    b6b = fa._launch_bwd(q, k, v, do, seed, DROPOUT)
    b6b_plain = fa.flash_attention_dropout_bwd_reference(q, k, v, do, seed, DROPOUT)
    torch.cuda.synchronize()
    grads = ("dq", "dk", "dv")
    r = {
        "B5": {"max_rel_err": {n: rel_err(a, p) for n, a, p in zip(grads, b5, b5_plain)},
               "vs_autograd_of_plain": {n: rel_err(a, p) for n, a, p in
                                        zip(grads, b5, autograd_plain)},
               "max_abs_err": max((a - p).abs().max().item() for a, p in zip(b5, b5_plain))},
        "B6-fwd": {"max_abs_err": (b6f - b6f_plain).abs().max().item()},
        "B6-bwd": {"max_rel_err": {n: rel_err(a, p) for n, a, p in zip(grads, b6b, b6b_plain)},
                   "max_abs_err": max((a - p).abs().max().item()
                                      for a, p in zip(b6b, b6b_plain))},
    }
    if not (torch.isfinite(b6f).all() and r["B6-fwd"]["max_abs_err"] <= ATTN_TOL):
        raise AssertionError(f"B6-fwd {shape}: kernel disagrees with plain version: {r}")
    for name in ("B5", "B6-bwd"):
        worst = max(r[name]["max_rel_err"].values())
        if not worst <= GRAD_TOL:
            raise AssertionError(f"{name} {shape}: kernel disagrees with plain version: {r}")
    if not max(r["B5"]["vs_autograd_of_plain"].values()) <= GRAD_TOL:
        raise AssertionError(f"B5 {shape}: kernel disagrees with autograd of plain: {r}")
    print(f"  B5/B6 {shape}: masks bit for bit; {json.dumps(r)} (outputs tol {ATTN_TOL:.0e}, "
          f"gradients tol {GRAD_TOL:.0e} of max)", flush=True)
    if not timed:
        return r

    numel = q.numel()
    fwd_flops, bwd_flops = 4 * b * N_HEAD * l * l * dh, 12 * b * N_HEAD * l * l * dh
    with torch.no_grad():
        b2 = fa._launch_fwd(q, k, v)
        r["B2"] = {"max_abs_err": (b2 - fa.flash_attention_reference(q, k, v)).abs().max().item(),
                   "ms": time_ms(lambda: fa._launch_fwd(q, k, v)),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
        if not r["B2"]["max_abs_err"] <= ATTN_TOL:
            raise AssertionError(f"B2 {shape}: kernel disagrees with plain version: {r['B2']}")
        r["B6-fwd"].update(
            ms=time_ms(lambda: fa._launch_fwd(q, k, v, seed, DROPOUT)),
            plain_ms=time_ms(lambda: fa.flash_attention_dropout_reference(q, k, v, seed,
                                                                          DROPOUT)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                      dropout_p=DROPOUT)),
        )
    r["B5"].update(ms=time_ms(lambda: fa._launch_bwd(q, k, v, do)),
                   plain_ms=time_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, do)))
    r["B6-bwd"].update(
        ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, seed, DROPOUT)),
        plain_ms=time_ms(lambda: fa.flash_attention_dropout_bwd_reference(q, k, v, do, seed,
                                                                          DROPOUT)))
    for name, p in (("B5", 0.0), ("B6-bwd", DROPOUT)):
        out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p)
        r[name]["library_ms"] = time_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    for name, flops, bytes_ in (("B5", bwd_flops, 7 * numel * 4),
                                ("B6-fwd", fwd_flops, 4 * numel * 4 + 8),
                                ("B6-bwd", bwd_flops, 7 * numel * 4 + 8)):
        r[name]["bound_ms"], r[name]["bound_by"] = bound(flops, bytes_, torch.float32)
    r["sdpa_backend"] = {"no dropout": sdpa_backend(qg, kg, vg, 0.0),
                         f"dropout {DROPOUT}": sdpa_backend(qg, kg, vg, DROPOUT)}
    print(f"  B5/B6 {shape} times: {json.dumps(r)}", flush=True)
    return r


@contextlib.contextmanager
def environ(name: str, value: str):
    """``name=value`` in the environment inside the block."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def unfused_training():
    """``FDIFF_FUSED_TRAIN=0`` inside the block: the trainer's unfused path."""
    return environ("FDIFF_FUSED_TRAIN", "0")


def unfused_step0(trainer: Trainer, step: tuple, force: dict | None = None) -> tuple:
    """Step-0 gradients of the unfused path, drawing from a generator seeded
    17, with every layer's FFN ReLU gates recorded by a hook on ``linear1``:
    the gates (pre-activation > 0), the pre-activations and their sums of
    |terms| (|x| |W1| + |b1|). ``force`` {layer: (where, open)} sets the gates
    at ``where`` to ``open`` (the value keeps its size, the gradient passes
    through an open gate and not a shut one)."""
    gates, pres, terms, handles = {}, {}, {}, []

    def hook(i: int):
        def record(mod, inputs, out):
            pres[i] = out.detach()
            gates[i] = pres[i] > 0
            terms[i] = (inputs[0].detach().abs() @ mod.weight.detach().abs().t()
                        + mod.bias.detach().abs())
            if force is not None and i in force:
                where, want_open = force[i]
                size = out.detach().abs().clamp_min(1e-30)
                forced = out - out.detach() + torch.where(want_open, size, -size)
                return torch.where(where, forced, out)
            return None
        return record

    for i, layer in enumerate(trainer.model.backbone.layers):
        handles.append(layer.linear1.register_forward_hook(hook(i)))
    try:
        x0, t0, z0, _ = step
        gen = torch.Generator(device=trainer.device).manual_seed(17)
        grads = trainer.loss_and_grads(x0, t0, z0, generator=gen)[1]
    finally:
        for h in handles:
            h.remove()
    return grads, gates, pres, terms


def check_unfused_training(dm: SyntheticDatamodule, rate: float) -> dict:
    """The first steps of unfused training through the kernels and through
    ``plain=True``, with generators seeded alike (the same attention seeds
    and FFN-site draws). The step-0 gradients are held to GRAD_TOL per tensor
    against the plain path's or, where FFN ReLU gates flipped between the
    two paths, against the plain path with exactly those gates set as the
    kernel path had them; every flip is located, printed and must lie within
    GATE_BAND x sum |terms| of 0 (as B4's gate, above)."""
    steps = draw_steps(dm, CHECK_STEPS)
    n_steps = dm.steps_per_epoch * TRAIN_EPOCHS
    with unfused_training():
        kernel = flagship_trainer(rate=rate)
        plain = flagship_trainer(plain=True, rate=rate)
        for trainer in (kernel, plain):
            trainer.start(n_steps)
        grads_k, gates_k, _, _ = unfused_step0(kernel, steps[0])
        grads_p, gates_p, pres, terms = unfused_step0(plain, steps[0])
        flips = {i: gates_k[i] ^ gates_p[i] for i in gates_k if (gates_k[i] ^ gates_p[i]).any()}
        located = []
        for i, where in flips.items():
            for b, l, u in where.nonzero().tolist():
                located.append({"layer": i, "chain": b, "row": l, "unit": u,
                                "pre_plain": pres[i][b, l, u].item(),
                                "terms": terms[i][b, l, u].item(),
                                "kernel_open": bool(gates_k[i][b, l, u])})
        far = [f for f in located if abs(f["pre_plain"]) > GATE_BAND * f["terms"]]
        if far:
            raise AssertionError(f"unfused check: ReLU gates flipped away from 0: {far}")
        grads_m = grads_p
        if flips:
            force = {i: (where, gates_k[i]) for i, where in flips.items()}
            grads_m = unfused_step0(plain, steps[0], force)[0]
        del gates_k, gates_p, pres, terms
        losses = {}
        for name, trainer in (("kernel", kernel), ("plain", plain)):
            gen = torch.Generator(device="cuda").manual_seed(18)
            losses[name] = [trainer.train_step(x, t, z, generator=gen).item()
                            for x, t, z, _ in steps]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"]))
    print(f"  unfused, dropout {rate}: losses kernel {losses['kernel']} plain "
          f"{losses['plain']}: max rel diff {rel_loss:.3e} (tol {LOSS_TOL:.0e})", flush=True)
    if not all(math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        raise AssertionError(f"unfused check: losses not finite: {losses}")
    if not rel_loss <= LOSS_TOL:
        raise AssertionError(f"unfused check: losses disagree: {rel_loss}")
    rel = {n: {"vs_plain": rel_err(k, p), "vs_gate_matched": rel_err(k, m)}
           for n, k, p, m in zip(kernel.names, grads_k, grads_p, grads_m)}
    for n, r in rel.items():
        if not (r["vs_plain"] <= GRAD_TOL or (flips and r["vs_gate_matched"] <= GRAD_TOL)):
            raise AssertionError(f"unfused check: gradient {n} disagrees: {r}")
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_plain"])
    worst_m = max(r["vs_gate_matched"] for r in rel.values())
    print(f"  unfused, dropout {rate}: step-0 gradients, worst against plain {worst[0]} "
          f"{json.dumps(worst[1])}, worst against gate-matched plain {worst_m:.3e} (tol "
          f"{GRAD_TOL:.0e}); ReLU gates flipped between the paths: {len(located)}: "
          f"{json.dumps(located)}; per tensor {json.dumps(rel)}", flush=True)
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_plain"],
            "grad_rel_err_gate_matched": worst_m, "gate_flips": located}


def reset_counts() -> None:
    fet.fwd_launches = fet.bwd_launches = fe.launches = 0
    fe.int8_launches = fe.int8_attn_launches = 0
    fa.launches = fa.bwd_launches = fa.dropout_fwd_launches = fa.dropout_bwd_launches = 0


def read_counts() -> dict:
    return {"B1": fe.launches, "B2": fa.launches, "B3": fet.fwd_launches,
            "B4": fet.bwd_launches, "B5": fa.bwd_launches,
            "B6-fwd": fa.dropout_fwd_launches, "B6-bwd": fa.dropout_bwd_launches,
            "B7": fe.int8_launches, "B8": fe.int8_attn_launches}


def run_unfused_training(dm: SyntheticDatamodule, rate: float) -> dict:
    """The unfused training main path; the counts are read around ``fit`` alone."""
    trainer = flagship_trainer(rate=rate, epochs=UNFUSED_EPOCHS)
    with unfused_training():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        history = trainer.fit(dm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    steps = dm.steps_per_epoch * UNFUSED_EPOCHS
    train = steps * N_LAYERS
    val = UNFUSED_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH) * VAL_DRAWS * N_LAYERS
    expected = {"B1": 0, "B3": 0, "B4": 0, "B7": 0, "B8": 0}
    if rate > 0.0:
        expected.update({"B2": val, "B5": 0, "B6-fwd": train, "B6-bwd": train})
    else:
        expected.update({"B2": train + val, "B5": train, "B6-fwd": 0, "B6-bwd": 0})
    for h in history:
        print(f"  unfused, dropout {rate}, epoch {h['epoch']}: {json.dumps(h)}", flush=True)
    if counts != expected:
        raise AssertionError(f"unfused training: launches {counts}, expected {expected}")
    if len(history) != UNFUSED_EPOCHS or not all(
        math.isfinite(h["train/loss"]) and math.isfinite(h["val/loss"]) for h in history
    ):
        raise AssertionError(f"unfused training: epochs or losses wrong: {history}")
    if not all(torch.isfinite(p).all() for p in trainer.params):
        raise AssertionError("unfused training: parameters are not finite")
    train_s = sum(h["train_seconds"] for h in history)
    r = {"launches": counts, "seconds": seconds, "steps": steps,
         "steps_per_s": steps / train_s, "step_ms": 1e3 * train_s / steps,
         "epoch_steps_per_sec": [h["steps_per_sec"] for h in history],
         "val_pass_s": sum(h["val_seconds"] for h in history) / UNFUSED_EPOCHS,
         "losses": [(h["train/loss"], h["val/loss"]) for h in history]}
    print(f"  unfused, dropout {rate}: {steps} steps in {train_s:.3f} s = "
          f"{r['steps_per_s']:.3f} steps/s ({r['step_ms']:.2f} ms/step); launches {counts}",
          flush=True)
    return r


def int8_bound_ms(b: int, l: int, d: int, d_ff: int, dtype: torch.dtype,
                  level: int) -> tuple[float, str]:
    """Least time for one B7/B8 call: the int8 products at the int8 rate plus
    the others at the rate of the input dtype, or the bytes (x in, y out,
    codes, scales, the dtype's weights and the fp32 vectors read once) over
    the memory rate, whichever is larger."""
    size = torch.finfo(dtype).bits // 8
    ffn, qkv, out = 4 * b * l * d * d_ff, 2 * b * l * 3 * d * d, 2 * b * l * d * d
    s_dot = pv = 2 * b * l * l * d
    int8_ops = ffn + (qkv + out + pv if level == 2 else 0)
    other_ops = s_dot + (0 if level == 2 else qkv + out + pv)
    t_ops = int8_ops / PEAK_INT8_OPS + other_ops / PEAK_FLOPS[dtype]
    codes = 2 * d * d_ff + (4 * d * d if level == 2 else 0)
    dtype_weights = 0 if level == 2 else 4 * d * d * size
    scales = 4 * (d_ff + d + (4 * d if level == 2 else 0))
    vectors = 4 * (3 * d + d + 4 * d + d_ff + d)
    t_bytes = (2 * b * l * d * size + codes + dtype_weights + scales + vectors) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_int8_flips(flips: dict, dtype: torch.dtype, what: str,
                     same_inputs: bool = True) -> None:
    """The located flips against INT8_FLIP_BAND and its companions. Where
    the two versions did not start from the same layer input (along a
    trajectory, each follows its own states), only the step of one code is
    held."""
    for site, f in flips.items():
        if not same_inputs:
            ok = f["max_step"] <= 1
        elif site in INT8_EXACT_SITES:
            ok = f["flipped"] == 0
        elif dtype == torch.float32:
            ok = f["max_step"] <= 1 and f["max_dist"] <= INT8_FLIP_BAND
        else:
            ok = f["flipped"] <= INT8_BF16_FLIP_SHARE * f["codes"]
        if not ok:
            raise AssertionError(f"{what}: site {site}: codes flipped out of bounds: {f}")


def check_int8_layer(layer, n_head: int, dtype: torch.dtype, batch: int, l: int, level: int,
                     b1_ms: float) -> dict:
    """B7 (level 1) or B8 (level 2) on one encoder layer at (batch, l): the
    kernel against its plain version with the kernel's codes put in, every
    flipped code located, and the times of the kernel and its plain version
    beside B1's (``b1_ms``) and the bound."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    packed = fe.pack_encoder_layer(layer, n_head, dtype, int8_ffn=True, int8_attn=level == 2)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, l, d), generator=g, device="cuda").to(dtype)
    what = f"{INT8_NAMES[level]} {dtype} B={batch} L={l} D={d} H={n_head} F={d_ff}"
    with torch.no_grad():
        out = fe.fused_encoder_layer(x, packed, n_head=n_head)
        codes = fe.int8_codes_buffers(x, packed, n_head)
        probed = fe.launch_int8(x, packed, n_head, probe=codes)
        plain = fe.fused_encoder_layer_plain(x, packed, n_head=n_head)
        matched, flips = fe.locate_code_flips(x, packed, n_head, codes)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{what}: kernel output is not finite")
        if not torch.equal(out, probed):
            raise AssertionError(f"{what}: the probe changed the kernel's output")
        err = (out.float() - matched.float()).abs().max().item()
        err_plain = (out.float() - plain.float()).abs().max().item()
        print(f"  {what}: max |kernel - plain with the kernel's codes| = {err:.3e} (tol "
              f"{TOL[dtype]:.3e}); max |kernel - plain| = {err_plain:.3e}; flips per site "
              f"{json.dumps(flips)}", flush=True)
        if not err <= TOL[dtype]:
            raise AssertionError(f"{what}: kernel disagrees with plain version: {err}")
        check_int8_flips(flips, dtype, what)
        kernel_ms = time_ms(lambda: fe.fused_encoder_layer(x, packed, n_head=n_head))
        plain_ms = time_ms(lambda: fe.fused_encoder_layer_plain(x, packed, n_head=n_head),
                           iters=10, warmup=2)
    bound_ms, bound_by = int8_bound_ms(batch, l, d, d_ff, dtype, level)
    print(f"  {what}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, B1 {b1_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"max_abs_err": err, "max_abs_err_vs_plain": err_plain, "tol": TOL[dtype],
            "flips": flips, "ms": kernel_ms, "plain_ms": plain_ms, "b1_ms": b1_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_int8_kernels(phase3: dict, coverage: dict) -> dict:
    """Phase 13: B7 and B8 on the trained layer 0 at L=100 (B=64, 32) and at
    phase 9's shapes (B=8, random weights), fp32 and bf16."""
    out: dict = {level: {} for level in INT8_LEVELS}
    for dtype in TOL:
        name = str(dtype).removeprefix("torch.")
        layer0 = load_flagship(dtype, "cuda").backbone.layers[0]
        for level in INT8_LEVELS:
            for b in KERNEL_BATCHES:
                out[level][f"{name} L={MAX_LEN} D=72 B={b}"] = check_int8_layer(
                    layer0, N_HEAD, dtype, b, MAX_LEN, level, phase3[dtype][b]["kernel_ms"])
    for l, d, n_head, d_ff in COVERAGE:
        torch.manual_seed(0)
        layer = TransformerEncoderLayer(d, n_head, d_ff).to("cuda")
        key = f"L={l} D={d} H={n_head} F={d_ff}"
        for dtype in TOL:
            name = str(dtype).removeprefix("torch.")
            for level in INT8_LEVELS:
                out[level][f"{name} {key} B={COVERAGE_BATCH}"] = check_int8_layer(
                    layer, n_head, dtype, COVERAGE_BATCH, l, level,
                    coverage[key]["B1"][name]["kernel_ms"])
    lib = fe._int8_library()
    sizes = {f"{INT8_NAMES[level]} L={l} D={d}": {
        "smem bytes": lib.fdiff_encoder_layer_int8_smem_bytes(level - 1, l, d),
        "K|V workspace floats per chain": lib.fdiff_encoder_layer_int8_kv_floats(level - 1, l, d)}
        for level in INT8_LEVELS for l, d in ((MAX_LEN, 72), (187, 72), (365, 72), (187, 128))}
    print(f"  int8 plans: {json.dumps(sizes)}", flush=True)
    return out


def run_int8_main_path(level: int, bf16: dict) -> dict:
    """Phase 4's bf16 sampler with FDIFF_FUSED_INT8=level: every layer of
    every step through B7 (level 1) or B8 (level 2), none through B1; the
    samples against phase 4's bf16 ones, drawn with the same generator."""
    with environ("FDIFF_FUSED_INT8", str(level)):
        model = load_flagship(torch.bfloat16, "cuda")
        sampler = DiffusionSampler(
            model, VPScheduler(fourier_noise_scaling=True), max_len=MAX_LEN,
            n_channels=N_CHANNELS, sample_batch_size=SAMPLE_CHAINS, method="em", device="cuda",
        )
        g = torch.Generator(device="cuda").manual_seed(42)
        sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=2, generator=g)  # as phase 4
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=SAMPLE_STEPS, generator=g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    name = INT8_NAMES[level]
    expected = {k: 0 for k in counts}
    expected[name] = SAMPLE_STEPS * N_LAYERS
    if counts != expected:
        raise AssertionError(f"int8 level {level}: launches {counts}, expected {expected}")
    if tuple(out.shape) != (SAMPLE_CHAINS, MAX_LEN, N_CHANNELS) or not (
        torch.isfinite(out).all() and torch.isfinite(fourier.idft(out)).all()
    ):
        raise AssertionError(f"int8 level {level}: samples wrong or not finite")
    ref = bf16["samples"]
    rel = ((out - ref).norm() / ref.norm()).item()
    rate = SAMPLE_CHAINS / seconds
    print(f"  int8 level {level} ({name}), bf16: {SAMPLE_CHAINS} chains x {SAMPLE_STEPS} steps "
          f"in {seconds:.3f} s = {rate:.3f} samples/s (bf16 B1, phase 4: "
          f"{bf16['samples_per_s']:.3f}); launches {counts}; relative L2 distance from the "
          f"bf16 samples {rel:.4e}", flush=True)
    return {"launches": counts[name], "seconds": seconds, "samples_per_s": rate,
            "rel_l2_vs_bf16": rel}


def recording_layer(record: list) -> fe.LayerFn:
    """A layer function that launches B7/B8 with the probe and appends each
    call's int8 codes to ``record``."""
    def layer_fn(h, layer, *, n_head):
        codes = fe.int8_codes_buffers(h, layer, n_head)
        out = fe.launch_int8(h, layer, n_head, probe=codes)
        record.append(codes)
        return out
    return layer_fn


def matched_layer(record: list, flips: dict) -> fe.LayerFn:
    """A layer function that runs the plain B7/B8 version with the codes of
    ``record``, in order, put in (``locate_code_flips``), merging the
    located flips into ``flips``."""
    calls = iter(record)

    def layer_fn(h, layer, *, n_head):
        codes = {k: v.to(h.device) for k, v in next(calls).items()}
        out, located = fe.locate_code_flips(h, layer, n_head, codes)
        for site, f in located.items():
            acc = flips.setdefault(site, {"codes": 0, "flipped": 0, "max_step": 0,
                                          "max_dist": 0.0})
            acc["codes"] += f["codes"]
            acc["flipped"] += f["flipped"]
            acc["max_step"] = max(acc["max_step"], f["max_step"])
            acc["max_dist"] = max(acc["max_dist"], f["max_dist"])
        return out
    return layer_fn


def check_int8_trajectory(level: int) -> dict:
    """Phase 5's 20-step fp32 trajectory at int8 level ``level``: through the
    kernel (B7/B8) on the main path's route, and through the plain versions
    on the card and on the CPU with the kernel's codes of every layer and
    step put in, each flip located; pairwise within TRAJ_TOL, each flip by
    one code. The plain versions' own trajectories, whose codes part from
    the kernel's where an fp32 input lies on a rounding boundary, are
    printed beside them."""
    model = load_flagship(torch.float32, "cuda")
    cpu_model = load_flagship(torch.float32, "cpu")
    scheduler = VPScheduler(fourier_noise_scaling=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAJ_CHAINS, MAX_LEN, N_CHANNELS)
    x_T = scheduler.prior_sampling(shape, generator=g, device="cuda")
    z = torch.randn((TRAJ_STEPS, *shape), generator=g, device="cuda")
    packed, packed_cpu = pack_score_transformer(model, level), pack_score_transformer(
        cpu_model, level)
    kw = dict(num_diffusion_steps=TRAJ_STEPS)

    def run(m, p, x0, zs, layer_fn=fe.fused_encoder_layer):
        return reverse_diffusion(
            lambda x, t: fused_score_forward(m, p, x, t, layer_fn=layer_fn), scheduler, x0,
            z=zs, **kw).cpu()

    reset_counts()
    kernel = run(model, packed, x_T, z)
    counts = read_counts()
    record: list = []
    recorded = run(model, packed, x_T, z, recording_layer(record))
    flips_card: dict = {}
    flips_cpu: dict = {}
    trajs = {
        "kernel": kernel,
        "plain_card_kernel_codes": run(model, packed, x_T, z, matched_layer(record, flips_card)),
        "plain_cpu_kernel_codes": run(cpu_model, packed_cpu, x_T.cpu(), z.cpu(),
                                      matched_layer(record, flips_cpu)),
    }
    own = {"plain_card": run(model, packed, x_T, z, fe.fused_encoder_layer_plain),
           "plain_cpu": run(cpu_model, packed_cpu, x_T.cpu(), z.cpu(),
                            fe.fused_encoder_layer_plain)}
    name = INT8_NAMES[level]
    if counts[name] != TRAJ_STEPS * N_LAYERS or counts["B1"]:
        raise AssertionError(f"int8 trajectory level {level}: launches {counts}")
    if not torch.equal(kernel, recorded):
        raise AssertionError(f"int8 trajectory level {level}: the probe changed the samples")

    def dist(a: torch.Tensor, b: torch.Tensor) -> dict:
        return {"max_abs": (a - b).abs().max().item(),
                "rel_l2": ((a - b).norm() / b.norm()).item()}

    names = list(trajs)
    diffs = {f"{a}_vs_{b}": dist(trajs[a], trajs[b])
             for i, a in enumerate(names) for b in names[i + 1:]}
    own_diffs = {"kernel_vs_plain_card": dist(kernel, own["plain_card"]),
                 "kernel_vs_plain_cpu": dist(kernel, own["plain_cpu"]),
                 "plain_card_vs_plain_cpu": dist(own["plain_card"], own["plain_cpu"])}
    print(f"  int8 level {level} ({name}) fp32 trajectories, the plain versions with the "
          f"kernel's codes: {json.dumps(diffs)} (max abs tol {TRAJ_TOL:.0e} each); codes "
          f"flipped along the trajectory, card {json.dumps(flips_card)}, CPU "
          f"{json.dumps(flips_cpu)}; the plain versions with their own codes: "
          f"{json.dumps(own_diffs)}", flush=True)
    for where, flips in (("card", flips_card), ("CPU", flips_cpu)):
        check_int8_flips(flips, torch.float32, f"int8 trajectory level {level} ({where})",
                         same_inputs=False)
    if not all(d["max_abs"] <= TRAJ_TOL for d in diffs.values()):
        raise AssertionError(f"int8 trajectories disagree: {diffs}")
    return {"with_kernel_codes": diffs, "flips_card": flips_card, "flips_cpu": flips_cpu,
            "with_own_codes": own_diffs}


def run_pc_main_path() -> dict:
    """Phase 15: the pc250 sampler with the divergence guard, bf16, through
    B1: K x (1 + corrector steps) x 10 launches per draw of the batch."""
    model = load_flagship(torch.bfloat16, "cuda")
    sampler = DiffusionSampler(
        model, VPScheduler(fourier_noise_scaling=True), max_len=MAX_LEN, n_channels=N_CHANNELS,
        sample_batch_size=SAMPLE_CHAINS, method="pc", corrector_steps=PC_CORRECTOR_STEPS,
        snr=PC_SNR, divergence_threshold=DIVERGENCE_THRESHOLD, device="cuda",
    )
    g = torch.Generator(device="cuda").manual_seed(42)
    sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=2, generator=g)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=PC_STEPS, generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    stats = dict(sampler.last_resample_stats)
    per_draw = PC_STEPS * (1 + PC_CORRECTOR_STEPS) * N_LAYERS
    expected = {k: 0 for k in counts}
    expected["B1"] = per_draw * (1 + stats["redraws"])
    if counts != expected:
        raise AssertionError(f"pc: launches {counts}, expected {expected} (guard {stats})")
    if tuple(out.shape) != (SAMPLE_CHAINS, MAX_LEN, N_CHANNELS) or not torch.isfinite(
            out).all():
        raise AssertionError("pc: samples wrong or not finite")
    rate = SAMPLE_CHAINS / seconds
    print(f"  pc{PC_STEPS}, bf16, guard at {DIVERGENCE_THRESHOLD}: {SAMPLE_CHAINS} chains in "
          f"{seconds:.3f} s = {rate:.3f} samples/s; B1 launches {counts['B1']} = {per_draw} x "
          f"(1 + {stats['redraws']} redraws); last_resample_stats {json.dumps(stats)}; "
          f"largest |x| {out.abs().max().item():.3f}", flush=True)
    return {"launches": counts["B1"], "seconds": seconds, "samples_per_s": rate,
            "resample_stats": stats}


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
    sass = build_all()
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
    layer0 = flagship.backbone.layers[0]
    train_layer = {l: check_train_layer(layer0, N_HEAD, TRAIN_BATCH, l, timed=l == MAX_LEN,
                                        library=True) for l in TRAIN_LENGTHS}
    breakdown = kernel_breakdown(layer0, N_HEAD)
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
        val_b2_s = training["launches"]["B2"] / TRAIN_EPOCHS * attention[torch.float32]["ms"] / 1e3
        print(f"  fused training: {training['steps_per_s']:.3f} steps/s; the kernels' share of a "
              f"step, from their B={TRAIN_BATCH} times: B3 {N_LAYERS * timed['fwd']['ms']:.3f} "
              f"+ B4 {N_LAYERS * timed['bwd']['ms']:.3f} = {kernel_ms:.3f} ms of "
              f"{training['step_ms']:.3f} ms ({100 * kernel_ms / training['step_ms']:.1f} %); "
              f"validation {training['val_pass_s']:.3f} s per pass, B2's "
              f"{training['launches']['B2'] // TRAIN_EPOCHS} launches {val_b2_s:.3f} s of it",
              flush=True)
        training.update(step_rates(dm))
        phase("8 training main path", t0)

        t0 = time.perf_counter()
        coverage = check_coverage(checks)
        attn_shapes = check_attention_shapes()
        phase("9 long sequences and wide layers", t0)

        t0 = time.perf_counter()
        attn_kernels = {f"B={b} L={l}": check_attention_kernels(b, l, timed=True)
                        for b, l in ATTN_SHAPES}
        attn_main = attn_kernels[f"B={TRAIN_BATCH} L={MAX_LEN}"]
        phase("10 unfused attention kernels vs plain", t0)

        t0 = time.perf_counter()
        unfused_check = {rate: check_unfused_training(dm, rate) for rate in (DROPOUT, 0.0)}
        phase("11 unfused training check", t0)

        t0 = time.perf_counter()
        unfused = {rate: run_unfused_training(dm, rate) for rate in (DROPOUT, 0.0)}
        print(f"  steps/s from this call (train seconds only; C3's steps_per_sec, which "
              f"counts validation, in brackets): fused B3/B4 {training['steps_per_s']:.3f} "
              f"({training['epoch_steps_per_sec']}); unfused B6, dropout {DROPOUT} "
              f"{unfused[DROPOUT]['steps_per_s']:.3f} "
              f"({unfused[DROPOUT]['epoch_steps_per_sec']}); unfused B2 + B5, dropout 0 "
              f"{unfused[0.0]['steps_per_s']:.3f} ({unfused[0.0]['epoch_steps_per_sec']})",
              flush=True)
        phase("12 unfused training main path", t0)

    t0 = time.perf_counter()
    int8_checks = check_int8_kernels(checks, coverage)
    phase("13 int8 kernels vs plain", t0)

    t0 = time.perf_counter()
    int8_main = {level: run_int8_main_path(level, main[torch.bfloat16]) for level in INT8_LEVELS}
    int8_traj = {level: check_int8_trajectory(level) for level in INT8_LEVELS}
    phase("14 int8 main path", t0)

    t0 = time.perf_counter()
    pc = run_pc_main_path()
    phase("15 pc main path", t0)

    kernels = []
    for dtype, by_batch in checks.items():
        r = by_batch[SAMPLE_CHAINS]  # the main path's shape
        name = str(dtype).removeprefix("torch.")
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
            "sass": {k: v for k, v in sass.items() if k.startswith("fused_encoder: ")},
            "device_us_by_kernel": breakdown[f"B1 {name}"]["device_us_by_kernel"],
            "shape": f"B={SAMPLE_CHAINS} L={MAX_LEN} D=72 H={N_HEAD} F=2048",
            "samples_per_s": main[dtype]["samples_per_s"],
            "by_batch": {str(b): c for b, c in by_batch.items()},
            "checked_lengths": {f"L={MAX_LEN} D=72": {str(b): c for b, c in by_batch.items()},
                                **{f"{k} B={COVERAGE_BATCH}": v["B1"][name]
                                   for k, v in coverage.items()}},
        })
    f32 = attention[torch.float32]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": training["launches"]["B2"],
        "max_abs_err": max([f32["max_abs_err"]] + [c["max_abs_err"] for k, c in
                                                   attn_shapes.items() if k.startswith("float32")]),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} float32",
        "bfloat16": {**attention[torch.bfloat16], "replaces": FLASH_FAST_REPLACES},
        "sass": {k: v for k, v in sass.items() if k.startswith("flash_attention: ")},
        "checked_shapes": {**attn_shapes,
                           **{f"float32 {k} H={N_HEAD} dh={72 // N_HEAD}": a["B2"]
                              for k, a in attn_kernels.items()}},
    })
    for key, name, replaces, count in (
        ("fwd", "fused_encoder_layer_train_fwd", TRAIN_FWD_REPLACES, "B3"),
        ("bwd", "fused_encoder_layer_train_bwd", TRAIN_BWD_REPLACES, "B4"),
    ):
        r = timed[key]
        checked = {f"L={l} D=72 B={TRAIN_BATCH}": train_layer[l][key] for l in TRAIN_LENGTHS}
        checked.update({f"{k} B={COVERAGE_BATCH}": v[key] for k, v in coverage.items()})
        kernels.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCE, "replaces": replaces,
            "launches": training["launches"][count],
            "max_abs_err": max(c["max_abs_err"] for c in checked.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launches_per_call": breakdown[count]["launches_per_call"],
            "sass": {k: v for k, v in sass.items() if k.startswith("fused_encoder_train: ")},
            "device_us_by_kernel": breakdown[count]["device_us_by_kernel"],
            **({"stage_ms": r["stage_ms"]} if key == "bwd" else {}),
            "shape": f"B={TRAIN_BATCH} L={MAX_LEN} D=72 H={N_HEAD} F=2048 fp32 dropout {DROPOUT}",
            "steps_per_s": training["steps_per_s"],
            "checked_lengths": checked,
        })
    for key, name, replaces, launches in (
        ("B5", "flash_attention_bwd", FLASH_BWD_REPLACES, unfused[0.0]["launches"]["B5"]),
        ("B6-fwd", "flash_attention_dropout_fwd", DROPOUT_FWD_REPLACES,
         unfused[DROPOUT]["launches"]["B6-fwd"]),
        ("B6-bwd", "flash_attention_dropout_bwd", DROPOUT_BWD_REPLACES,
         unfused[DROPOUT]["launches"]["B6-bwd"]),
    ):
        r = attn_main[key]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(a[key]["max_abs_err"] for a in attn_kernels.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} float32"
                     + ("" if key == "B5" else f" dropout {DROPOUT}"),
            "sdpa_backend": attn_main["sdpa_backend"],
            "checked_shapes": {k: a[key] for k, a in attn_kernels.items()},
        })
    for level in INT8_LEVELS:
        by_shape = int8_checks[level]
        r = by_shape[f"bfloat16 L={MAX_LEN} D=72 B={SAMPLE_CHAINS}"]  # the main path's shape
        kernels.append({
            "name": "fused_encoder_layer_int8" + ("_attn" if level == 2 else "") + "/bfloat16",
            "route": "cuda", "source": INT8_SOURCE, "replaces": INT8_REPLACES[level],
            "launches": int8_main[level]["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in by_shape.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_note": "no one PyTorch call computes a W8A8 encoder layer",
            "b1_ms": r["b1_ms"],
            "shape": f"B={SAMPLE_CHAINS} L={MAX_LEN} D=72 H={N_HEAD} F=2048 bfloat16, "
                     f"FDIFF_FUSED_INT8={level}",
            "samples_per_s": int8_main[level]["samples_per_s"],
            "rel_l2_vs_bf16_samples": int8_main[level]["rel_l2_vs_bf16"],
            "trajectory": {k: int8_traj[level][k] for k in ("with_kernel_codes",
                                                             "with_own_codes")},
            "checked_shapes": {k: {f: c[f] for f in ("max_abs_err", "ms", "plain_ms", "b1_ms",
                                                     "bound_ms")}
                               for k, c in by_shape.items()},
        })
    print(f"pc: {json.dumps(pc)}", flush=True)
    print(f"training: {json.dumps({**training, **train_check})}", flush=True)
    unfused_all = {str(r): {**unfused[r], **unfused_check[r]} for r in unfused}
    print(f"unfused training: {json.dumps(unfused_all)}", flush=True)
    print(f"total: {time.perf_counter() - t_all:.2f} s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
