#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``fourierdiffusion_tpu_torch``)
on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed with its seconds as it ends:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: ``csrc/fused_encoder.cu`` (B1), ``csrc/flash_attention.cu`` (B2,
   B5, B6), ``csrc/fused_encoder_train.cu`` and ``_bf16.cu`` (B3, B4 in fp32
   and bf16) and
   ``csrc/fused_encoder_int8.cu`` (B7, B8), one ``nvcc`` each, all started
   together (a library already built is reused), with ptxas's registers,
   stack and spills for every kernel instance, and, from ``cuobjdump
   -sass``, the instructions and tensor-core instructions (HMMA, and IMMA
   for the int8 products) of each kernel of B1, B2, B3, B4, B5/B6-bwd, B7
   and B8; every kernel that runs a tile product must have HMMA (an int8
   one IMMA), B2's kernel, the two launches of B5/B6-bwd, their bf16
   instances and B6-fwd's bf16 instance (BF16_ATTENTION_INSTANCES), the
   training layer's attention kernels in both training libraries
   (TRAIN_ATTENTION_INSTANCES: ``csrc/attention_mma.cuh`` over the packed
   qkv), the training tail and B7/B8's three int8 kernels must be among
   them, no kernel of B7/B8 may hold a ``__dp4a`` (IDP4A), and no training
   library a CUDA-core attention kernel (TRAIN_CUDA_CORE_ATTENTION).
3. kernel: the trained flagship's layer 0 at L=100, fp32 and bf16, at
   batch 64 and at the main path's batch of 32: the kernel B1 against its
   plain PyTorch version on the card, and the times of the kernel (beside
   its time before the tensor-core redesign, PRIOR_MS), the plain version
   and one eval-mode ``nn.TransformerEncoderLayer`` call on the same
   weights (a yardstick the port never calls), its bounds (and, in fp32,
   three times its products over the TF32 peak) and launches per call; B1's
   B=32 times beside its times before C1's repair (B1_BEFORE_C1_MS). Then
   C1, bit for bit in fp32 and bf16: chains 0-15 of one B1 call at 32
   chains against the same chains alone, chains 0-31 of one B3 call at 64
   against a call at 32, and B4's ReLU gates there.
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
   bf16), one B3 and one B4 call (B=64, fp32 and bf16), from
   ``torch.profiler``: the launches of one B3 and one B4 call must be those
   of their plans, and their attention stages the mma.sync kernels
   (TRAIN_ATTENTION_FUNCTIONS), no CUDA-core one.
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
   output), with its time, its plain version's and SDPA's, and the form
   its plan takes there (``fwd_form``: S kept, the head resident, or the
   ring).
10. unfused attention kernels, fp32 (bf16: phase 21): B6-fwd (dropout
   0.1; B2's kernel with the keep factors) against its plain version at
   (64, 12, 100, 6), (8, 12, 365, 6) and (1, 8, 2048, 16), with the masks
   bit for bit, and B2's fp32 time on the same heads beside SDPA's; B5 and
   B6-bwd (two launches on the tensor cores each) there and at (8, 8, 187,
   16), (1, 8, 896, 16), (1, 12, 3616, 6) and (1, 2, 438, 64) against their
   plain versions (B5 also against autograd of the plain forward), launch
   1's row statistics against ``attention_bwd_staged``, two calls
   bit-identical and ``torch.profiler`` counting 2 launches per call. The
   times of each kernel (B5 and B6-bwd beside their times before the
   redesign, PRIOR_MS, with each launch's device time), its plain version,
   its bound (B5, B6-bwd also 3xTF32) and a yardstick the port never calls:
   the autograd backward of ``F.scaled_dot_product_attention`` for B5, SDPA
   with ``dropout_p=0.1`` forward and backward for B6 (the SDPA backend
   printed).
11. unfused training check (``FDIFF_FUSED_TRAIN=0``; fp32, bf16 in phase
   21): the first 3 steps of the flagship's training configuration through
   the kernels and through ``Trainer(plain=True)``, from the same weights,
   batches, ``t``, ``z`` and generator (so the same attention seeds and
   FFN-site draws), at dropout 0.1 (B6) and 0 (B2 + B5): losses and the
   first step's gradients.
12. unfused training main path (fp32; bf16 in phase 21): ``Trainer.fit``
   as in phase 8, with ``FDIFF_FUSED_TRAIN=0``, cut to 1 epoch (16 steps),
   at dropout 0.1 (B6-fwd = B6-bwd = steps x 10 calls; a B5 or B6-bwd call
   is 2 CUDA launches) and at dropout 0 (B5 = steps x 10), B2 for
   validation; all losses finite; its steps/s beside phase 8's.
13. int8 kernels: B7 (``FDIFF_FUSED_INT8=1``) and B8 (``=2``) against their
   plain versions on the trained flagship's layer 0 at L=100, B=64 and 32,
   fp32 and bf16, and at B=8 on phase 9's shapes (random weights). The
   kernel writes the int8 codes of every quantization site; the plain
   version is run with those codes put in, site by site, and every code
   where the two part is located (``locate_code_flips``) and held to a
   band around a rounding boundary (INT8_FLIP_BAND); the output is held
   to B1's tolerance against that run. Times of each kernel (beside its
   time before its redesign on the tensor cores, PRIOR_MS), its plain
   version and B1 at the same shape and dtype, and the bound; at the main
   path's shape (B=32, L=100) the device time of each of its CUDA launches
   from ``torch.profiler``, whose launches per call must be
   ``fused_encoder.int8_plan``'s.
14. int8 main path: phase 4's sampler in bf16 with ``FDIFF_FUSED_INT8=1``
   and then ``=2``: B7 (or B8) K x 10 launches and B1 none; the samples
   finite, their samples/s and relative L2 distance from phase 4's bf16
   samples (the same generator seed); each level run twice, in turns with
   phase 4's bf16 run (bf16, 1, 2, bf16, 1, 2: the host sets these rates,
   and they move between runs of one process); a 20-step fp32 trajectory through
   B7/B8 and through their plain versions on the card and on the CPU with
   the kernel's int8 codes of every layer and step put in (every flip
   located), pairwise.
15. pc main path: ``DiffusionSampler(method="pc", corrector_steps=1,
   snr=0.16, divergence_threshold=8.0)``, K=250 (``bench.py``'s pc250), 32
   chains, bf16, the same weights: B1 K x 2 x 10 launches for each draw of
   the batch (the first and each redraw the guard makes, from
   ``last_resample_stats``); its samples/s.
16. sample quality: the trained flagship sampled as its reference run was
   (K=1000, Euler-Maruyama, seed 42; 5000 samples in batches of 1000
   chains, scored also over the first 1000, results.yaml's count) in fp32
   and bf16 through B1 and in bf16 with
   ``FDIFF_FUSED_INT8=1`` (B7) and ``=2`` (B8), every layer of every step
   through the kernel; each run un-standardised with the training
   statistics and taken back to time (``idft``), as the JAX sampling CLI
   does, and scored by the port's ``MetricCollection`` on the card against
   the synthetic training series (seed 42): sliced (1000 directions) and
   marginal W2 in time and frequency, baselines, spectral density; the
   divergence census. Every ``*_mean`` is printed beside the same key of
   ``results.yaml`` and ``results_cross_our_sampler.yaml``, with the int8
   runs' ratio to the bf16 run, and each run's four gated means beside
   QUALITY_PRIOR's (an earlier run's, printed, not gated). Gates: the four
   W2 means below their ``_dummy`` baselines in every run, and within 1.5x
   of ``results.yaml``
   over the 5000 samples in fp32 and bf16 (QUALITY_DRAWN says why 5000).
17. CLI path, in a temporary directory: (a) ``fdiff-torch-train``
   (``cli.train.main``) on the flagship's training configuration as phase 8
   has it, cut to 3 epochs, with ``last`` written every epoch and the
   sampling callback on every 2 epochs (epochs 0 and 2; 64 chains, K=1000,
   200 directions): ``train_config.yaml`` read back equal to the composed
   config, ``metrics.jsonl`` with the JAX package's keys (3 epoch records,
   2 callback records), one best checkpoint and ``last``, all losses
   finite, B3 = B4 = steps x 10, B2 = 3 x 16 x 4 x 10 and B1 = 2 x 1000 x
   10 launches; (b) the same configuration under a second run id, stopped
   by an exception in epoch 2 (after epoch 1's ``last``), then
   ``fdiff-torch-train resume=<id>``: its ``last`` params and EMA must
   equal (a)'s (largest |difference| printed); (c) ``fdiff-torch-sample``
   on a run directory assembled from the trained ``ref-freq42-e200``
   weights (``save_checkpoint``, its ``run_config.yaml``'s validation loss),
   1000 samples, K=1000, one batch, seed 42, fp32: the first 1000 chains of
   phase 16's fp32 draw, so ``results.yaml``'s four gated W2 means must
   equal phase 16's fp32 scores over its first 1000 exactly; B1 = 1000 x
   10 launches, ``samples.npy`` (1000, 100, 1), the census fields present.
   The seconds of each of (a)-(c).
18. datasets, MLP and LSTM, in a temporary directory: (a) raw files in each
   dataset's real format written from seed 0 (``data/raw_formats.py``:
   headerless MIT-BIH CSVs of 512 and 128 rows, 72 NASDAQ stocks besides a
   late and a gappy one, 72 droughts counties with the real file's 18
   feature columns and a weekly ``score``, 40 NASA charge cycles besides
   one skipped by each rule), then each datamodule's ``prepare_data`` and
   ``setup``: shapes (N, 187, 1), (N, 252, 5), (N, 251, 4), (N, 365, 13),
   the series each keeps, finite values, and ``pandas`` never imported;
   (b) ``fdiff-torch-train datamodule=ecg fourier_transform=true
   standardize=true`` with the flagship's transformer (fp32, fused) for 2
   epochs (B3 = B4 = steps x 10, B2 = epochs x validation batches x 4 x 10,
   all losses finite), then ``fdiff-torch-sample`` on that run, 256
   samples at K=250 in one batch (B1 = 250 x 10, ``samples.npy`` (256,
   187, 1)); (c) one fused epoch each on NASDAQ, NASA and droughts (B3/B4
   at L = 252, 251 and 365 with 5, 4 and 13 channels, the same gates); (d)
   ``ref-lstm-freq42-e60`` and ``ref-lstm-time42-e60`` in run directories
   assembled as in phase 17 (c), on the synthetic data of their seed,
   through ``fdiff-torch-sample`` at their ``run_config.yaml``'s K (250)
   and seed (42), 5000 samples in one batch: the four W2 means below their
   ``_dummy`` baselines and within 1.5x of the run's ``results.yaml``, no
   kernel launched (the LSTM runs on cuDNN); (e) ``fdiff-torch-train
   score_model=mlp`` on phase 8's synthetic data for 2 epochs and
   ``fdiff-torch-sample`` with 64 samples at K=100: finite losses and
   samples, no kernel launched (the JAX package runs no Pallas kernel for
   the MLP). The seconds of each of (a)-(e).
19. data-parallel training and sharded sampling (``parallel/``), every
   library built by phase 2 before any rank starts, so that ranks only load
   them: (a) NCCL at world size 1 on ``cuda:0``, in this process: one
   epoch of phase 8's configuration through the mesh code path (draws cut
   to the rank's rows, the gradients' all-reduce, the reduced losses)
   equal bit for bit to the same epoch without a mesh; (b) two ranks that
   share the card over gloo (NCCL refuses two ranks on one device; gloo
   takes CUDA tensors), phase 8's configuration, 32 chains each: the first
   step's all-reduced gradients against phase 7's first kernel step to
   GRAD_TOL (FFN ReLU gates that flipped between the two runs located and
   matched, as in phase 7), the first 3 losses to LOSS_TOL (their layer
   seeds through ``Trainer.draw_layer_seeds``, as ``fit`` draws them), then
   phase 8's 2 epochs of ``Trainer.fit`` (both ranks' weights and EMA bit for bit after every
   epoch, the losses against phase 8's to DP_EPOCH_LOSS_TOL, and per rank
   B3 = B4 = steps x 10, B2 = 2 x 16 x 4 x 10 for the sharded validation);
   (c) in the same two ranks, phase 4's fp32 sampler on
   ``ref-freq42-e200`` from phase 4's generator, 32 chains split 16 + 16,
   K=1000 (B1 = 10,000 per rank), gathered: bit for bit phase 4's samples
   (and chains 0-15 of one score and one B1 call at 32 chains bit for bit
   the same chains alone), and a 20-step run against one process to
   TRAJ_TOL; (d) ``dryrun_multichip(2)`` on the card over
   gloo; (e) NCCL across cards with phase 8's configuration, only where
   two cards are present (printed as not run otherwise). Any rank's
   failure or time limit fails the phase; the seconds of each part and
   each rank's launches are printed.
20. bf16 training (a model of ``dtype`` bfloat16, fp32 parameters): (a) B3
   and B4 in bf16 against their plain bf16 versions (the plain backward
   ``train_backward_staged`` rounds where the TPU kernel rounds) on the
   flagship's layer 0 at B=64, L=100 (two calls of each bit for bit, B4's
   ms per stage, and timed, with the plain versions, the bound and a
   train-mode bf16 ``nn.TransformerEncoderLayer``) and on
   phase 9's long and wide shapes at B=8: outputs to TOL, B4's stages, dx
   and gradients to BF16_GRAD_TOL against the staged plain backward with
   the kernel's ReLU gates, each flipped gate located; (b) phase 7's first
   3 steps in bf16 through the kernels and through the plain versions:
   losses, the step-0 gradients (gates located and matched), parameters
   and gradients fp32; (c) ``runs/94c6eb87/train_config.yaml`` (the
   flagship trained in bf16) cut to 3 epochs through ``fdiff-torch-train``,
   then the same configuration in fp32: finite losses, B3 = B4 = steps x
   10, B2 = 3 x 16 x 4 x 10, all of them (bf16) or none (fp32) B2's fast
   bf16 form, the checkpoint fp32, each epoch's steps/s side by side; and
   ``fdiff-torch-sample`` of the bf16 run's checkpoint, 64 samples at K=100
   through B1 in bf16.
21. bf16 on the unfused path, MLP and LSTM: (a) B6-fwd, B5 and B6-bwd in
   bf16 (``attention_fwd_mma_kernel<__nv_bfloat16, false, true, kDh, false,
   kKept>`` and the two launches ``<__nv_bfloat16, *, kDh>`` on bf16
   ``mma.sync``) against their plain bf16 versions at phase 10's shapes:
   B6-fwd's output to B2_BF16_ULPS ulps of its largest, its form (S kept
   at L <= 128, resident to the plan's edge, the ring beyond; FWD_FORMS)
   and its output bit for bit the ring form's, one launch per call with
   its device time, the masks bit for bit, dq, dk, dv
   to BF16_ATTN_GRAD_TOL against the plain versions and the bf16 staged
   plain backward, launch 1's statistics against the staged version (D
   from O = P_used v recomputed, within ``bf16_d_err_over_bound``'s bound,
   which D from the saved output must break), two calls bit for bit, 2 CUDA launches
   per call by ``torch.profiler``; at (64, 12, 100, 6) the times of each
   kernel, its plain version, its bound and SDPA in bf16 (its autograd
   backward for B5; with ``dropout_p`` 0.1 forward for B6-fwd, backward
   for B6-bwd); (b) phase 11 in bf16 at dropout 0.1 and 0 (losses, step-0
   gradients, flipped gates located and matched, phase 20 (b)'s bf16
   limits), and phase 12 in bf16 at both rates (B6-fwd = B6-bwd = steps x
   10, or B5 = steps x 10, every B2 launch in its fast form), with the
   steps/s beside phase 12's fp32; (c) ``fdiff-torch-train`` with
   ``bf16_cli_overrides`` and ``FDIFF_FUSED_TRAIN=0``, cut to 1 epoch:
   finite losses, B6-fwd = B6-bwd = steps x 10, B2 = 16 x 4 x 10 all in
   the fast form, the checkpoint fp32, its steps/s beside phase 12's; (d)
   ``fdiff-torch-train score_model=mlp`` and ``=lstm`` with
   ``score_model.dtype=bfloat16`` on phase 8's data, 1 epoch each, then
   ``fdiff-torch-sample`` of each, 64 samples at K=100: finite losses and
   samples, fp32 checkpoints, no kernel launched; 3 steps of each network
   on the card against the same steps on the CPU in bf16 (BF16_LOSS_TOL,
   BF16_NET_GRAD_TOL); the bf16 LSTM's kernels from ``torch.profiler``
   (cuDNN's names printed, an LSTM kernel among them, the layer's output
   bf16).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero; it exits
non-zero too when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import io
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fourierdiffusion_tpu_torch.cli import sample as cli_sample
from fourierdiffusion_tpu_torch.cli import train as cli_train
from fourierdiffusion_tpu_torch.data import DATAMODULE_REGISTRY, SyntheticDatamodule, raw_formats
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
from fourierdiffusion_tpu_torch.parallel import distributed, make_mesh
from fourierdiffusion_tpu_torch.parallel.dryrun import dryrun_multichip
from fourierdiffusion_tpu_torch.parallel.launch import free_port, run_ranks
from fourierdiffusion_tpu_torch.sampling import (
    DiffusionSampler,
    MarginalWasserstein,
    MetricCollection,
    SlicedWasserstein,
    reverse_diffusion,
)
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer
from fourierdiffusion_tpu_torch.training.trainer import SEED_MAX
from fourierdiffusion_tpu_torch.utils import yamlio
from fourierdiffusion_tpu_torch.utils.census import census_fields
from fourierdiffusion_tpu_torch.utils.checkpoint import (
    get_best_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from fourierdiffusion_tpu_torch.utils.config import compose, save_config
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
    # B5 and B6-bwd before their redesign on the tensor cores, and in bf16
    # before launch 1 held the head resident and kept S in registers
    # (PERF.md, section 6; the same card and power limit).
    "B5": {"B=64 H=12 L=100 dh=6": 0.4462, "bf16 B=64 H=12 L=100 dh=6": 0.1096},
    "B6-bwd": {"B=64 H=12 L=100 dh=6": 0.4413, "bf16 B=64 H=12 L=100 dh=6": 0.1287},
    # bf16 B6-fwd before its forward staged the head once and kept S in
    # registers (PERF.md, section 6; the same card and power limit).
    "B6-fwd": {"bf16 B=64 H=12 L=100 dh=6": 0.0516},
    # B7 and B8 on __dp4a, before their redesign on the tensor cores
    # (PERF.md, section 6; the same card and power limit).
    "B7": {"bfloat16 L=100 D=72 B=32": 0.2485}, "B8": {"bfloat16 L=100 D=72 B=32": 0.2697},
}
# The kernels that run tile products (B1, B2, B3, B4, B5/B6-bwd): each must
# show tensor-core instructions (HMMA) in its SASS.
PRODUCT_KERNELS = ("gemm_kernel", "gemm_pair_kernel", "layer_tail_kernel",
                   "attention_fwd_mma_kernel", "attention_bwd_dq_mma_kernel",
                   "attention_bwd_dkv_mma_kernel")
# ... and these must be among them: B2's kernel, the two launches of B5 and
# B6-bwd, their bf16 instances (launch 1 in both forms: S kept in registers,
# kKept true, and resident or streamed, false), B6-fwd's and B2's bf16
# exact instances in both forms (kKept; BF16_ATTENTION_INSTANCES), and the
# tail that B3 runs.
BF16_ATTENTION_INSTANCES = (
    *(("flash_attention", f"attention_fwd_mma_kernel<__nv_bfloat16, false, {drop}, 16, false, "
                          f"{kept}>") for drop in ("false", "true") for kept in ("true", "false")),
    *(("flash_attention", f"attention_bwd_{kernel}<__nv_bfloat16, {drop}, 16, false{kept}>")
      for drop in ("false", "true")
      for kernel, kept in (("dq_mma_kernel", ", true"), ("dq_mma_kernel", ", false"),
                           ("dkv_mma_kernel", ""))))
# The training layer's attention stages (B3's forward, B4's recompute and
# backward) on csrc/attention_mma.cuh's kernels over the packed qkv, in the
# fp32 and bf16 training libraries (their packed-qkv instances, kPacked
# true) at the flagship's head width; no CUDA-core attention kernel
# (TRAIN_CUDA_CORE_ATTENTION, a thread per query row or key) may be left in
# those libraries.
TRAIN_ATTENTION_INSTANCES = tuple(
    (lib, f"{kernel}<{tp}, {flags}{kdh}, true{kept}>")
    for lib, tp, kdh in (("fused_encoder_train", "float", 8),
                         ("fused_encoder_train_bf16", "__nv_bfloat16", 16))
    for kernel, flags, kept in (("attention_fwd_mma_kernel", "false, true, ", ", true"),
                                ("attention_fwd_mma_kernel", "false, true, ", ", false"),
                                ("attention_bwd_dq_mma_kernel", "true, ", ", true"),
                                ("attention_bwd_dq_mma_kernel", "true, ", ", false"),
                                ("attention_bwd_dkv_mma_kernel", "true, ", ""))
    if tp != "float" or kept != ", true")
TRAIN_ATTENTION_FUNCTIONS = ("attention_fwd_mma_kernel", "attention_bwd_dq_mma_kernel",
                             "attention_bwd_dkv_mma_kernel")
TRAIN_CUDA_CORE_ATTENTION = ("attention_fwd_kernel<", "attention_bwd_dq_kernel<",
                             "attention_bwd_dkv_kernel<")
REQUIRED_PRODUCT_KERNELS = (("flash_attention", "attention_fwd_mma_kernel"),
                            ("flash_attention", "attention_bwd_dq_mma_kernel"),
                            ("flash_attention", "attention_bwd_dkv_mma_kernel"),
                            *BF16_ATTENTION_INSTANCES, *TRAIN_ATTENTION_INSTANCES,
                            ("fused_encoder_train", "layer_tail_kernel"),
                            ("fused_encoder_int8", "qkv_int8_kernel"),
                            ("fused_encoder_int8", "attention_int8_kernel"),
                            ("fused_encoder_int8", "int8_tail_kernel"))
# The kernels of B7 and B8 that run int8 products: each must show int8
# tensor-core instructions (IMMA), and no kernel of their library a __dp4a
# (IDP4A), the CUDA-core product their first bodies ran.
INT8_PRODUCT_KERNELS = ("qkv_int8_kernel", "attention_int8_kernel", "int8_tail_kernel")
REPLACES = "fourierdiffusion_tpu/ops/fused_encoder.py:172"
SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder.cu"
SOURCES = ("fused_encoder", "flash_attention", "fused_encoder_train", "fused_encoder_train_bf16",
           "fused_encoder_int8")

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
TRAIN_SOURCE = "fourierdiffusion_tpu_torch/csrc/fused_encoder_train.cuh"
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
# B5 and B6-bwd at ATTN_SHAPES and beyond, (B, H, L, dh): ECG's L at fast.yaml's
# head width (16); L=896 there, the longest L JAX's _bwd_kernel serves at
# dh 16 (the port's previous backward staged the whole head and refused L
# >= 775); and the long heads phase 9 checks B2 at.
BWD_SHAPES = tuple((b, N_HEAD, l, 72 // N_HEAD) for b, l in ATTN_SHAPES) + (
    (8, 8, 187, 16), (1, 8, 896, 16), (1, 12, 3616, 6), (1, 2, 438, 64))
# B6-fwd (B2's kernel with the keep factors) at ATTN_SHAPES' heads and at
# L=2048, dh 16, a length its earlier body (the whole head staged in shared
# memory) refused from L=1608 at that width.
DROPOUT_FWD_SHAPES = tuple((b, N_HEAD, l, 72 // N_HEAD) for b, l in ATTN_SHAPES) + (
    (1, 8, 2048, 16),)
# The form bf16 B6-fwd takes at each of them (phase 21 (a)): S kept in
# registers where the keys fit in two blocks, the head's K and V resident
# in shared memory where they fit in half of it, the ring beyond.
FWD_FORMS = dict(zip(DROPOUT_FWD_SHAPES, ("kept", "resident", "ring")))
BWD_FUNCTIONS = ("attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel")
BWD_LAUNCHES = len(BWD_FUNCTIONS)  # CUDA launches per B5 or B6-bwd call
# Launch 1's row statistics (max, sum, D = dO . O) against
# attention_bwd_staged, each to STATS_TOL of its largest: the same fp32
# terms summed in other orders, with S from 3xTF32 products (within ~1e-6
# of fp32), as ATTN_TOL allows for outputs.
STATS_TOL = ATTN_TOL
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

# Phase 16, sample quality: the flagship sampled as its reference run was
# (runs_reference/ref-freq42-e200/run_config.yaml: K=1000, seed 42) in
# batches of QUALITY_BATCH chains, and scored as the JAX package's sampling
# CLI scores it (scripts/cross_sample_reference_weights.py: 1000 directions,
# seed 42, baselines and the spectral density, against the synthetic
# training series of seed 42), over all QUALITY_DRAWN samples of a run and
# over its first QUALITY_SAMPLES (the reference's 1000, results.yaml's n).
# Every run draws the same normal stream, so the int8 runs' ratios to the
# bf16 run are paired.
QUALITY_SAMPLES = QUALITY_BATCH = 1000
QUALITY_SEED, QUALITY_DIRECTIONS = 42, 1000
# Why 5000. At 1000 samples one far chain decides these metrics: this
# weights' draws hold about one chain in 5000 whose largest |x| in time
# reaches 7.6 (the bulk stays below 4), and the seed-42 stream puts one in
# its first 1000, which lifts the time sliced W2 mean to 1.61x
# results.yaml; 20 random 1000-subsets of a 10,000-sample draw of the port
# read 0.0956 +- 0.0199 (0.0767 to 0.1220), of the JAX package's draw
# 0.0802 +- 0.0025 (scripts/sample_quality_compare.py, PERF.md section 6).
# Without its two far chains the port's 10,000 agree with the JAX
# package's to 3.3 % on every gated key. At 5000 samples the seed-42
# stream reads at most 1.15x results.yaml, and both far chains of 10,000
# put in one subset of 5000 at most 1.30x (1.49x at 3000).
QUALITY_DRAWN = 5000
# (name, compute dtype, FDIFF_FUSED_INT8) of each run, and the runs gated.
QUALITY_RUNS = (("float32", torch.float32, 0), ("bfloat16", torch.bfloat16, 0),
                ("int8-1", torch.bfloat16, 1), ("int8-2", torch.bfloat16, 2))
QUALITY_GATED = ("float32", "bfloat16")
# The gated keys. Each must lie below its _dummy baseline (the mean sample)
# in every run, over all its samples and over its first QUALITY_SAMPLES,
# and, over all the samples of a gated run, within QUALITY_REF_FACTOR of
# the reference sampler's own value in REFERENCE_RESULTS: that leaves room
# for the estimator's spread above and still catches a wrong sampler,
# whose samples land near the dummy's distance (4.7x to 9.4x these values).
QUALITY_KEYS = tuple(f"{d}_{m}_wasserstein_mean" for d in ("time", "freq")
                     for m in ("sliced", "marginal"))
# Each run's QUALITY_KEYS over its QUALITY_DRAWN samples as an earlier run
# of this script read them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# section 6): sampling runs B1, B7 and B8 only, so a change elsewhere
# leaves them equal to the last digit. Printed beside this run's, never
# gated.
QUALITY_PRIOR = {
    "float32": {"time_sliced_wasserstein_mean": 0.08543772995471954,
                "time_marginal_wasserstein_mean": 0.15591415762901306,
                "freq_sliced_wasserstein_mean": 0.060656480491161346,
                "freq_marginal_wasserstein_mean": 0.05387948453426361},
    "bfloat16": {"time_sliced_wasserstein_mean": 0.08514726161956787,
                 "time_marginal_wasserstein_mean": 0.15569470822811127,
                 "freq_sliced_wasserstein_mean": 0.06045527383685112,
                 "freq_marginal_wasserstein_mean": 0.053567662835121155},
    "int8-1": {"time_sliced_wasserstein_mean": 0.08595629781484604,
               "time_marginal_wasserstein_mean": 0.1564759463071823,
               "freq_sliced_wasserstein_mean": 0.06109298765659332,
               "freq_marginal_wasserstein_mean": 0.0538877472281456},
    "int8-2": {"time_sliced_wasserstein_mean": 0.08711397647857666,
               "time_marginal_wasserstein_mean": 0.15742263197898865,
               "freq_sliced_wasserstein_mean": 0.061961278319358826,
               "freq_marginal_wasserstein_mean": 0.05370626971125603},
}
QUALITY_REF_FACTOR = 1.5
REFERENCE_RESULTS = WEIGHTS.parent / "results.yaml"
CROSS_RESULTS = WEIGHTS.parent / "results_cross_our_sampler.yaml"


# torch.profiler now and then drops one kernel, or all of them, from a
# trace, whatever the kernel: scripts/torch_profiler_probe.py saw it in about
# one trace in 170 of ten torch.mm calls when the kernels filled the trace's
# window, and in none of 1200 with the host idle 5 ms at both ends of it; a
# padded trace of B5 still lost one launch in twenty. And some processes,
# from some point on, lose the first one to three kernels of every trace,
# however padded (PERF.md section 7), and late in a long run a trace may
# lose every kernel, spin kernels included (nine such traces in phase 21 of
# one run, three in a row at one shape of another). So each trace opens
# with spin kernels that absorb that loss, is padded, and is taken again
# where it lost kernels of the calls, the traces taken kept in each result.
PROFILE_PAD_S = 0.005
PROFILE_ATTEMPTS = 6
PROFILE_PRIMES = 8


# Phase 19: two ranks, each spawn of them within DP_TIMEOUT seconds (the
# collectives' own time limit too).
DP_RANKS, DP_TIMEOUT = 2, 240
# The 2 epochs' losses of two ranks against phase 8's one process. Both draw
# the same batches, t, z and masks; they part only in the gradients' fp32
# sums (B4 sums 32 chains per rank and the all-reduce adds the two halves,
# where phase 8's B4 sums 64), by ~1e-6 of a gradient per step. AdamW
# divides each entry by its own RMS, so an entry whose gradient is rounding
# noise (the attention's key bias, zero in exact arithmetic) takes steps of
# up to the learning rate that differ between the two; at a small size on
# the CPU the same run's losses agree to 1e-7 (tests/test_torch_parallel.py).
# 1e-3 relative leaves room for 32 such steps. The masks, draws and shards
# themselves are held tighter, by the first 3 steps' losses at LOSS_TOL
# (their seeds shifted by Trainer.draw_layer_seeds, as in fit).
DP_EPOCH_LOSS_TOL = 1e-3


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


class Profile(NamedTuple):
    """What ``device_us_by_kernel`` read from its last trace."""

    us_by_kernel: dict[str, float]  # device us per call, summed over a kernel's launches
    us_per_launch: dict[str, float]  # device us per launch: a kernel's time over its events
    launches: float  # kernel launches per call that the device ran
    host_launches: float  # CUDA launches per call that the host made
    traces: int  # traces taken


def device_us_by_kernel(fn, calls: int = 10, launches: int | None = None) -> Profile:
    """Device time of ``fn`` by CUDA kernel and its launches per call, from
    ``torch.profiler`` over ``calls`` calls after a warm-up. Each trace
    opens with PROFILE_PRIMES spin kernels (``torch.cuda._sleep``), which a
    trace may lose, and the host idles PROFILE_PAD_S before the first call
    and after the last; the spin kernels are left out of every count. A
    trace with no device event, with fewer kernels than the host launched,
    or with other than ``launches`` per call where that is given, is taken
    again, up to PROFILE_ATTEMPTS traces, each such trace printed; the
    caller gates the last trace's launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMES):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        total, per_launch, count, host, primes = {}, {}, 0, -PROFILE_PRIMES, 0
        for event in prof.key_averages():
            device_us = getattr(event, "device_time_total", 0.0)
            if device_us > 0 and "spin_kernel" in event.key:
                primes += event.count
            elif device_us > 0 and not event.key.startswith(("Memcpy", "Memset")):
                name = kernel_name(event.key)
                total[name] = total.get(name, 0.0) + device_us / calls
                per_launch[name] = device_us / event.count
                count += event.count
            elif event.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                host += event.count
        if primes < PROFILE_PRIMES:
            print(f"  torch.profiler trace {attempt} held {primes} of its {PROFILE_PRIMES} "
                  f"spin kernels", flush=True)
        if total and count == host and (launches is None or count == launches * calls):
            break
        print(f"  torch.profiler trace {attempt} of {PROFILE_ATTEMPTS} held {count} kernel "
              f"launches of the host's {host} for {calls} calls", flush=True)
    if not total:
        raise AssertionError("torch.profiler recorded no device time")
    return Profile(total, per_launch, count / calls, host / calls, attempt)


def kernel_breakdown(layer, n_head: int) -> dict:
    """Device time per CUDA kernel and kernel launches of one B1 call (fp32
    and bf16) at the sampling batch and of one B3 and one B4 call (fp32 and
    bf16) at the training batch, L=100, from ``torch.profiler``; B3's and
    B4's launches must be those their plans count, and their attention
    stages the mma.sync kernels (TRAIN_ATTENTION_FUNCTIONS: B3 the forward,
    B4 all three), no CUDA-core one."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    plans = {"B3": fet.train_fwd_plan(TRAIN_BATCH, MAX_LEN, d, n_head, d_ff)["launches"],
             "B4": fet.train_bwd_plan(TRAIN_BATCH, MAX_LEN, d, n_head, d_ff)["launches"]}
    attention = {"B3": TRAIN_ATTENTION_FUNCTIONS[:1], "B4": TRAIN_ATTENTION_FUNCTIONS}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        packed = fe.pack_encoder_layer(layer, n_head, dtype)
        x = torch.randn((SAMPLE_CHAINS, MAX_LEN, d), device="cuda").to(dtype)
        with torch.no_grad():
            out[f"B1 {str(dtype).removeprefix('torch.')}"] = device_us_by_kernel(
                lambda: fe.fused_encoder_layer(x, packed, n_head=n_head))
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "" if dtype == torch.float32 else " bfloat16"
        lay = {k: t.detach() for k, t in
               fet.pack_encoder_layer_train(layer, n_head, dtype).items()}
        x = torch.randn((TRAIN_BATCH, MAX_LEN, d), device="cuda").to(dtype)
        dy = torch.randn_like(x)
        out["B3" + suffix] = device_us_by_kernel(
            lambda: fet._launch_fwd(x, lay, 5, n_head, DROPOUT), launches=plans["B3"])
        out["B4" + suffix] = device_us_by_kernel(
            lambda: fet._launch_bwd(x, dy, lay, 5, n_head, DROPOUT), calls=5,
            launches=plans["B4"])
    for name, prof in out.items():
        kind = name.split()[0]
        batch = TRAIN_BATCH if kind in plans else SAMPLE_CHAINS
        print(f"  {name} B={batch} L={MAX_LEN}: device us per call by kernel (torch.profiler): "
              f"{json.dumps({k: round(v, 1) for k, v in prof.us_by_kernel.items()})}; total "
              f"{sum(prof.us_by_kernel.values()):.1f}; {prof.launches} kernel launches per "
              f"call (plan: {plans.get(kind, '-')}); traces taken {prof.traces}", flush=True)
        if kind in plans and prof.launches != plans[kind]:
            raise AssertionError(f"{name}: {prof.launches} kernel launches per call, the plan "
                                 f"counts {plans[kind]}")
        if kind in plans:
            names = list(prof.us_by_kernel)
            stages = [f for f in attention[kind] if not any(f in k for k in names)]
            core = [k for k in names if any(f in k for f in TRAIN_CUDA_CORE_ATTENTION)]
            if stages or core:
                raise AssertionError(f"{name}: attention stages not run on mma.sync: missing "
                                     f"{stages}, CUDA-core {core}")
    return {name: {"device_us_by_kernel": prof.us_by_kernel,
                   "launches_per_call": prof.launches, "profile_traces": prof.traces}
            for name, prof in out.items()}


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
    (instructions, HMMA, IMMA, IDP4A) of the kernels of B1, B2, B3, B4,
    B5/B6-bwd, B7 and B8 and fails if a product kernel has no tensor-core
    instruction (an int8 one no IMMA), if one of REQUIRED_PRODUCT_KERNELS
    is missing from them, if a kernel of B7/B8 holds an IDP4A, or if a
    training library holds a CUDA-core attention kernel."""
    def one(name: str) -> tuple[str, float, bool, dict]:
        t0 = time.perf_counter()
        cached = _build.library_path(name).exists()
        # each library's SASS is read as soon as it is built, while the
        # longer builds go on
        counts = sass_counts(_build.build(name))
        return name, time.perf_counter() - t0, cached, counts

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    sass = {}
    for name, seconds, cached, lib_sass in results:
        lib = _build.library_path(name)
        log = lib.with_suffix(".log")
        for kernel, usage in ptxas_usage(log.read_text() if log.exists() else ""):
            print(f"  ptxas {name}: {kernel}: {usage}")
        print(f"  {lib.name} ({'reused' if cached else 'built'} and read in {seconds:.2f} s)",
              flush=True)
        for kernel, counts in lib_sass.items():
            if any(k in kernel for k in PRODUCT_KERNELS + INT8_PRODUCT_KERNELS + (
                    "attention", "finish")):
                sass[f"{name}: {kernel}"] = counts
                print(f"  sass {name}: {kernel}: {counts['instructions']} instructions, "
                      f"{counts['hmma']} HMMA, {counts['imma']} IMMA, {counts['idp4a']} IDP4A",
                      flush=True)
    no_hmma = [k for k, c in sass.items()
               if any(p in k for p in PRODUCT_KERNELS) and c["hmma"] == 0]
    no_imma = [k for k, c in sass.items()
               if any(p in k for p in INT8_PRODUCT_KERNELS) and c["imma"] == 0]
    dp4a = [k for k, c in sass.items() if k.startswith("fused_encoder_int8: ") and c["idp4a"]]
    missing = [f"{lib}: {kernel}" for lib, kernel in REQUIRED_PRODUCT_KERNELS
               if not any(k.startswith(f"{lib}: ") and kernel in k for k in sass)]
    core_attention = [k for k in sass if k.startswith("fused_encoder_train")
                      and any(f in k for f in TRAIN_CUDA_CORE_ATTENTION)]
    if no_hmma or no_imma or dp4a or missing or core_attention:
        raise AssertionError(f"product kernels without tensor-core instructions: {no_hmma}; "
                             f"int8 ones without IMMA: {no_imma}; with IDP4A: {dp4a}; "
                             f"missing: {missing}; CUDA-core attention in the training "
                             f"libraries: {core_attention}")
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
    instructions, its tensor-core instructions (HMMA; IMMA for int8) and its
    IDP4A (``__dp4a``), the kernel's name demangled where ``c++filt`` is
    present."""
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
            counts[name] = {"instructions": 0, "hmma": 0, "imma": 0, "idp4a": 0}
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name]["instructions"] += 1
            counts[name]["hmma"] += "HMMA" in line
            counts[name]["imma"] += "IMMA" in line
            counts[name]["idp4a"] += "IDP4A" in line
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
        prof = device_us_by_kernel(lambda: fa.flash_attention(q, k, v))
    size = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(
        4 * TRAIN_BATCH * N_HEAD * MAX_LEN * MAX_LEN * dh, 4 * q.numel() * size, dtype
    )
    r = {"max_abs_err": err, "tol": tol, "err_bf16_ulps_of_max": ulps, "ms": kernel_ms,
         "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "device_us_by_kernel": prof.us_by_kernel, "profile_traces": prof.traces}
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
        r = {"form": fwd_form(l, dh, dtype, dtype == BF16 and dh < fa.DH_PAD),
             "max_abs_err": err, "tol": tol,
             "err_bf16_ulps_of_max": err / bf16_ulp(ref.float().abs().max().item()),
             "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
             "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
        prof = device_us_by_kernel(lambda: fa.flash_attention(q, k, v))
        r["device_us_by_kernel"], r["profile_traces"] = prof.us_by_kernel, prof.traces
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
    """The flagship with random weights from seed 0 (the same for any dtype):
    fp32 parameters computing in ``dtype``, or, for the fp64 reference,
    parameters in fp64."""
    torch.manual_seed(0)
    model = ScoreModelConfig(
        d_model=72, num_layers=N_LAYERS, n_head=N_HEAD, dim_feedforward=2048,
        dropout_rate=rate, dtype=dtype,
    ).build(n_channels=N_CHANNELS, max_len=MAX_LEN)
    return model.to(torch.float64) if dtype == "float64" else model


def flagship_trainer(plain: bool = False, rate: float = DROPOUT,
                     epochs: int = TRAIN_EPOCHS, mesh=None, dtype: str = "float32") -> Trainer:
    model = flagship_model(dtype, rate=rate)
    return Trainer(
        model, VPScheduler(fourier_noise_scaling=True), max_epochs=epochs,
        lr_max=1e-3, gradient_clip_val=1.0, ema_decay=0.999, spike_rollback_factor=2.5,
        spike_rollback_retries=2, val_noise_draws=VAL_DRAWS, seed=42, device="cuda",
        plain=plain, mesh=mesh,
    )


def synthetic_data(root: str) -> SyntheticDatamodule:
    dm = SyntheticDatamodule(
        data_dir=root, random_seed=42, batch_size=TRAIN_BATCH, fourier_transform=True,
        standardize=True, max_len=MAX_LEN, num_samples=TRAIN_SERIES, family="sine",
    )
    dm.prepare_data()
    dm.setup()
    return dm


STEP_SEED = 5  # draw_steps' streams


def draw_steps(dm: SyntheticDatamodule, n: int) -> list[tuple]:
    """``n`` train steps' inputs from a seed: a batch, its ``t`` and ``z``
    and one dropout seed per layer."""
    x_all = dm.train_arrays().standardized().to("cuda")
    g = torch.Generator(device="cuda").manual_seed(STEP_SEED)
    seeds = torch.Generator().manual_seed(STEP_SEED)
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
    by the layer's seed, its FFN pre-activations (from x1 rounded to the
    activation dtype, as the W1 product takes it), their sums of |terms|,
    its gates and the kept units; with ``force`` ({seed: gates}) it takes
    those gates forward and backward (``fused_encoder_layer_train_reference``'s
    ``gates``: the value keeps its size, the gradient passes an open gate
    and not a shut one). Without ``force`` it computes what
    ``fused_encoder_layer_train_reference`` computes."""
    reference = fused_models.fused_encoder_layer_train_reference

    def layer_fn(x, layer, seed, *, n_head, rate):
        b, l, d = x.shape
        masks = fet.dropout_masks(b, l, d, layer["w1"].shape[1], n_head, seed, rate, x.device)
        with torch.no_grad():
            x1 = fet.attention_sublayer(x, layer, masks, n_head)
            x1 = x1.to(x.dtype).to(x1.dtype)
            w1 = layer["w1"].to(x1.dtype)
            pre = x1 @ w1 + layer["b1"]
            terms = x1.abs() @ w1.abs() + layer["b1"].abs()
        record[seed] = (pre, terms, pre > 0, masks["ff"] > 0)
        return reference(x, layer, seed, n_head=n_head, rate=rate,
                         gates=None if force is None else force[seed])

    fused_models.fused_encoder_layer_train_reference = layer_fn
    try:
        yield
    finally:
        fused_models.fused_encoder_layer_train_reference = reference


def check_training(dm: SyntheticDatamodule, dtype: str = "float32") -> dict:
    """The first steps of the flagship computing in ``dtype`` (fp32
    parameters) through the kernels and through the plain versions. The
    losses are held to LOSS_TOL (bf16: BF16_LOSS_TOL) and the step-0
    gradients per tensor to GRAD_TOL (BF16_STEP_GRAD_TOL) against the plain
    path's or, where FFN ReLU gates flipped between the two paths, against
    the plain path with exactly the kernels' gates (as phase 11 does for the
    unfused path); every flip is located and must lie within GATE_BAND
    (BF16_STEP_GATE_BAND) x sum |terms| of 0. In fp32 both paths' gradients
    are printed beside an fp64 run's; in bf16 the parameters and their
    gradients must stay fp32."""
    band, grad_tol, loss_tol = {
        "float32": (GATE_BAND, GRAD_TOL, LOSS_TOL),
        "bfloat16": (BF16_STEP_GATE_BAND, BF16_STEP_GRAD_TOL, BF16_LOSS_TOL)}[dtype]
    steps = draw_steps(dm, CHECK_STEPS)
    kernel, plain = flagship_trainer(dtype=dtype), flagship_trainer(plain=True, dtype=dtype)
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
    farthest = max((abs(f["pre_plain"]) / f["terms"] for f in located), default=0.0)
    if farthest > band:
        raise AssertionError(f"training check {dtype}: a ReLU gate flipped {farthest} x sum "
                             f"|terms| from 0")
    grads["gate_matched"] = grads["plain"]
    if located:
        matched = flagship_trainer(plain=True, dtype=dtype)
        matched.start(n_steps)
        with plain_gates({}, force):
            grads["gate_matched"] = matched.loss_and_grads(*steps[0])[1]
    del force
    if dtype == "float32":
        exact = Trainer(flagship_model("float64"), VPScheduler(fourier_noise_scaling=True),
                        device="cuda", plain=True)
        x0, t0, z0, seeds0 = steps[0]
        grads["fp64"] = exact.loss_and_grads(x0.double(), t0.double(), z0.double(), seeds0)[1]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"]))
    print(f"  {dtype} losses kernel {losses['kernel']} plain {losses['plain']}: max rel diff "
          f"{rel_loss:.3e} (tol {loss_tol:.0e})", flush=True)
    if not all(math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        raise AssertionError(f"training check {dtype}: losses not finite: {losses}")
    if not rel_loss <= loss_tol:
        raise AssertionError(f"training check {dtype}: losses disagree: {rel_loss}")
    fp32 = all(g.dtype == torch.float32 for g in grads["kernel"]) and all(
        p.dtype == torch.float32 for t in (kernel, plain) for p in t.params)
    if not fp32:
        raise AssertionError(f"training check {dtype}: parameters or gradients not fp32")
    rel = {}
    for i, (name, k, p, m) in enumerate(zip(kernel.names, grads["kernel"], grads["plain"],
                                            grads["gate_matched"])):
        rel[name] = {"vs_plain": rel_err(k, p), "vs_gate_matched": rel_err(k, m)}
        if "fp64" in grads:
            rel[name].update(kernel_vs_fp64=rel_err(k, grads["fp64"][i]),
                             plain_vs_fp64=rel_err(p, grads["fp64"][i]))
        r = rel[name]
        if not (r["vs_plain"] <= grad_tol or (located and r["vs_gate_matched"] <= grad_tol)):
            raise AssertionError(f"training check {dtype}: gradient {name} disagrees: {r}")
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_plain"])
    worst_m = max(r["vs_gate_matched"] for r in rel.values())
    print(f"  {dtype} step-0 gradients: worst against plain {worst[0]} {json.dumps(worst[1])}, "
          f"worst against gate-matched plain {worst_m:.3e} (tol {grad_tol:.1e}); ReLU gates "
          f"flipped between the paths: {len(located)}, the farthest {farthest:.3e} x sum |terms| "
          f"from 0 (band {band:.1e}), the first {json.dumps(located[:3])}; per tensor "
          f"{json.dumps(rel)}", flush=True)
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_plain"],
            "grad_rel_err_gate_matched": worst_m, "gate_flips": len(located),
            "gate_flip_farthest": farthest, "step_losses": losses}


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


def check_attention_kernels(b: int, h: int, l: int, dh: int) -> dict:
    """B6-fwd on random fp32 (b, h, l, dh) heads against its plain version,
    the masks bit for bit, its time, bound and yardstick, and B2's time on
    the same heads beside SDPA's."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((b, h, l, dh), generator=g, device="cuda") for _ in range(3))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    shape = f"B={b} H={h} L={l} dh={dh}"
    kernel_keep = fa.attention_keep_cuda(b, h, l, seed, DROPOUT)
    if not torch.equal(kernel_keep, fa.attention_keep(b, h, l, seed, DROPOUT, "cuda")):
        raise AssertionError(f"B6 {shape}: the masks of the kernel and plain differ")
    with torch.no_grad():
        b6f = fa._launch_fwd(q, k, v, seed, DROPOUT)
        b6f_plain = fa.flash_attention_dropout_reference(q, k, v, seed, DROPOUT)
        torch.cuda.synchronize()
        r = {"B6-fwd": {"form": fwd_form(l, dh, torch.float32),
                        "max_abs_err": (b6f - b6f_plain).abs().max().item()}}
        if not (torch.isfinite(b6f).all() and r["B6-fwd"]["max_abs_err"] <= ATTN_TOL):
            raise AssertionError(f"B6-fwd {shape}: kernel disagrees with plain version: {r}")
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
    r["B6-fwd"]["bound_ms"], r["B6-fwd"]["bound_by"] = bound(
        4 * b * h * l * l * dh, 4 * q.numel() * 4 + 8, torch.float32)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    r["sdpa_backend"] = {"no dropout": sdpa_backend(qg, kg, vg, 0.0),
                         f"dropout {DROPOUT}": sdpa_backend(qg, kg, vg, DROPOUT)}
    print(f"  B6-fwd {shape}: masks bit for bit; {json.dumps(r)} (outputs tol "
          f"{ATTN_TOL:.0e})", flush=True)
    return r


def bwd_form(b: int, h: int, l: int, dh: int, dtype: torch.dtype) -> dict:
    """The form of B5/B6-bwd's launch 1 at this shape, from the plan the
    wrapper passes: S kept in registers (the head resident), the head
    resident, or streamed through the ring; the rows per CTA and the CTAs of
    each launch."""
    p = fa.attention_bwd_plan(l, dh, dtype)
    return {"launch1": "kept" if p["kept"] else "resident" if p["resident"] else "ring",
            "rows_per_cta": p["warps"] * fa.WARP_ROWS, "ctas": b * h * p["tiles"]}


def fwd_form(l: int, dh: int, dtype: torch.dtype, fast: bool = False) -> str:
    """The form of the attention forward at this length and head width
    (B2, B6-fwd, the training layer's attention), from the plan the wrapper
    passes: S kept in registers (the head resident), the head resident, or
    streamed through the ring."""
    p = fa.attention_fwd_plan(l, dh, dtype, fast)
    return "kept" if p["kept"] else "resident" if p["resident"] else "ring"


def check_attention_bwd(b: int, h: int, l: int, dh: int) -> dict:
    """B5 and B6-bwd (dropout 0.1) on random fp32 (b, h, l, dh) heads, from
    the plain forward's output, against their plain versions (JAX's
    ``_bwd_core``; B5 also against autograd of the plain forward), to
    GRAD_TOL of each tensor's largest; launch 1's statistics against
    ``attention_bwd_staged`` to STATS_TOL; two calls bit-identical;
    BWD_LAUNCHES CUDA launches per call counted by ``torch.profiler``, with
    each launch's device time; and the times of the kernel, its plain
    version and SDPA's autograd backward (with ``dropout_p`` 0.1 for
    B6-bwd), its bound and 3xTF32 bound."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g, device="cuda") for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    shape = f"B={b} H={h} L={l} dh={dh}"
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    # The five products S = q k^T, dP = dO v^T, dq = dS k, dk = dS^T q and
    # dv = P^T dO; D comes from the saved output o.
    flops = 10 * b * h * l * l * dh
    grads, out = ("dq", "dk", "dv"), {}
    for name, sd, rate in (("B5", None, 0.0), ("B6-bwd", seed, DROPOUT)):
        keep = None if sd is None else fa.attention_keep(b, h, l, seed, rate, "cuda")
        if sd is None:
            o = fa.flash_attention_reference(q, k, v)
            plain_fn = lambda: fa.flash_attention_bwd_reference(q, k, v, do)  # noqa: E731
        else:
            o = fa.flash_attention_dropout_reference(q, k, v, seed, rate)
            plain_fn = lambda: fa.flash_attention_dropout_bwd_reference(  # noqa: E731
                q, k, v, do, seed, rate)
        call = lambda: fa._launch_bwd(q, k, v, o, do, sd, rate)  # noqa: E731
        got, again, plain = call(), call(), plain_fn()
        staged = fa.attention_bwd_staged(q, k, v, o, do, keep)
        torch.cuda.synchronize()
        r = {"form": bwd_form(b, h, l, dh, torch.float32),
             "max_rel_err": {n: rel_err(a, p) for n, a, p in zip(grads, got, plain)},
             "max_abs_err": max((a - p).abs().max().item() for a, p in zip(got, plain)),
             "stats_rel_err": {n: rel_err(got[3][..., i], staged[3][..., i])
                               for i, n in enumerate(("m", "l", "D"))},
             "bit_identical": all(torch.equal(a, c) for a, c in zip(got, again))}
        if sd is None:
            ref = torch.autograd.grad(fa.flash_attention_reference(qg, kg, vg), (qg, kg, vg), do)
            r["vs_autograd_of_plain"] = {n: rel_err(a, p) for n, a, p in zip(grads, got, ref)}
        del keep, staged, again, plain
        bad = [n for n, t in zip(grads, got) if not torch.isfinite(t).all()]
        worst = max(r["max_rel_err"].values())
        if sd is None:
            worst = max(worst, *r["vs_autograd_of_plain"].values())
        if bad or not worst <= GRAD_TOL:
            raise AssertionError(f"{name} {shape}: kernel disagrees with plain version "
                                 f"(not finite: {bad}): {r}")
        if not max(r["stats_rel_err"].values()) <= STATS_TOL:
            raise AssertionError(f"{name} {shape}: launch 1's statistics disagree with the "
                                 f"staged plain version: {r['stats_rel_err']}")
        if not r["bit_identical"]:
            raise AssertionError(f"{name} {shape}: two calls on the same inputs differ")
        prof = device_us_by_kernel(call, launches=BWD_LAUNCHES)
        r["device_us_by_kernel"], r["launches_per_call"], r["profile_traces"] = \
            prof.us_by_kernel, prof.launches, prof.traces
        if r["launches_per_call"] != BWD_LAUNCHES:
            raise AssertionError(f"{name} {shape}: {r['launches_per_call']} CUDA launches per "
                                 f"call, expected {BWD_LAUNCHES}")
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
        r.update(ms=time_ms(call), plain_ms=time_ms(plain_fn, iters=10),
                 library_ms=time_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                                                retain_graph=True)))
        del sdpa, got
        r["bound_ms"], r["bound_by"] = bound(flops, 8 * q.numel() * 4 + (0 if sd is None else 8),
                                             torch.float32)
        print(f"  {name} {shape}: {json.dumps(r)} (gradients tol {GRAD_TOL:.0e} of max, "
              f"statistics tol {STATS_TOL:.0e} of max; 3xTF32 bound "
              f"{tf32x3_bound_ms(flops):.6f} ms; before the redesign "
              f"{PRIOR_MS[name].get(shape)} ms)", flush=True)
        out[name] = r
    return out


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
    17, with every layer's FFN ReLU gates recorded by a hook on ``linear1``
    (``gated_step0``)."""
    return gated_step0(trainer, step, [layer.linear1 for layer in trainer.model.backbone.layers],
                       force)


def gated_step0(trainer: Trainer, step: tuple, linears: list, force: dict | None = None) -> tuple:
    """Step-0 gradients of the unfused path, drawing from a generator seeded
    17, with the ReLU gates after each of ``linears`` recorded by a hook on
    it: the gates (pre-activation > 0), the pre-activations and their sums
    of |terms| (|x| |W| + |b|, in fp32), by the linear's index. ``force``
    {index: (where, open)} sets the gates at ``where`` to ``open`` (the
    value keeps its size, the gradient passes through an open gate and not
    a shut one)."""
    gates, pres, terms, handles = {}, {}, {}, []

    def hook(i: int):
        def record(mod, inputs, out):
            pres[i] = out.detach()
            gates[i] = pres[i] > 0
            terms[i] = (inputs[0].detach().float().abs() @ mod.weight.detach().abs().t()
                        + mod.bias.detach().abs())
            if force is not None and i in force:
                where, want_open = force[i]
                size = out.detach().abs().clamp_min(1e-30)
                forced = out - out.detach() + torch.where(want_open, size, -size)
                return torch.where(where, forced, out)
            return None
        return record

    for i, linear in enumerate(linears):
        handles.append(linear.register_forward_hook(hook(i)))
    try:
        x0, t0, z0, _ = step
        gen = torch.Generator(device=trainer.device).manual_seed(17)
        grads = trainer.loss_and_grads(x0, t0, z0, generator=gen)[1]
    finally:
        for h in handles:
            h.remove()
    return grads, gates, pres, terms


def check_unfused_training(dm: SyntheticDatamodule, rate: float,
                           dtype: str = "float32") -> dict:
    """The first steps of unfused training of the flagship computing in
    ``dtype`` (fp32 parameters) through the kernels and through
    ``plain=True``, with generators seeded alike (the same attention seeds
    and FFN-site draws). The losses are held to LOSS_TOL (bf16:
    BF16_LOSS_TOL) and the step-0 gradients per tensor to GRAD_TOL (bf16:
    BF16_STEP_GRAD_TOL) against the plain path's or, where FFN ReLU gates
    flipped between the two paths, against the plain path with exactly
    those gates set as the kernel path had them; every flip is located,
    printed and must lie within GATE_BAND (bf16: BF16_STEP_GATE_BAND) x sum
    |terms| of 0 (as B4's gate, above). In bf16 the parameters and their
    gradients must stay fp32."""
    band, grad_tol, loss_tol = {
        "float32": (GATE_BAND, GRAD_TOL, LOSS_TOL),
        "bfloat16": (BF16_STEP_GATE_BAND, BF16_STEP_GRAD_TOL, BF16_LOSS_TOL)}[dtype]
    steps = draw_steps(dm, CHECK_STEPS)
    n_steps = dm.steps_per_epoch * TRAIN_EPOCHS
    with unfused_training():
        kernel = flagship_trainer(rate=rate, dtype=dtype)
        plain = flagship_trainer(plain=True, rate=rate, dtype=dtype)
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
        far = [f for f in located if abs(f["pre_plain"]) > band * f["terms"]]
        if far:
            raise AssertionError(f"unfused check {dtype}: ReLU gates flipped away from 0: {far}")
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
    what = f"unfused {dtype}, dropout {rate}"
    print(f"  {what}: losses kernel {losses['kernel']} plain "
          f"{losses['plain']}: max rel diff {rel_loss:.3e} (tol {loss_tol:.0e})", flush=True)
    if not all(math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        raise AssertionError(f"unfused check {dtype}: losses not finite: {losses}")
    if not rel_loss <= loss_tol:
        raise AssertionError(f"unfused check {dtype}: losses disagree: {rel_loss}")
    if not (all(g.dtype == torch.float32 for g in grads_k + grads_p) and all(
            p.dtype == torch.float32 for t in (kernel, plain) for p in t.params)):
        raise AssertionError(f"unfused check {dtype}: parameters or gradients not fp32")
    rel = {n: {"vs_plain": rel_err(k, p), "vs_gate_matched": rel_err(k, m)}
           for n, k, p, m in zip(kernel.names, grads_k, grads_p, grads_m)}
    for n, r in rel.items():
        if not (r["vs_plain"] <= grad_tol or (flips and r["vs_gate_matched"] <= grad_tol)):
            raise AssertionError(f"unfused check {dtype}: gradient {n} disagrees: {r}")
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_plain"])
    worst_m = max(r["vs_gate_matched"] for r in rel.values())
    farthest = max((abs(f["pre_plain"]) / f["terms"] for f in located), default=0.0)
    print(f"  {what}: step-0 gradients, worst against plain {worst[0]} "
          f"{json.dumps(worst[1])}, worst against gate-matched plain {worst_m:.3e} (tol "
          f"{grad_tol:.1e}); ReLU gates flipped between the paths: {len(located)}, the "
          f"farthest {farthest:.3e} x sum |terms| from 0 (band {band:.1e}): "
          f"{json.dumps(located[:20])}; per tensor {json.dumps(rel)}", flush=True)
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_plain"],
            "grad_rel_err_gate_matched": worst_m, "gate_flips": len(located),
            "gate_flips_first": located[:20], "gate_flip_farthest": farthest,
            "step_losses": losses}


def reset_counts() -> None:
    fet.fwd_launches = fet.bwd_launches = fe.launches = 0
    fe.int8_launches = fe.int8_attn_launches = 0
    fa.launches = fa.bwd_launches = fa.dropout_fwd_launches = fa.dropout_bwd_launches = 0
    fa.fast_launches = 0


def read_counts() -> dict:
    return {"B1": fe.launches, "B2": fa.launches, "B3": fet.fwd_launches,
            "B4": fet.bwd_launches, "B5": fa.bwd_launches,
            "B6-fwd": fa.dropout_fwd_launches, "B6-bwd": fa.dropout_bwd_launches,
            "B7": fe.int8_launches, "B8": fe.int8_attn_launches}


def run_unfused_training(dm: SyntheticDatamodule, rate: float, dtype: str = "float32") -> dict:
    """The unfused training main path of the flagship computing in ``dtype``
    (fp32 parameters); the counts are read around ``fit`` alone. In bf16
    every B2 launch takes its fast form (validation, and at rate 0 the
    training forward, as JAX's ``_fast_fwd_kernel``), in fp32 none."""
    trainer = flagship_trainer(rate=rate, epochs=UNFUSED_EPOCHS, dtype=dtype)
    with unfused_training():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        history = trainer.fit(dm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**read_counts(), "B2 fast bf16": fa.fast_launches}
    steps = dm.steps_per_epoch * UNFUSED_EPOCHS
    train = steps * N_LAYERS
    val = UNFUSED_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH) * VAL_DRAWS * N_LAYERS
    expected = {"B1": 0, "B3": 0, "B4": 0, "B7": 0, "B8": 0}
    if rate > 0.0:
        expected.update({"B2": val, "B5": 0, "B6-fwd": train, "B6-bwd": train})
    else:
        expected.update({"B2": train + val, "B5": train, "B6-fwd": 0, "B6-bwd": 0})
    expected["B2 fast bf16"] = expected["B2"] if dtype == "bfloat16" else 0
    what = f"unfused {dtype}, dropout {rate}"
    for h in history:
        print(f"  {what}, epoch {h['epoch']}: {json.dumps(h)}", flush=True)
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")
    if len(history) != UNFUSED_EPOCHS or not all(
        math.isfinite(h["train/loss"]) and math.isfinite(h["val/loss"]) for h in history
    ):
        raise AssertionError(f"{what}: epochs or losses wrong: {history}")
    if not all(torch.isfinite(p).all() and p.dtype == torch.float32 for p in trainer.params):
        raise AssertionError(f"{what}: parameters are not finite fp32")
    train_s = sum(h["train_seconds"] for h in history)
    r = {"launches": counts, "seconds": seconds, "steps": steps,
         "steps_per_s": steps / train_s, "step_ms": 1e3 * train_s / steps,
         "epoch_steps_per_sec": [h["steps_per_sec"] for h in history],
         "val_pass_s": sum(h["val_seconds"] for h in history) / UNFUSED_EPOCHS,
         "losses": [(h["train/loss"], h["val/loss"]) for h in history]}
    print(f"  {what}: {steps} steps in {train_s:.3f} s = "
          f"{r['steps_per_s']:.3f} steps/s ({r['step_ms']:.2f} ms/step); launches {counts} "
          f"(a B5 or B6-bwd call is {BWD_LAUNCHES} CUDA launches)", flush=True)
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
    prior = PRIOR_MS[INT8_NAMES[level]].get(
        f"{str(dtype).removeprefix('torch.')} L={l} D={d} B={batch}")
    print(f"  {what}: kernel {kernel_ms:.4f} ms"
          + ("" if prior is None else f" (before the redesign: {prior:.4f})")
          + f", plain {plain_ms:.4f} ms, B1 {b1_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return {"max_abs_err": err, "max_abs_err_vs_plain": err_plain, "tol": TOL[dtype],
            "flips": flips, "ms": kernel_ms, "plain_ms": plain_ms,
            "b1_ms": b1_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def int8_breakdown(layer, n_head: int) -> dict:
    """Device time per CUDA launch and the launches of one B7 and one B8
    call (fp32 and bf16) at the main path's shape, B=32, L=100, from
    ``torch.profiler``: the launches per call must be ``int8_plan``'s, each
    of its kernels once."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    out = {}
    for dtype, level in itertools.product((torch.float32, torch.bfloat16), INT8_LEVELS):
        packed = fe.pack_encoder_layer(layer, n_head, dtype, int8_ffn=True,
                                       int8_attn=level == 2)
        x = torch.randn((SAMPLE_CHAINS, MAX_LEN, d), device="cuda").to(dtype)
        plan = fe.int8_plan(SAMPLE_CHAINS, MAX_LEN, d, n_head, d_ff, dtype, level,
                            fe.sm_count(x.device))
        with torch.no_grad():
            prof = device_us_by_kernel(lambda: fe.fused_encoder_layer(x, packed, n_head=n_head),
                                       launches=plan["launches"])
        kernels = prof.us_per_launch
        what = f"{INT8_NAMES[level]} {str(dtype).removeprefix('torch.')}"
        print(f"  {what} B={SAMPLE_CHAINS} L={MAX_LEN}: device us per launch by kernel "
              f"(torch.profiler): {json.dumps({k: round(v, 1) for k, v in kernels.items()})}; "
              f"sum {sum(kernels.values()):.1f}; {prof.launches} kernel launches per call "
              f"({prof.host_launches} by the host; plan: {plan['launches']}); traces taken "
              f"{prof.traces}", flush=True)
        missing = [k for k, _, _ in plan["kernels"] if not any(k in name for name in kernels)]
        if prof.launches != plan["launches"] or missing or len(kernels) != plan["launches"]:
            raise AssertionError(f"{what}: {prof.launches} kernel launches per call of kernels "
                                 f"{list(kernels)}; the plan counts {plan['launches']} "
                                 f"({missing} missing)")
        out[what] = {"device_us_per_launch": kernels, "launches_per_call": prof.launches,
                     "profile_traces": prof.traces}
    return out


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
    sizes = {}
    for level, (l, d, n_head, d_ff) in itertools.product(
            INT8_LEVELS, ((MAX_LEN, 72, N_HEAD, 2048),) + COVERAGE):
        plan = fe.int8_plan(1, l, d, n_head, d_ff, torch.bfloat16, level)
        sizes[f"{INT8_NAMES[level]} L={l} D={d} F={d_ff} bf16"] = {
            "smem bytes by launch": {k: b for k, _, b in plan["kernels"]},
            "tail CTAs per SM": plan["tail_ctas_per_sm"],
            "workspace bytes per chain": sum(
                n * torch.finfo(t).bits // 8 for n, t in filter(None, plan["workspaces"].values()))}
    print(f"  int8 plans: {json.dumps(sizes)}", flush=True)
    out["breakdown"] = int8_breakdown(load_flagship(torch.float32, "cuda").backbone.layers[0],
                                      N_HEAD)
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


def read_scalars(path: Path) -> dict[str, float]:
    """The top-level ``key: number`` lines of a results.yaml file (the
    card's machine has no YAML reader; lists and nested maps are skipped)."""
    out = {}
    for line in path.read_text().splitlines():
        m = re.fullmatch(r"([a-z_0-9]+): (-?[0-9.]+(?:e[-+]?[0-9]+)?)", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def quality_metrics(dm: SyntheticDatamodule, device: str = "cuda") -> MetricCollection:
    """The JAX package's metric collection against the synthetic training
    series, on ``device``."""
    return MetricCollection(
        metric_factories=[
            lambda o: SlicedWasserstein(o, random_seed=QUALITY_SEED,
                                        num_directions=QUALITY_DIRECTIONS,
                                        save_all_distances=True, device=device),
            lambda o: MarginalWasserstein(o, random_seed=QUALITY_SEED, save_all_distances=True,
                                          device=device),
        ],
        original_samples=dm.X_train, include_baselines=True, include_spectral_density=True,
        device=device,
    )


def run_quality(name: str, dtype: torch.dtype, level: int, dm: SyntheticDatamodule,
                metrics: MetricCollection) -> dict:
    """One phase-16 run: QUALITY_DRAWN series from the trained flagship
    (K=1000 EM steps, every layer through B1, or B7/B8 at ``level``), turned
    back into the data's scale (the training statistics, then ``idft``) as
    the JAX sampling CLI does, their census, and their metrics over all of
    them and over the first QUALITY_SAMPLES."""
    with environ("FDIFF_FUSED_INT8", str(level)):
        sampler = DiffusionSampler(
            load_flagship(dtype, "cuda"), VPScheduler(fourier_noise_scaling=True),
            max_len=MAX_LEN, n_channels=N_CHANNELS, sample_batch_size=QUALITY_BATCH,
            method="em", device="cuda",
        )
        g = torch.Generator(device="cuda").manual_seed(QUALITY_SEED)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = sampler.sample(QUALITY_DRAWN, num_diffusion_steps=SAMPLE_STEPS, generator=g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    kernel = INT8_NAMES[level] if level else "B1"
    expected = {k: 0 for k in counts}
    expected[kernel] = SAMPLE_STEPS * N_LAYERS * -(-QUALITY_DRAWN // QUALITY_BATCH)
    if counts != expected:
        raise AssertionError(f"quality {name}: launches {counts}, expected {expected}")
    series = dm.samples_to_data(out.float())
    if tuple(series.shape) != (QUALITY_DRAWN, MAX_LEN, N_CHANNELS) or not torch.isfinite(
            series).all():
        raise AssertionError(f"quality {name}: samples wrong or not finite")
    t1 = time.perf_counter()
    scores = {n: metrics(series[:n]) for n in (QUALITY_DRAWN, QUALITY_SAMPLES)}
    metric_s = time.perf_counter() - t1
    census = census_fields(series.cpu().numpy(), guard_active=False,
                           num_samples=QUALITY_DRAWN, num_diffusion_steps=SAMPLE_STEPS,
                           method="em", sampling_seed=QUALITY_SEED)
    absmax = series.abs().flatten(1).amax(1)
    return {"seconds": seconds, "metric_seconds": metric_s, "launches": counts[kernel],
            "kernel": kernel,
            "results": {n: {k: v for k, v in r.items() if not k.endswith("_all")}
                        for n, r in scores.items()},
            "census": {**{k: census[k] for k in ("divergence_census_count",
                                                 "divergence_census_max_absmax")},
                       "chains_absmax_above_4": int((absmax > 4).sum()),
                       "first_above_4": [int(i) for i in torch.nonzero(absmax > 4)[:20, 0]]}}


def check_quality() -> dict:
    """Phase 16: every QUALITY_RUNS run scored over QUALITY_DRAWN and over
    its first QUALITY_SAMPLES samples; each key of QUALITY_KEYS below its
    _dummy baseline in every run at both counts and within
    QUALITY_REF_FACTOR of the reference's results.yaml over all the samples
    of the gated runs; every *_mean printed beside results.yaml's and
    results_cross_our_sampler.yaml's, and the int8 runs' ratio to the bf16
    run at both counts."""
    reference, cross = read_scalars(REFERENCE_RESULTS), read_scalars(CROSS_RESULTS)
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        dm = synthetic_data(root)
        metrics = quality_metrics(dm)
        for name, dtype, level in QUALITY_RUNS:
            runs[name] = run_quality(name, dtype, level, dm, metrics)
            r = runs[name]
            print(f"  {name}: {QUALITY_DRAWN} samples x {SAMPLE_STEPS} steps in "
                  f"{r['seconds']:.3f} s ({r['kernel']} launches {r['launches']}), metrics "
                  f"{r['metric_seconds']:.3f} s; census {json.dumps(r['census'])}", flush=True)
    failures = []
    for name, r in runs.items():
        for n, key in itertools.product((QUALITY_DRAWN, QUALITY_SAMPLES), QUALITY_KEYS):
            got, dummy = r["results"][n][key], r["results"][n][f"{key}_dummy"]
            if not got < dummy:
                failures.append(f"{name} n={n} {key} {got} not below its dummy {dummy}")
        for key in QUALITY_KEYS:
            got = r["results"][QUALITY_DRAWN][key]
            if name in QUALITY_GATED and not got <= QUALITY_REF_FACTOR * reference[key]:
                failures.append(f"{name} {key} {got} above {QUALITY_REF_FACTOR} x the "
                                f"reference's {reference[key]}")
    for n in (QUALITY_DRAWN, QUALITY_SAMPLES):
        bf16 = runs["bfloat16"]["results"][n]
        for key in sorted(k for k in bf16 if k.endswith("_mean")):
            cells = "  ".join(f"{name} {r['results'][n][key]:.6f}" for name, r in runs.items())
            ratios = "  ".join(f"{name}/bf16 {r['results'][n][key] / bf16[key]:.4f}"
                               for name, r in runs.items() if name.startswith("int8"))
            print(f"  n={n} {key}: {cells}  | results.yaml {reference.get(key, math.nan):.6f}"
                  f"  cross {cross.get(key, math.nan):.6f}  | {ratios}", flush=True)
    for name, r in runs.items():
        got = {key: r["results"][QUALITY_DRAWN][key] for key in QUALITY_KEYS}
        prior = QUALITY_PRIOR.get(name, {})
        print(f"  {name} n={QUALITY_DRAWN} against QUALITY_PRIOR: " + "; ".join(
            f"{key} {got[key]!r} ({prior.get(key)!r})" for key in QUALITY_KEYS)
            + f"; all equal to the last digit: {got == prior}", flush=True)
    if failures:
        raise AssertionError("sample quality: " + "; ".join(failures))
    return {"runs": runs, "reference": {k: reference[k] for k in QUALITY_KEYS},
            "cross": {k: cross[k] for k in QUALITY_KEYS}}


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


# Phase 17, the CLI path: the flagship's training configuration
# (runs/4ffeaa7e/train_config.yaml) through fdiff-torch-train, cut to
# CLI_EPOCHS epochs, with `last` written every epoch and the sampling
# callback on every CLI_EVERY epochs (so at epochs 0 and 2: CLI_CALLBACKS
# calls of CLI_CALLBACK_SAMPLES chains); the same run interrupted in the
# epoch after CLI_RESUME_FROM and resumed; and fdiff-torch-sample on the
# trained ref-freq42-e200 weights as phase 16 samples them in fp32.
CLI_EPOCHS, CLI_EVERY, CLI_CALLBACKS = 3, 2, 2
CLI_CALLBACK_SAMPLES, CLI_CALLBACK_DIRECTIONS = 64, 200
CLI_RESUME_FROM = 1
# The record keys of the JAX package's metrics.jsonl: an epoch's, and a
# sampling callback's.
JSONL_EPOCH_KEYS = ("_time", "_step", "train/loss", "val/loss", "lr", "epoch", "step",
                    "steps_per_sec")
JSONL_CALLBACK_KEYS = tuple(f"metrics/{d}_{m}_wasserstein_{s}" for d in ("time", "freq")
                            for m in ("sliced", "marginal") for s in ("mean", "max"))
# The largest absolute difference allowed between the resumed run's `last`
# (params and EMA) and the uninterrupted run's: the same draws, the same
# weights read back from the file, and kernels that repeat bit for bit
# (phase 6), so none.
RESUME_TOL = 0.0


def cli_train_overrides(root: Path) -> list[str]:
    """fdiff-torch-train's overrides for phase 17 (a) and (b)."""
    sampling = "trainer.callbacks.sampling"
    return [f"run_dir={root / 'runs'}", "datamodule=synthetic",
            f"datamodule.data_dir={root / 'data'}", "fourier_transform=true",
            "trainer.ema_decay=0.999", "trainer.save_last_every_n=1",
            f"trainer.max_epochs={CLI_EPOCHS}", f"{sampling}.enabled=true",
            f"{sampling}.every_n_epochs={CLI_EVERY}",
            f"{sampling}.num_samples={CLI_CALLBACK_SAMPLES}",
            f"{sampling}.num_diffusion_steps={SAMPLE_STEPS}",
            f"{sampling}.num_directions={CLI_CALLBACK_DIRECTIONS}"]


def run_cli(main_fn, argv: list[str]) -> str:
    """``main_fn(argv)``, its standard output captured and returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    return out.getvalue()


class Interrupt(Exception):
    pass


def interrupt_at(stop_epoch: int):
    """A training callback that stops the run in ``stop_epoch``, after its
    training and before its `last` is written."""
    def callback(trainer, epoch, params, constants, metrics):
        if epoch == stop_epoch:
            raise Interrupt(f"stopped in epoch {epoch}")
    return callback


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def train_through_cli(root: Path) -> dict:
    """(a): fdiff-torch-train on the flagship's training configuration; the
    counts are read around ``main`` alone."""
    overrides = cli_train_overrides(root)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stdout = run_cli(cli_train.main, overrides)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    run_id = re.search(r"^run_id=(\S+)$", stdout, re.M).group(1)
    run_dir = root / "runs" / run_id
    saved = yamlio.load(run_dir / "train_config.yaml")
    if saved != compose("train", overrides):
        raise AssertionError("cli train: train_config.yaml differs from the composed config")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    callbacks = [r for r in records if any(k.startswith("metrics/") for k in r)]
    if len(epochs) != CLI_EPOCHS or [r["epoch"] for r in epochs] != list(range(CLI_EPOCHS)):
        raise AssertionError(f"cli train: epoch records {epochs}")
    for r in epochs:
        if missing := set(JSONL_EPOCH_KEYS) - set(r):
            raise AssertionError(f"cli train: epoch record lacks {sorted(missing)}")
        if not (math.isfinite(r["train/loss"]) and math.isfinite(r["val/loss"])):
            raise AssertionError(f"cli train: loss not finite: {r}")
    if len(callbacks) != CLI_CALLBACKS or any(
            set(JSONL_CALLBACK_KEYS) - set(r) for r in callbacks):
        raise AssertionError(f"cli train: {len(callbacks)} callback records: {callbacks}")
    best = sorted(p.name for p in (run_dir / "checkpoints").glob("epoch=*"))
    if len(best) != 1 or not (run_dir / "checkpoints" / "last" / "train_state.pt").exists():
        raise AssertionError(f"cli train: checkpoints {best}, last missing or present")
    steps = CLI_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH)
    val_batches = -(-TRAIN_SERIES // TRAIN_BATCH)
    expected = {k: 0 for k in counts}
    expected.update({"B3": steps * N_LAYERS, "B4": steps * N_LAYERS,
                     "B2": CLI_EPOCHS * val_batches * VAL_DRAWS * N_LAYERS,
                     "B1": CLI_CALLBACKS * SAMPLE_STEPS * N_LAYERS})
    if counts != expected:
        raise AssertionError(f"cli train: launches {counts}, expected {expected}")
    print(f"  (a) fdiff-torch-train run_id={run_id}: {CLI_EPOCHS} epochs, {steps} steps in "
          f"{seconds:.3f} s; checkpoints {best} + last; launches {counts}; losses "
          f"{[(r['train/loss'], r['val/loss']) for r in epochs]}; callback time sliced W2 "
          f"{[r['metrics/time_sliced_wasserstein_mean'] for r in callbacks]}", flush=True)
    return {"seconds": seconds, "launches": counts, "run_id": run_id, "steps": steps,
            "losses": [(r["train/loss"], r["val/loss"]) for r in epochs]}


def resume_through_cli(root: Path, trained: dict) -> dict:
    """(b): the same configuration under a second run id, interrupted in the
    epoch after CLI_RESUME_FROM, then ``fdiff-torch-train resume=<id>``; its
    `last` against (a)'s."""
    t0 = time.perf_counter()
    runner = cli_train.TrainingRunner(compose("train", cli_train_overrides(root)))
    runner.trainer.callbacks = (interrupt_at(CLI_RESUME_FROM + 1),) + runner.trainer.callbacks
    with contextlib.suppress(Interrupt):
        runner.train()
    last = runner.run_dir / "checkpoints" / "last"
    saved_epoch = json.loads((last / "metadata.json").read_text())["epoch"]
    if saved_epoch != CLI_RESUME_FROM:
        raise AssertionError(f"cli resume: the interrupted run's last is epoch {saved_epoch}")
    stdout = run_cli(cli_train.main, [f"resume={runner.run_id}", f"run_dir={root / 'runs'}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if f"run_id={runner.run_id}" not in stdout:
        raise AssertionError(f"cli resume: printed {stdout!r}")
    states = [torch.load(root / "runs" / rid / "checkpoints" / "last" / "train_state.pt",
                         weights_only=True) for rid in (trained["run_id"], runner.run_id)]
    diff = {k: max_diff(states[0][k], states[1][k]) for k in ("params", "ema_params")}
    moments = {k: max_diff(states[0]["opt_state"][k], states[1]["opt_state"][k])
               for k in ("mu", "nu")}
    steps = [s["step"] for s in states]
    print(f"  (b) interrupted after epoch {CLI_RESUME_FROM} and resumed (run_id="
          f"{runner.run_id}) in {seconds:.3f} s: largest |difference| from (a)'s last: "
          f"params {diff['params']!r}, EMA {diff['ema_params']!r}, AdamW moments "
          f"{moments}; steps {steps}", flush=True)
    if steps[0] != steps[1] or max(diff.values()) > RESUME_TOL:
        raise AssertionError(f"cli resume: last differs from the uninterrupted run's: {diff}")
    return {"seconds": seconds, "max_abs_diff": diff, "moments_max_abs_diff": moments}


def sample_through_cli(root: Path, quality: dict) -> dict:
    """(c): fdiff-torch-sample on a run directory assembled from the trained
    ref-freq42-e200 weights, fp32, seed 42, one batch of QUALITY_SAMPLES: the
    first QUALITY_SAMPLES chains of phase 16's fp32 draw, so results.yaml's
    gated means must equal phase 16's over its first QUALITY_SAMPLES."""
    run_id = WEIGHTS.parent.name
    run_dir = root / "ref" / run_id
    ref = yamlio.load(WEIGHTS.parent / "run_config.yaml")
    flagship = load_flagship(torch.float32, "cpu")
    save_checkpoint(run_dir / "checkpoints", epoch=int(ref["epochs"]) - 1,
                    step=int(ref["epochs"]) * -(-TRAIN_SERIES // TRAIN_BATCH),
                    val_loss=float(ref["best_val_loss"]),
                    params=dict(flagship.named_parameters()),
                    constants=dict(flagship.named_buffers()))
    save_config(compose("train", cli_train_overrides(root)), run_dir / "train_config.yaml")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_cli(cli_sample.main, [f"model_path={root / 'ref'}", f"model_id={run_id}",
                              f"num_samples={QUALITY_SAMPLES}",
                              f"num_diffusion_steps={SAMPLE_STEPS}",
                              f"sampler.sample_batch_size={QUALITY_BATCH}",
                              f"random_seed={QUALITY_SEED}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    results = yamlio.load(run_dir / "results.yaml")
    samples = np.load(run_dir / "samples.npy")
    phase16 = quality["runs"]["float32"]["results"][QUALITY_SAMPLES]
    expected = {k: 0 for k in counts}
    expected["B1"] = SAMPLE_STEPS * N_LAYERS
    for key in sorted(k for k in results if k.endswith("_mean")):
        print(f"  (c) {key}: results.yaml {results[key]!r}  phase 16 fp32 first "
              f"{QUALITY_SAMPLES} {phase16.get(key, math.nan)!r}", flush=True)
    census = {k: results.get(k) for k in ("divergence_census_count",
                                          "divergence_census_max_absmax",
                                          "divergence_census_protocol")}
    print(f"  (c) fdiff-torch-sample: {QUALITY_SAMPLES} samples x {SAMPLE_STEPS} steps in "
          f"{seconds:.3f} s, launches {counts}, samples.npy {samples.shape}, census "
          f"{json.dumps(census)}", flush=True)
    failures = [f"{k}: {results[k]!r} != {phase16[k]!r}" for k in QUALITY_KEYS
                if results[k] != phase16[k]]
    if counts != expected:
        failures.append(f"launches {counts}, expected {expected}")
    if samples.shape != (QUALITY_SAMPLES, MAX_LEN, N_CHANNELS) or not np.isfinite(samples).all():
        failures.append(f"samples.npy {samples.shape}, or not finite")
    if any(v is None for v in census.values()):
        failures.append(f"census fields missing: {census}")
    if failures:
        raise AssertionError("cli sample: " + "; ".join(failures))
    return {"seconds": seconds, "launches": counts,
            "results": {k: results[k] for k in QUALITY_KEYS}, "census": census}


def check_cli(quality: dict) -> dict:
    """Phase 17: (a) train, (b) resume, (c) sample through the CLIs, in a
    temporary directory; the seconds of each."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        trained = train_through_cli(root)
        resumed = resume_through_cli(root, trained)
        sampled = sample_through_cli(root, quality)
    print(f"  seconds: (a) {trained['seconds']:.3f}, (b) {resumed['seconds']:.3f}, "
          f"(c) {sampled['seconds']:.3f}", flush=True)
    return {"train": trained, "resume": resumed, "sample": sampled}


# Phase 18, the dataset-backed datamodules and the MLP and LSTM score
# networks: raw files in each dataset's real format written from DATA_SEED
# (data/raw_formats.py) into a temporary directory; (a) each datamodule's
# prepare_data/setup on them, pandas never imported; (b) the flagship's
# transformer through fdiff-torch-train on ECG for ECG_EPOCHS epochs and
# fdiff-torch-sample on that run; (c) one fused epoch each on NASDAQ, NASA
# (charge) and US droughts; (d) the reference's trained LSTM runs through
# fdiff-torch-sample, scored over LSTM_SAMPLES samples (far chains decide
# 1000-sample metrics, as QUALITY_DRAWN says); (e) the MLP trained and
# sampled through the CLIs, no kernel launched.
DATA_SEED = 0
ECG_ROWS = (512, 128)  # MIT-BIH train and test rows; the first of each is read as a header
NASDAQ_STOCKS = DROUGHTS_COUNTIES = 72  # besides NASDAQ's late and gappy stocks
NASA_CYCLES = 40  # charge cycles, besides one skipped by each rule
DATASETS = {"ecg": (187, 1), "nasdaq": (252, 5), "nasa": (251, 4), "usdroughts": (365, 13)}
DATASET_SERIES = {"ecg": sum(ECG_ROWS) - 2, "nasdaq": NASDAQ_STOCKS,
                  "nasa": NASA_CYCLES, "usdroughts": DROUGHTS_COUNTIES}
ECG_EPOCHS, ECG_SAMPLES, ECG_STEPS = 2, 256, 250
LSTM_RUNS = ("ref-lstm-freq42-e60", "ref-lstm-time42-e60")
LSTM_SAMPLES = 5000
MLP_EPOCHS, MLP_SAMPLES, MLP_STEPS = 2, 64, 100


def write_raw_data(root: Path) -> None:
    rng = np.random.default_rng(DATA_SEED)
    raw_formats.write_mitbih(root, rng, *ECG_ROWS)
    raw_formats.write_nasdaq(root, rng, NASDAQ_STOCKS)
    raw_formats.write_droughts(root, rng, DROUGHTS_COUNTIES)
    skipped = {"ends_at_the_cutoff.csv": np.arange(0.0, 5000.5, 5.0),
               "gap_above_the_bin.csv": np.concatenate([np.arange(0.0, 2000.0, 5.0),
                                                        np.arange(2010.5, 5100.0, 5.0)])}
    raw_formats.write_nasa(root, rng, NASA_CYCLES, "charge", skipped)


def check_datasets(root: Path) -> dict:
    """(a): the raw files, then each datamodule's prepare_data and setup;
    the shapes, the series kept, finite values, and no pandas."""
    t0 = time.perf_counter()
    write_raw_data(root / "data")
    out = {"write_seconds": time.perf_counter() - t0}
    failures = []
    for name, shape in DATASETS.items():
        t0 = time.perf_counter()
        dm = DATAMODULE_REGISTRY[name](data_dir=root / "data", random_seed=42,
                                       fourier_transform=True, standardize=True)
        dm.prepare_data()
        dm.setup()
        seconds = time.perf_counter() - t0
        sizes = (len(dm.X_train), len(dm.X_test))
        want = DATASET_SERIES[name]
        if (tuple(dm.X_train.shape[1:]), tuple(dm.X_test.shape[1:])) != (shape, shape):
            failures.append(f"{name}: shapes {tuple(dm.X_train.shape)}, {tuple(dm.X_test.shape)}")
        if sum(sizes) != want:
            failures.append(f"{name}: {sizes} series, expected {want} in all")
        if not (torch.isfinite(dm.X_train).all() and torch.isfinite(dm.X_test).all()):
            failures.append(f"{name}: values not finite")
        out[name] = {"seconds": seconds, "train": sizes[0], "test": sizes[1],
                     "shape": list(dm.X_train.shape[1:])}
        print(f"  (a) {name}: setup {seconds:.3f} s, train {tuple(dm.X_train.shape)}, test "
              f"{tuple(dm.X_test.shape)}", flush=True)
    out["pandas_imported"] = "pandas" in sys.modules
    print(f"  (a) raw files written in {out['write_seconds']:.3f} s; pandas in sys.modules: "
          f"{out['pandas_imported']}", flush=True)
    if out["pandas_imported"]:
        failures.append("pandas was imported")
    if failures:
        raise AssertionError("datasets: " + "; ".join(failures))
    return out


def dataset_overrides(root: Path, name: str) -> list[str]:
    return [f"run_dir={root / 'runs'}", f"datamodule={name}",
            f"datamodule.data_dir={root / 'data'}", "fourier_transform=true",
            "standardize=true", "trainer.callbacks.sampling.enabled=false"]


def train_with_cli(overrides: list[str], what: str, expected: dict | None = None) -> dict:
    """fdiff-torch-train with ``overrides``: every epoch's losses finite and,
    for the fused transformer, B3 = B4 = steps x 10 and B2 = epochs x
    validation batches x VAL_DRAWS x 10, nothing else (``expected``: the
    counts when given instead)."""
    cfg = compose("train", overrides)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stdout = run_cli(cli_train.main, overrides)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    run_id = re.search(r"^run_id=(\S+)$", stdout, re.M).group(1)
    run_dir = Path(cfg["run_dir"]) / run_id
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [(r["train/loss"], r["val/loss"]) for r in records if "epoch" in r]
    epochs = int(cfg["trainer"]["max_epochs"])
    if expected is None:
        dm = DATAMODULE_REGISTRY[cfg["datamodule"]["name"]](
            data_dir=cfg["datamodule"]["data_dir"], batch_size=cfg["datamodule"]["batch_size"])
        dm.setup()
        steps = epochs * dm.steps_per_epoch
        val_batches = -(-len(dm.X_test) // dm.batch_size)
        expected = {k: 0 for k in counts}
        expected.update({"B3": steps * N_LAYERS, "B4": steps * N_LAYERS,
                         "B2": epochs * val_batches * VAL_DRAWS * N_LAYERS})
    print(f"  {what}: fdiff-torch-train {epochs} epoch(s) in {seconds:.3f} s, run_id={run_id}, "
          f"launches {counts}, losses {losses}", flush=True)
    failures = []
    if len(losses) != epochs or not all(math.isfinite(v) for pair in losses for v in pair):
        failures.append(f"losses {losses}")
    if counts != expected:
        failures.append(f"launches {counts}, expected {expected}")
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))
    return {"seconds": seconds, "launches": counts, "losses": losses, "run_id": run_id,
            "run_dir": str(run_dir)}


def sample_with_cli(run_dir: Path, samples: int, steps: int, seed: int, what: str,
                    expected: dict, shape: tuple) -> dict:
    """fdiff-torch-sample on ``run_dir`` in one batch: ``samples.npy`` of
    ``(samples, *shape)``, finite, the launches ``expected``."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_cli(cli_sample.main, [f"model_path={run_dir.parent}", f"model_id={run_dir.name}",
                              f"num_samples={samples}", f"num_diffusion_steps={steps}",
                              f"sampler.sample_batch_size={samples}", f"random_seed={seed}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    x = np.load(run_dir / "samples.npy")
    print(f"  {what}: fdiff-torch-sample {samples} samples x {steps} steps in {seconds:.3f} s, "
          f"launches {counts}, samples.npy {x.shape}", flush=True)
    failures = []
    if x.shape != (samples, *shape) or not np.isfinite(x).all():
        failures.append(f"samples.npy {x.shape}, or not finite")
    if counts != expected:
        failures.append(f"launches {counts}, expected {expected}")
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))
    return {"seconds": seconds, "launches": counts,
            "results": yamlio.load(run_dir / "results.yaml")}


def lstm_quality(root: Path) -> dict:
    """(d): each reference LSTM run's weights in a run directory assembled as
    phase 17 (c) does, on the synthetic data of its seed, sampled through
    fdiff-torch-sample at its run_config.yaml's K and seed; the four W2
    means below their _dummy baselines and within QUALITY_REF_FACTOR of its
    results.yaml, no kernel launched (the LSTM runs on cuDNN)."""
    out, failures = {}, []
    for run in LSTM_RUNS:
        ref_dir = REPO / "runs_reference" / run
        ref = yamlio.load(ref_dir / "run_config.yaml")
        overrides = [f"run_dir={root / 'lstm'}", "score_model=lstm", "datamodule=synthetic",
                     f"datamodule.data_dir={root / 'data'}",
                     f"fourier_transform={str(bool(ref['fourier_transform'])).lower()}",
                     f"random_seed={ref['seed']}"]
        model = load_reference_state_dict(
            ScoreModelConfig(model_type="lstm").build(N_CHANNELS, MAX_LEN), ref_dir / "model.pt")
        run_dir = root / "lstm" / run
        # The time-domain run recorded no validation loss (.nan); the value
        # only names the one checkpoint.
        val_loss = float(ref["best_val_loss"])
        save_checkpoint(run_dir / "checkpoints", epoch=int(ref["epochs"]) - 1, step=0,
                        val_loss=val_loss if math.isfinite(val_loss) else 0.0,
                        params=dict(model.named_parameters()),
                        constants=dict(model.named_buffers()))
        save_config(compose("train", overrides), run_dir / "train_config.yaml")
        sampled = sample_with_cli(run_dir, LSTM_SAMPLES, int(ref["num_diffusion_steps"]),
                                  int(ref["seed"]), f"(d) {run}",
                                  {k: 0 for k in read_counts()}, (MAX_LEN, N_CHANNELS))
        reference = read_scalars(ref_dir / "results.yaml")
        results = sampled.pop("results")
        rows = {}
        for key in QUALITY_KEYS:
            got, dummy = float(results[key]), float(results[f"{key}_dummy"])
            rows[key] = {"port": got, "dummy": dummy, "results_yaml": reference[key],
                         "ratio": got / reference[key]}
            print(f"  (d) {run} {key}: {got:.6f} (dummy {dummy:.6f}); results.yaml "
                  f"{reference[key]:.6f}, ratio {got / reference[key]:.4f}", flush=True)
            if not got < dummy:
                failures.append(f"{run} {key} {got} not below its dummy {dummy}")
            if not got <= QUALITY_REF_FACTOR * reference[key]:
                failures.append(f"{run} {key} {got} above {QUALITY_REF_FACTOR} x the "
                                f"reference's {reference[key]}")
        out[run] = {**sampled, "w2": rows,
                    "census": {k: results.get(k) for k in ("divergence_census_count",
                                                          "divergence_census_max_absmax")}}
    if failures:
        raise AssertionError("lstm quality: " + "; ".join(failures))
    return out


def check_datasets_and_networks() -> dict:
    """Phase 18: (a)-(e) in a temporary directory; the seconds of each."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = check_datasets(root)
        seconds = {"a": time.perf_counter() - t0}

        t0 = time.perf_counter()
        ecg = train_with_cli(dataset_overrides(root, "ecg") + [f"trainer.max_epochs={ECG_EPOCHS}"],
                             "(b) ecg")
        ecg_sample = sample_with_cli(
            Path(ecg["run_dir"]), ECG_SAMPLES, ECG_STEPS, QUALITY_SEED, "(b) ecg",
            {**{k: 0 for k in read_counts()}, "B1": ECG_STEPS * N_LAYERS}, DATASETS["ecg"])
        ecg_sample.pop("results")
        seconds["b"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fused = {name: train_with_cli(dataset_overrides(root, name) + ["trainer.max_epochs=1"],
                                      f"(c) {name}")
                 for name in ("nasdaq", "nasa", "usdroughts")}
        seconds["c"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        lstm = lstm_quality(root)
        seconds["d"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        none = {k: 0 for k in read_counts()}
        mlp = train_with_cli(
            [f"run_dir={root / 'runs'}", "score_model=mlp", "datamodule=synthetic",
             f"datamodule.data_dir={root / 'data'}", "fourier_transform=true",
             "trainer.callbacks.sampling.enabled=false", f"trainer.max_epochs={MLP_EPOCHS}"],
            "(e) mlp", expected=none)
        mlp_sample = sample_with_cli(Path(mlp["run_dir"]), MLP_SAMPLES, MLP_STEPS, QUALITY_SEED,
                                     "(e) mlp", none, (MAX_LEN, N_CHANNELS))
        mlp_sample.pop("results")
        seconds["e"] = time.perf_counter() - t0
    print("  seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in seconds.items()), flush=True)
    return {"seconds": seconds, "data": data, "ecg_train": ecg, "ecg_sample": ecg_sample,
            "fused_epoch": fused, "lstm": lstm, "mlp_train": mlp, "mlp_sample": mlp_sample}


def trained_state(trainer: Trainer) -> dict:
    return {**{f"params/{n}": p.detach() for n, p in zip(trainer.names, trainer.params)},
            **{f"ema/{n}": e for n, e in trainer.ema.items()}}


def replicas_checked(trainer: Trainer, epoch: int, params, constants, metrics) -> None:
    """Epoch callback: every rank's weights and EMA bit for bit rank 0's."""
    distributed.assert_replicated_equal(trained_state(trainer), f"epoch {epoch}")


def dp_training(mesh, dm: SyntheticDatamodule) -> dict:
    """Part (b) on this rank: phase 7's first 3 kernel steps on this rank's
    rows, their layer seeds drawn anew from ``draw_steps``' stream through
    ``Trainer.draw_layer_seeds`` (the draw and shift ``fit`` makes), then
    phase 8's fit."""
    rows = mesh.rows(TRAIN_BATCH)
    trainer = flagship_trainer(mesh=mesh)
    trainer.start(dm.steps_per_epoch * TRAIN_EPOCHS)
    layer_seeds = torch.Generator().manual_seed(STEP_SEED)
    steps = []
    for x, t, z, _ in draw_steps(dm, CHECK_STEPS):
        x, t, z = x[rows], t[rows], z[rows]
        steps.append((x, t, z, trainer.draw_layer_seeds(layer_seeds, len(x))))
    gates = {}
    with kernel_gates(gates):
        grads = distributed.all_reduce_mean(trainer.loss_and_grads(*steps[0])[1])
    losses = [distributed.all_reduce_mean([trainer.train_step(*step).reshape(1)])[0].item()
              for step in steps]
    trainer = flagship_trainer(mesh=mesh)
    trainer.callbacks = (replicas_checked,)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.fit(dm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"grads0": [g.cpu() for g in grads], "gates0": [gates[s].cpu() for s in steps[0][3]],
            "losses3": losses, "seconds": seconds,
            "launches": read_counts(), "losses": [(h["train/loss"], h["val/loss"]) for h in history],
            "state": {k: v.cpu() for k, v in trained_state(trainer).items()}}


def dp_sampling(mesh) -> dict:
    """Part (c) on this rank: phase 4's fp32 run with its chains split over
    the ranks, from phase 4's generator (its 2-step warm-up first), and a
    20-step run from seed 7."""
    sampler = DiffusionSampler(
        load_flagship(torch.float32, "cuda"), VPScheduler(fourier_noise_scaling=True),
        max_len=MAX_LEN, n_channels=N_CHANNELS, sample_batch_size=SAMPLE_CHAINS, method="em",
        mesh=mesh,
    )
    g = torch.Generator(device="cuda").manual_seed(42)
    sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=2, generator=g)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=SAMPLE_STEPS, generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    short = sampler.sample(SAMPLE_CHAINS, num_diffusion_steps=TRAJ_STEPS,
                           generator=torch.Generator(device="cuda").manual_seed(7))
    return {"samples": out.cpu(), "short": short.cpu(), "seconds": seconds,
            "launches": launches}


def rank_main(root: str, backend: str) -> int:
    """One rank of phase 19 (b) and (c), or of (e) with NCCL: started by
    ``run_ranks`` as ``chip_smoke.py --rank <dir> <backend>``; writes its
    results to ``<dir>/rank<r>-<backend>.pt``."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo: every rank on the one card; NCCL: rank r on cuda:r.
    distributed.maybe_initialize_distributed(
        device="cuda:0" if backend == "gloo" else None, backend=backend)
    mesh = make_mesh()
    dm = synthetic_data(str(Path(root) / "data"))
    result = {"b": dp_training(mesh, dm)}
    if backend == "gloo":
        result["c"] = dp_sampling(mesh)
    torch.save(result, Path(root) / f"rank{mesh.rank}-{backend}.pt")
    print(f"rank {mesh.rank} of {mesh.world_size} ({backend}) done", flush=True)
    distributed.shutdown()
    return 0


def spawn_ranks(root: Path, backend: str) -> list[dict]:
    run_ranks([sys.executable, str(REPO / "chip_smoke.py"), "--rank", str(root), backend],
              DP_RANKS, timeout=DP_TIMEOUT)
    return [torch.load(root / f"rank{r}-{backend}.pt") for r in range(DP_RANKS)]


def nccl_world_one(dm: SyntheticDatamodule) -> dict:
    """Part (a): NCCL at world size 1 in this process, one epoch of phase
    8's configuration with and without the mesh, bit for bit."""
    with environ("FDIFF_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}"), \
            environ("FDIFF_NUM_PROCESSES", "1"), environ("FDIFF_PROCESS_ID", "0"):
        distributed.maybe_initialize_distributed()
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            raise AssertionError(f"(a): backend {backend}, not nccl")
        runs = {}
        for name, mesh in (("mesh", make_mesh()), ("no mesh", None)):
            trainer = flagship_trainer(epochs=1, mesh=mesh)
            reset_counts()
            history = trainer.fit(dm)
            runs[name] = ([(h["train/loss"], h["val/loss"]) for h in history],
                          trained_state(trainer), read_counts())
    finally:
        distributed.shutdown()
    (losses, state, counts), (ref_losses, ref_state, ref_counts) = runs["mesh"], runs["no mesh"]
    differ = [k for k in ref_state if not torch.equal(state[k], ref_state[k])]
    print(f"  (a) NCCL, world size 1: losses {losses} (no mesh {ref_losses}); tensors that "
          f"differ: {differ}; launches {counts}", flush=True)
    if differ or losses != ref_losses or counts != ref_counts:
        raise AssertionError(f"(a): the mesh path at world size 1 is not the one-process run: "
                             f"{differ}, {losses} vs {ref_losses}, {counts} vs {ref_counts}")
    return {"backend": backend, "losses": losses, "launches": counts}


def check_training_ranks(ranks: list[dict], dm: SyntheticDatamodule, training: dict,
                         what: str) -> dict:
    """Parts (b) and (e) against phase 7's first steps and phase 8's fit.

    The first step's gradients are held to GRAD_TOL as phase 7 holds the
    kernel's: against the one-process kernel step or, where an FFN ReLU gate
    opened in one run and stayed shut in the other (B3 sums a row's products
    in another order over 32 chains than over 64), against the plain path
    with the ranks' gates; each such flip is located and must lie within
    GATE_BAND x sum |terms| of 0."""
    n_steps = dm.steps_per_epoch * TRAIN_EPOCHS
    reference = flagship_trainer()
    reference.start(n_steps)
    steps = draw_steps(dm, CHECK_STEPS)
    ref_gates, record = {}, {}
    with kernel_gates(ref_gates):
        ref_grads = reference.loss_and_grads(*steps[0])[1]
    ref_losses = [reference.train_step(*step).item() for step in steps]
    b = [r["b"] for r in ranks]
    differ = [k for k in b[0]["state"] if not torch.equal(b[0]["state"][k], b[1]["state"][k])]
    seeds = steps[0][3]
    gates = {s: torch.cat([r["gates0"][i] for r in b]).cuda() for i, s in enumerate(seeds)}
    flips = {s: gates[s] != ref_gates[s] for s in seeds}
    located = int(sum(int(f.sum()) for f in flips.values()))
    matched_grads = ref_grads
    if located:
        matched = flagship_trainer(plain=True)
        matched.start(n_steps)
        with plain_gates(record, gates):
            matched_grads = matched.loss_and_grads(*steps[0])[1]
        far = sum(int(((pre.abs() > GATE_BAND * terms) & flips[s]).sum())
                  for s, (pre, terms, _, _) in record.items())
        if far:
            raise AssertionError(f"{what}: {far} ReLU gates flipped away from 0")
    del gates, flips, record
    rel = {name: (rel_err(g.cuda(), r), rel_err(g.cuda(), m)) for name, g, r, m in
           zip(reference.names, b[0]["grads0"], ref_grads, matched_grads)}
    bad = {k: v for k, v in rel.items() if not (v[0] <= GRAD_TOL or (located and v[1] <= GRAD_TOL))}
    grad_err = max(v[0] for v in rel.values())
    worst = max(rel, key=lambda k: rel[k][0])
    loss_err = max(abs(a - r) / abs(r) for a, r in zip(b[0]["losses3"], ref_losses))
    epoch_err = max(abs(a - r) / abs(r) for got, want in zip(b[0]["losses"], training["losses"])
                    for a, r in zip(got, want))
    expected = {"B3": n_steps * N_LAYERS, "B4": n_steps * N_LAYERS,
                "B2": TRAIN_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH) * VAL_DRAWS * N_LAYERS}
    print(f"  {what}: first-step gradients against phase 7's kernel step {grad_err:.3e} "
          f"({worst}; against the plain path with the ranks' gates {rel[worst][1]:.3e}; "
          f"tol {GRAD_TOL:.0e}; ReLU gates flipped between the runs: {located}); 3 losses {b[0]['losses3']} against {ref_losses}: {loss_err:.3e} "
          f"(tol {LOSS_TOL:.0e}); 2 epochs {b[0]['losses']} against phase 8's "
          f"{training['losses']}: {epoch_err:.3e} (tol {DP_EPOCH_LOSS_TOL:.0e}); replicas "
          f"differ in {differ}; fit {[round(r['seconds'], 3) for r in b]} s; launches "
          + "; ".join(f"rank {i} {r['launches']}" for i, r in enumerate(b)), flush=True)
    if differ or any(r["losses"] != b[0]["losses"] for r in b):
        raise AssertionError(f"{what}: the ranks disagree: {differ}")
    if bad or not (loss_err <= LOSS_TOL and epoch_err <= DP_EPOCH_LOSS_TOL):
        raise AssertionError(f"{what}: gradients {bad}, losses {loss_err}, {epoch_err}")
    for i, r in enumerate(b):
        wrong = {k: (r["launches"][k], n) for k, n in expected.items() if r["launches"][k] != n}
        if wrong or r["launches"]["B1"]:
            raise AssertionError(f"{what}: rank {i} launches {r['launches']}")
    return {"grad_rel_err": grad_err, "grad_rel_err_gate_matched": max(v[1] for v in rel.values()),
            "gate_flips": located, "loss_rel_err": loss_err, "epoch_loss_rel_err": epoch_err,
            "losses": b[0]["losses"], "fit_seconds": [r["seconds"] for r in b],
            "launches": [r["launches"] for r in b]}


def check_sampling_ranks(ranks: list[dict], main_samples: torch.Tensor) -> dict:
    """Part (c) against phase 4's samples and a one-process 20-step run."""
    c = [r["c"] for r in ranks]
    one = DiffusionSampler(
        load_flagship(torch.float32, "cuda"), VPScheduler(fourier_noise_scaling=True),
        max_len=MAX_LEN, n_channels=N_CHANNELS, sample_batch_size=SAMPLE_CHAINS, method="em",
    ).sample(SAMPLE_CHAINS, num_diffusion_steps=TRAJ_STEPS,
             generator=torch.Generator(device="cuda").manual_seed(7)).cpu()
    samples = c[0]["samples"]
    bitwise = torch.equal(samples, main_samples.cpu())
    # Chains 0-15 of one fp32 score evaluation and of one B1 call at 32
    # chains against the same chains evaluated alone: equal, as the samples.
    model = load_flagship(torch.float32, "cuda")
    packed = pack_score_transformer(model)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((SAMPLE_CHAINS, MAX_LEN, N_CHANNELS), generator=g, device="cuda")
    t = torch.rand(SAMPLE_CHAINS, generator=g, device="cuda")
    h = torch.randn((SAMPLE_CHAINS, MAX_LEN, 72), generator=g, device="cuda")
    half = SAMPLE_CHAINS // 2
    layer = packed["layers"][0]
    by_batch = {
        "score": (fused_score_forward(model, packed, x, t)[:half]
                  - fused_score_forward(model, packed, x[:half], t[:half])).abs().max().item(),
        "B1 layer": (fe.fused_encoder_layer(h, layer, n_head=N_HEAD)[:half]
                     - fe.fused_encoder_layer(h[:half].contiguous(), layer, n_head=N_HEAD)
                     ).abs().max().item(),
    }
    diff = (samples - main_samples.cpu()).abs().max().item()
    traj = (c[0]["short"] - one).abs().max().item()
    holds = ("bit for bit" if bitwise else f"not bit for bit (max |difference| {diff:.3e})")
    print(f"  (c) 32 chains as 16 + 16, K={SAMPLE_STEPS}, against phase 4's: {holds}; chains "
          f"0-15 at 32 chains against alone, max |difference|: {json.dumps(by_batch)}; 20 steps "
          f"against one process {traj:.3e} (tol {TRAJ_TOL:.0e}); seconds "
          f"{[round(r['seconds'], 3) for r in c]}; launches "
          + "; ".join(f"rank {i} {r['launches']}" for i, r in enumerate(c)), flush=True)
    if not all(torch.equal(r["samples"], samples) and torch.equal(r["short"], c[0]["short"])
               for r in c):
        raise AssertionError("(c): the ranks gathered different samples")
    if not bitwise or any(by_batch.values()):
        raise AssertionError(f"(c): 16 + 16 chains are not phase 4's 32 bit for bit: samples "
                             f"{diff}, chains 0-15 at 32 against alone {by_batch}")
    if tuple(samples.shape) != (SAMPLE_CHAINS, MAX_LEN, N_CHANNELS) or not bool(
            torch.isfinite(samples).all()):
        raise AssertionError(f"(c): samples {tuple(samples.shape)}, finite "
                             f"{bool(torch.isfinite(samples).all())}")
    if not traj <= TRAJ_TOL:
        raise AssertionError(f"(c): the 20-step runs part by {traj}")
    for i, r in enumerate(c):
        if r["launches"]["B1"] != SAMPLE_STEPS * N_LAYERS:
            raise AssertionError(f"(c): rank {i} launches {r['launches']}")
    return {"bit_for_bit": bitwise, "max_abs_diff": diff, "traj_20_max_abs_diff": traj,
            "half_batch_vs_whole": by_batch,
            "seconds": [r["seconds"] for r in c], "launches": [r["launches"] for r in c]}


def check_data_parallel(main_samples: torch.Tensor, training: dict) -> dict:
    """Phase 19 (a)-(e)."""
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        dm = synthetic_data(str(root / "data"))
        t0 = time.perf_counter()
        out["a"] = nccl_world_one(dm)
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks(root, "gloo")
        seconds["b+c spawn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = check_training_ranks(ranks, dm, training, "(b) 2 ranks over gloo")
        out["c"] = check_sampling_ranks(ranks, main_samples)
        seconds["b+c checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dryrun = dryrun_multichip(DP_RANKS, device="cuda:0", backend="gloo", timeout=DP_TIMEOUT)
        seconds["d"] = time.perf_counter() - t0
        print("  (d) " + " | ".join(o.strip().splitlines()[-1] for o in dryrun), flush=True)
        if torch.cuda.device_count() >= DP_RANKS:
            t0 = time.perf_counter()
            out["e"] = check_training_ranks(spawn_ranks(root, "nccl"), dm, training,
                                            "(e) NCCL across cards")
            seconds["e"] = time.perf_counter() - t0
        else:
            print(f"  (e) NCCL across cards: not run, {torch.cuda.device_count()} CUDA device",
                  flush=True)
    print(f"  seconds: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}", flush=True)
    return {**out, "seconds": seconds}


# ---- C1: a chain's result does not depend on the batch it is in ----------------------

# B1 at B=32, L=100 before the tail folded a row's d_ff chunks in chunk
# order (ROADMAP C1), as this script measured it on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6). Printed beside this run's times, never
# compared with them in a gate.
B1_BEFORE_C1_MS = {torch.float32: 0.1728, torch.bfloat16: 0.1084}


def check_batch_independence(layer) -> dict:
    """Phase 3's C1 check, bit for bit, fp32 and bf16: chains 0-15 of one B1
    call at 32 chains against the same chains called alone (the trained
    layer ``layer``); chains 0-31 of one B3 call at 64 chains against a call
    at 32, and the FFN ReLU gates B4's recompute takes there. Both tails
    group a row's FFN sums by the d_ff chunk alone (csrc/encoder_layer_tc.cuh),
    so nothing may differ."""
    g = torch.Generator(device="cuda").manual_seed(13)
    h = torch.randn((SAMPLE_CHAINS, MAX_LEN, 72), generator=g, device="cuda")
    x = torch.randn((TRAIN_BATCH, MAX_LEN, 72), generator=g, device="cuda")
    dy = torch.randn((TRAIN_BATCH, MAX_LEN, 72), generator=g, device="cuda")
    half, n = SAMPLE_CHAINS // 2, TRAIN_BATCH // 2
    out, failures = {}, []
    for dtype in TOL:
        name = str(dtype).removeprefix("torch.")
        packed = fe.pack_encoder_layer(layer, N_HEAD, dtype)
        hd = h.to(dtype)
        with torch.no_grad():
            whole = fe.fused_encoder_layer(hd, packed, n_head=N_HEAD)[:half]
            alone = fe.fused_encoder_layer(hd[:half].contiguous(), packed, n_head=N_HEAD)
        lay = {k: t.detach() for k, t in
               fet.pack_encoder_layer_train(layer, N_HEAD, dtype).items()}
        xd, dyd = x.to(dtype), dy.to(dtype)
        y64 = fet._launch_fwd(xd, lay, 5, N_HEAD, DROPOUT)[:n]
        y32 = fet._launch_fwd(xd[:n].contiguous(), lay, 5, N_HEAD, DROPOUT)
        g64 = fet._launch_bwd(xd, dyd, lay, 5, N_HEAD, DROPOUT, stages=True)[2]["gates"][:n]
        g32 = fet._launch_bwd(xd[:n].contiguous(), dyd[:n].contiguous(), lay, 5, N_HEAD,
                              DROPOUT, stages=True)[2]["gates"]
        torch.cuda.synchronize()
        r = {"B1 chains 0-15 at 32 and 16 equal": torch.equal(whole, alone),
             "B1 max |diff|": (whole.float() - alone.float()).abs().max().item(),
             "B3 chains 0-31 at 64 and 32 equal": torch.equal(y64, y32),
             "B3 max |diff|": (y64.float() - y32.float()).abs().max().item(),
             "B4 ReLU gates flipped between 64 and 32": int((g64 != g32).sum())}
        out[name] = r
        print(f"  C1 {name}: {json.dumps(r)}", flush=True)
        if not (r["B1 chains 0-15 at 32 and 16 equal"] and r["B3 chains 0-31 at 64 and 32 equal"]
                and r["B4 ReLU gates flipped between 64 and 32"] == 0):
            failures.append(name)
    if failures:
        raise AssertionError(f"C1: a chain's result depends on its batch: {failures}, {out}")
    return out


# ---- phase 20: bf16 training on the fused path ---------------------------------------------

BF16 = torch.bfloat16
# (a) B3 and B4 in bf16 against their plain bf16 versions (whose backward,
# train_backward_staged, rounds where the TPU kernel rounds). The outputs y
# to TOL[bf16]: both round at the same points, and a rounding that flips
# between their fp32 sum orders moves an element by one bf16 ulp. dx, B4's
# stages and the 12 gradients, max |diff| / max |ref| per tensor, against
# the staged plain backward with the kernel's FFN ReLU gates (located), to
# BF16_GRAD_TOL: both round the same operands to bf16 (qkv, O, x1, h, dF2,
# dh, dao, dO, P keep, dS, dqkv), but a value the two compute in other fp32
# orders now and then lies within an fp32 ulp of a bf16 rounding boundary
# and then rounds one bf16 ulp (2**-8 of itself) apart. A few such flips,
# of both signs, in sums of thousands of terms stay well below 2**-5 of a
# tensor's largest value; a wrong product, mask or rounding point misses by
# far more (a lost d_ff chunk moves dW2 by its whole share).
BF16_GRAD_TOL = 2.0**-5
# A ReLU gate may flip where its fp64 input lies within BF16_GATE_BAND x sum
# |terms| of 0: x1 enters the W1 product rounded to bf16, and one of its
# elements that rounds the other way moves a term by 2**-8 of itself.
BF16_GATE_BAND = 2.0**-7
# (b) 3 training steps of the bf16 flagship through the kernels and through
# the plain versions (check_training). Through 10 layers each layer's input differs between
# the two by the bf16 flips of the layers before, so a flipped gate's input
# may lie further from 0 (BF16_STEP_GATE_BAND, 4x the one-layer band) and
# the step-0 gradients, against the plain path with the kernels' gates,
# differ by the flips of all layers: BF16_STEP_GRAD_TOL, 2x the one-layer
# limit. The losses, means of 6400 squared terms: BF16_LOSS_TOL.
BF16_STEP_GATE_BAND = 2.0**-5
BF16_STEP_GRAD_TOL = 2.0**-4
BF16_LOSS_TOL = 1e-2
# (c) runs/94c6eb87/train_config.yaml (the flagship trained 600 epochs in
# bf16) cut to BF16_EPOCHS epochs through fdiff-torch-train, and the same
# configuration in fp32 in the same call; BF16_SAMPLES samples at
# BF16_SAMPLE_STEPS reverse steps from the checkpoint it writes. The card's
# copy of the repository holds no runs/, so the overrides carry that
# configuration (tests/test_torch_bf16_training.py holds them to the file
# on every leaf but the directories and the epochs).
BF16_RUN = "runs/94c6eb87/train_config.yaml"
BF16_EPOCHS, BF16_SAMPLES, BF16_SAMPLE_STEPS = 3, 64, 100


def bf16_bounds(b: int, l: int, d: int, d_ff: int, lay: dict) -> tuple:
    """Least time of one bf16 B3 and one B4 call, as ``check_train_layer``
    counts fp32's: its operations over the bf16 tensor-core peak, or its
    bytes (bf16 activations and weight matrices, fp32 vectors and weight
    gradients) over the memory rate."""
    flops = train_layer_flops(b, l, d, d_ff)
    weights = sum(t.numel() * t.element_size() for t in lay.values())
    act = b * l * d * 2
    grads = sum(t.numel() for t in lay.values()) * 4
    return (bound(flops, 2 * act + weights, BF16),
            bound(3 * flops, 3 * act + weights + grads, BF16))


def bf16_train_layer(layer, n_head: int, batch: int, l: int, timed: bool) -> dict:
    """Phase 20 (a): B3 and B4 in bf16 on one encoder layer (dropout 0.1) at
    (batch, l) against their plain bf16 versions; ReLU gates that flipped
    between the two located, each within BF16_GATE_BAND x sum |terms| of 0;
    with ``timed``, a second call of each bit for bit the first, B4's ms per
    stage (CUDA events), the times of both kernels, the plain versions, the
    bound and a train-mode ``nn.TransformerEncoderLayer`` in bf16."""
    d, d_ff = layer.norm1.weight.shape[0], layer.linear1.weight.shape[0]
    shape = f"bf16 B={batch} L={l} D={d} H={n_head} F={d_ff}"
    lay = {k: t.detach() for k, t in fet.pack_encoder_layer_train(layer, n_head, BF16).items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((batch, l, d), generator=g, device="cuda").to(BF16)
    dy = torch.randn((batch, l, d), generator=g, device="cuda").to(BF16)
    seed = 123456789
    out = fet._launch_fwd(x, lay, seed, n_head, DROPOUT)
    ref = fet.fused_encoder_layer_train_reference(x, lay, seed, n_head=n_head, rate=DROPOUT)
    dx, grads, ws = fet._launch_bwd(x, dy, lay, seed, n_head, DROPOUT, stages=True)
    _, _, plain = fet.train_backward_staged(x, dy, lay, seed, n_head=n_head, rate=DROPOUT)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (out.dtype == BF16 and torch.isfinite(out.float()).all() and err <= TOL[BF16]):
        raise AssertionError(f"B3 {shape}: kernel disagrees with plain version: {err}")
    masks = fet.dropout_masks(batch, l, d, d_ff, n_head, seed, DROPOUT, "cuda")
    kept = masks["ff"] > 0
    flips = (ws["gates"] != plain["gates"]) & kept
    located = []
    if int(flips.sum()):
        x1t = fet.attention_sublayer(x, lay, masks, n_head).to(BF16).double()
        w1, b1 = lay["w1"].double(), lay["b1"].double()
        pre, terms = x1t @ w1 + b1, x1t.abs() @ w1.abs() + b1.abs()
        for b, r, u in flips.nonzero().tolist():
            located.append({"chain": b, "row": r, "unit": u, "pre_fp64": pre[b, r, u].item(),
                            "terms": terms[b, r, u].item(),
                            "kernel_open": bool(ws["gates"][b, r, u])})
        far = [f for f in located if abs(f["pre_fp64"]) > BF16_GATE_BAND * f["terms"]]
        if far:
            raise AssertionError(f"B4 {shape}: ReLU gates flipped away from 0: {far}")
    gates = ws["gates"] | (~kept & plain["gates"])
    ref_dx, ref_grads, ref_st = fet.train_backward_staged(x, dy, lay, seed, n_head=n_head,
                                                          rate=DROPOUT, gates=gates)
    rel = {k: rel_err(ws[k], ref_st[k]) for k in ("df2", "dx1", "da", "dqkv")}
    rel.update({k: rel_err(gk, gr) for k, gk, gr in
                zip(["dx", *fet.LAYER_KEYS], [dx, *grads], [ref_dx, *ref_grads])})
    band = max((abs(f["pre_fp64"]) / f["terms"] for f in located), default=0.0)
    print(f"  B3/B4 {shape}: max |fwd - plain| {err:.3e} (tol {TOL[BF16]:.3e}); ReLU gates "
          f"flipped: {len(located)}, the farthest {band:.3e} x sum |terms| from 0 (band "
          f"{BF16_GATE_BAND:.3e}), the first {json.dumps(located[:3])}; B4 against the staged "
          f"plain "
          f"backward with the kernel's gates, max |diff| / max (tol {BF16_GRAD_TOL:.3e}): "
          f"{json.dumps(rel)}", flush=True)
    bad = {k: v for k, v in rel.items() if not v <= BF16_GRAD_TOL}
    if bad or dx.dtype != BF16:
        raise AssertionError(f"B4 {shape}: disagrees with the staged plain backward: {bad}")
    r = {"fwd": {"max_abs_err": err},
         "bwd": {"max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in
                                    zip([dx, *grads], [ref_dx, *ref_grads])),
                 "max_rel_err": max(rel.values()), "gate_flips": len(located),
                 "gate_flip_farthest": band}}
    if not timed:
        return r
    again = fet._launch_bwd(x, dy, lay, seed, n_head, DROPOUT)
    identical = {"B3": torch.equal(fet._launch_fwd(x, lay, seed, n_head, DROPOUT), out),
                 "B4": all(torch.equal(a, b) for a, b in zip([dx, *grads],
                                                             [again[0], *again[1]]))}
    print(f"  B3/B4 {shape}: two calls on the same inputs bit-identical: {identical}",
          flush=True)
    if not all(identical.values()):
        raise AssertionError(f"B3/B4 {shape}: a repeated call gave other results: {identical}")
    r["bwd"]["stage_ms"] = bwd_stage_ms(x, dy, lay, seed, n_head)
    r["bwd"]["attention_form"] = bwd_form(batch, n_head, l, d // n_head, BF16)
    r["fwd"]["attention_form"] = fwd_form(l, d // n_head, BF16)
    print(f"  B4 {shape}: per stage {json.dumps(r['bwd']['stage_ms'])}; the attention "
          f"stage's launch 1 {json.dumps(r['bwd']['attention_form'])}; B3's (and B4's "
          f"forward stage's) attention {r['fwd']['attention_form']}", flush=True)
    r["fwd"]["ms"] = time_ms(lambda: fet._launch_fwd(x, lay, seed, n_head, DROPOUT), iters=20)
    r["bwd"]["ms"] = time_ms(lambda: fet._launch_bwd(x, dy, lay, seed, n_head, DROPOUT),
                             iters=10)
    r["fwd"]["plain_ms"] = time_ms(lambda: fet.fused_encoder_layer_train_reference(
        x, lay, seed, n_head=n_head, rate=DROPOUT), iters=10)
    r["bwd"]["plain_ms"] = time_ms(lambda: fet.train_backward_staged(
        x, dy, lay, seed, n_head=n_head, rate=DROPOUT), iters=3, warmup=1)
    lib = torch.nn.TransformerEncoderLayer(
        d, n_head, d_ff, DROPOUT, batch_first=True).to("cuda", BF16).train()
    xl = x.detach().requires_grad_(True)
    lib_out = lib(xl)
    lib_params = [xl, *lib.parameters()]
    r["fwd"]["library_ms"] = time_ms(lambda: lib(xl), iters=10)
    r["bwd"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, lib_params, dy, retain_graph=True), iters=10)
    (f_ms, f_by), (b_ms, b_by) = bf16_bounds(batch, l, d, d_ff, lay)
    r["fwd"].update(bound_ms=f_ms, bound_by=f_by)
    r["bwd"].update(bound_ms=b_ms, bound_by=b_by)
    print(f"  B3/B4 {shape} times: {json.dumps(r)}", flush=True)
    return r


def bf16_cli_overrides(root: Path, dtype: str) -> list[str]:
    """fdiff-torch-train's overrides for phase 20 (c): BF16_RUN's
    configuration in ``dtype``, cut to BF16_EPOCHS epochs."""
    return [f"run_dir={root / 'runs'}", "datamodule=synthetic",
            f"datamodule.data_dir={root / 'data'}", "fourier_transform=true",
            "trainer.ema_decay=0.999", f"score_model.dtype={dtype}",
            f"trainer.max_epochs={BF16_EPOCHS}", "trainer.callbacks.sampling.enabled=false"]


def check_bf16_cli(root: Path) -> dict:
    """Phase 20 (c): BF16_RUN's configuration through fdiff-torch-train, in
    bf16 and then in fp32: every loss finite, B3 = B4 = steps x 10, B2 =
    epochs x validation batches x VAL_DRAWS x 10 (in bf16 all of them B2's
    fast bf16 form, none fp32; in fp32 none of them), the checkpoint's
    parameters fp32; each epoch's steps/s; then fdiff-torch-sample on the
    bf16 run: B1 = BF16_SAMPLE_STEPS x 10 launches, finite samples."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        overrides = bf16_cli_overrides(root, dtype)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        stdout = run_cli(cli_train.main, overrides)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**read_counts(), "B2 fast bf16": fa.fast_launches}
        run_id = re.search(r"^run_id=(\S+)$", stdout, re.M).group(1)
        run_dir = root / "runs" / run_id
        records = [json.loads(s) for s in (run_dir / "metrics.jsonl").read_text().splitlines()]
        epochs = [r for r in records if "epoch" in r]
        steps = BF16_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH)
        b2 = BF16_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH) * VAL_DRAWS * N_LAYERS
        expected = {k: 0 for k in counts}
        expected.update({"B3": steps * N_LAYERS, "B4": steps * N_LAYERS, "B2": b2,
                         "B2 fast bf16": b2 if dtype == "bfloat16" else 0})
        best = get_best_checkpoint(run_dir / "checkpoints")
        params = load_checkpoint(best)
        runs[dtype] = {"seconds": seconds, "launches": counts, "run_id": run_id,
                       "losses": [(r["train/loss"], r["val/loss"]) for r in epochs],
                       "steps_per_sec": [r["steps_per_sec"] for r in epochs],
                       "checkpoint_dtypes": sorted({str(t.dtype) for t in params.values()})}
        print(f"  (c) fdiff-torch-train score_model.dtype={dtype}: {BF16_EPOCHS} epochs, "
              f"{steps} steps in {seconds:.3f} s; {json.dumps(runs[dtype])}", flush=True)
        failures = []
        if len(epochs) != BF16_EPOCHS or not all(
                math.isfinite(v) for pair in runs[dtype]["losses"] for v in pair):
            failures.append(f"losses {runs[dtype]['losses']}")
        if counts != expected:
            failures.append(f"launches {counts}, expected {expected}")
        if runs[dtype]["checkpoint_dtypes"] != ["torch.float32"]:
            failures.append(f"checkpoint dtypes {runs[dtype]['checkpoint_dtypes']}")
        if failures:
            raise AssertionError(f"(c) {dtype}: " + "; ".join(failures))
    print(f"  (c) steps/s per epoch (validation included, as the trainer counts them): bf16 "
          f"{runs['bfloat16']['steps_per_sec']}, fp32 {runs['float32']['steps_per_sec']}",
          flush=True)
    run_dir = root / "runs" / runs["bfloat16"]["run_id"]
    reset_counts()
    t0 = time.perf_counter()
    run_cli(cli_sample.main, [f"model_path={root / 'runs'}",
                              f"model_id={runs['bfloat16']['run_id']}",
                              f"num_samples={BF16_SAMPLES}",
                              f"num_diffusion_steps={BF16_SAMPLE_STEPS}",
                              f"sampler.sample_batch_size={BF16_SAMPLES}",
                              f"random_seed={QUALITY_SEED}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    samples = np.load(run_dir / "samples.npy")
    expected = {k: 0 for k in counts}
    expected["B1"] = BF16_SAMPLE_STEPS * N_LAYERS
    print(f"  (c) fdiff-torch-sample of the bf16 run: {BF16_SAMPLES} samples x "
          f"{BF16_SAMPLE_STEPS} steps in {seconds:.3f} s, launches {counts}, samples.npy "
          f"{samples.shape}", flush=True)
    if counts != expected or samples.shape != (BF16_SAMPLES, MAX_LEN, N_CHANNELS) or not (
            np.isfinite(samples).all()):
        raise AssertionError(f"(c) sample: launches {counts}, samples {samples.shape}")
    return {**runs, "sample": {"seconds": seconds, "launches": counts}}


def check_bf16(flagship: ScoreTransformer) -> dict:
    """Phase 20 (a)-(c) in a temporary directory; the seconds of each."""
    seconds, layers = {}, {}
    t0 = time.perf_counter()
    layers[f"L={MAX_LEN} D=72 B={TRAIN_BATCH}"] = bf16_train_layer(
        flagship.backbone.layers[0], N_HEAD, TRAIN_BATCH, MAX_LEN, timed=True)
    for l, d, n_head, d_ff in COVERAGE:
        torch.manual_seed(0)
        layer = TransformerEncoderLayer(d, n_head, d_ff).to("cuda")
        layers[f"L={l} D={d} H={n_head} F={d_ff} B={COVERAGE_BATCH}"] = bf16_train_layer(
            layer, n_head, COVERAGE_BATCH, l, timed=False)
    seconds["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        training = check_training(synthetic_data(str(root / "check")), "bfloat16")
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli = check_bf16_cli(root)
        seconds["c"] = time.perf_counter() - t0
    print("  seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in seconds.items()), flush=True)
    return {"layers": layers, "training": training, "cli": cli, "seconds": seconds}


# ---- phase 21: bf16 on the unfused path, MLP and LSTM ---------------------------------------

# (a) B6-fwd, B5 and B6-bwd in bf16 against their plain bf16 versions, which
# round where JAX's kernels and the bf16 kernels round (P keep, P_used and
# dS rounded to bf16 before their products; dq, dk, dv written in bf16), at
# phase 10's shapes. B6-fwd's output to B2_BF16_ULPS ulps of its largest,
# as B2 bf16. dq, dk, dv to BF16_ATTN_GRAD_TOL of each tensor's largest,
# against the plain version (JAX's _bwd_core) and the staged plain
# backward: a rounding of P_used, dS or an output that flips between their
# fp32 sum orders moves an entry by one bf16 ulp of itself, so four ulps of
# the largest (2**-6), as B2 bf16's outputs; a lost key block or a wrong
# rounding point misses by far more. Launch 1's m and l to STATS_TOL of the
# largest (fp32 sums in other orders, the scores from exact bf16 products);
# its D row by row within fa.bf16_d_err_over_bound's bound of the staged
# version's (D_SUM_TOL of the row's sum of |terms|, and two bf16 ulps of each
# term whose P keep lies within D_TIE_ULPS fp32 ulps of a bf16 rounding tie,
# where the kernel's P and the staged version's may round to different
# neighbours). The control: D = dO . o from the output the backward is
# given (the dropout forward's, rounded to bf16; at rate 0 the fast form's)
# must break that bound, or the bound could not tell the recompute from it.
BF16_ATTN_GRAD_TOL = 2.0**-6
# (b) phase 11 in bf16: BF16_STEP_GATE_BAND, BF16_STEP_GRAD_TOL and
# BF16_LOSS_TOL, phase 20 (b)'s (against fp32's GATE_BAND, GRAD_TOL and
# LOSS_TOL): each layer's input differs between the two paths by the bf16
# roundings that flipped in the layers before.
# (c) BF16_RUN's configuration with FDIFF_FUSED_TRAIN=0, cut to
# UNFUSED_EPOCHS epochs (phase 12's) through fdiff-torch-train.
# (d) fdiff-torch-train score_model=mlp and =lstm in bf16 on phase 8's
# synthetic data, BF16_NET_EPOCHS epochs each, and fdiff-torch-sample of
# each run, BF16_SAMPLES samples at BF16_SAMPLE_STEPS steps. Then
# CHECK_STEPS steps of each network (the configs' widths, dropout 0, seed 0
# weights, phase 8's batches) on the card against the same steps on the CPU
# in bf16: the losses to BF16_LOSS_TOL relative and the step-0 gradients to
# BF16_NET_GRAD_TOL of each tensor's largest, the MLP's ReLU gates that took
# the other sign located (within BF16_STEP_GATE_BAND x sum |terms| of 0) and
# matched: each gate of a block's unit covers one of only 64 rows (a chain,
# the MLP flattens L x C), so one flip moves that unit's row of the weight
# gradient by a large share (0.128 of the tensor's largest, unmatched). The
# card runs cuBLAS and (the LSTM) cuDNN, which keeps its cell state in fp32,
# the CPU PyTorch's own bf16 operations, each rounding to bf16 at its own
# points, so the limits are phase 20 (b)'s for the bf16 flagship.
BF16_NET_EPOCHS = 1
BF16_NET_GRAD_TOL = BF16_STEP_GRAD_TOL


def check_bf16_attention(b: int, h: int, l: int, dh: int, timed: bool) -> dict:
    """Phase 21 (a) at one shape: B6-fwd (where ``(b, h, l, dh)`` is one of
    DROPOUT_FWD_SHAPES) and B5 and B6-bwd (one of BWD_SHAPES) in bf16 on
    random heads against their plain bf16 versions, the masks bit for bit;
    launch 1's statistics against the bf16 staged plain backward, two calls
    bit for bit and BWD_LAUNCHES CUDA launches per call by
    ``torch.profiler``. With ``timed`` the times of each kernel, its plain
    version and the PyTorch call (SDPA in bf16: its autograd backward for
    B5, with ``dropout_p`` DROPOUT forward for B6-fwd and backward for
    B6-bwd), and its bound (bf16 inputs read and outputs written once;
    the backward does not read the forward's output in bf16)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g, device="cuda").to(BF16)
                   for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    shape = f"bf16 B={b} H={h} L={l} dh={dh}"
    out: dict = {}
    n = q.numel()
    if not torch.equal(fa.attention_keep_cuda(b, h, l, seed, DROPOUT),
                       fa.attention_keep(b, h, l, seed, DROPOUT, "cuda")):
        raise AssertionError(f"B6 {shape}: the masks of the kernel and plain differ")
    if (b, h, l, dh) in DROPOUT_FWD_SHAPES:
        with torch.no_grad():
            call = lambda: fa._launch_fwd(q, k, v, seed, DROPOUT)  # noqa: E731
            got = call()
            plain = fa.flash_attention_dropout_reference(q, k, v, seed, DROPOUT)
            forms = {form: fa.attention_fwd_form(l, dh, BF16, form)
                     for form in ("ring", "resident")}
            same = {form: torch.equal(got, fa._launch_fwd(q, k, v, seed, DROPOUT, plan=plan))
                    for form, plan in forms.items() if plan is not None}
            torch.cuda.synchronize()
            r = {"form": fwd_form(l, dh, BF16), "as_forms_bit_for_bit": same,
                 "max_abs_err": (got.float() - plain.float()).abs().max().item(),
                 "tol": b2_tol(BF16, plain)}
            if not (got.dtype == BF16 and torch.isfinite(got.float()).all()
                    and r["max_abs_err"] <= r["tol"]):
                raise AssertionError(f"B6-fwd {shape}: kernel disagrees with plain version: {r}")
            if r["form"] != FWD_FORMS[(b, h, l, dh)] or not all(same.values()):
                raise AssertionError(f"B6-fwd {shape}: the {r['form']} form (expected "
                                     f"{FWD_FORMS[(b, h, l, dh)]}) or its bits against the "
                                     f"other forms: {same}")
            prof = device_us_by_kernel(call, launches=1)
            r["device_us_by_kernel"], r["launches_per_call"], r["profile_traces"] = \
                prof.us_by_kernel, prof.launches, prof.traces
            if r["launches_per_call"] != 1:
                raise AssertionError(f"B6-fwd {shape}: {r['launches_per_call']} CUDA launches "
                                     f"per call, expected 1")
            if timed:
                r.update(ms=time_ms(lambda: fa._launch_fwd(q, k, v, seed, DROPOUT)),
                         plain_ms=time_ms(lambda: fa.flash_attention_dropout_reference(
                             q, k, v, seed, DROPOUT), iters=10),
                         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                             q, k, v, dropout_p=DROPOUT)))
                r["bound_ms"], r["bound_by"] = bound(4 * b * h * l * l * dh, 4 * n * 2 + 8, BF16)
        print(f"  B6-fwd {shape}: masks bit for bit; {json.dumps(r)} (before the forward's "
              f"redesign {PRIOR_MS['B6-fwd'].get(shape)} ms)", flush=True)
        out["B6-fwd"] = r
    if (b, h, l, dh) not in BWD_SHAPES:
        return out
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    for name, sd, rate in (("B5", None, 0.0), ("B6-bwd", seed, DROPOUT)):
        keep = None if sd is None else fa.attention_keep(b, h, l, seed, rate, "cuda")
        if sd is None:
            o = fa.flash_attention_reference(q, k, v)
            plain_fn = lambda: fa.flash_attention_bwd_reference(q, k, v, do)  # noqa: E731
        else:
            o = fa.flash_attention_dropout_reference(q, k, v, seed, rate)
            plain_fn = lambda: fa.flash_attention_dropout_bwd_reference(  # noqa: E731
                q, k, v, do, seed, rate)
        call = lambda: fa._launch_bwd(q, k, v, o, do, sd, rate)  # noqa: E731
        got, again, plain = call(), call(), plain_fn()
        staged = fa.attention_bwd_staged(q, k, v, o, do, keep)
        torch.cuda.synchronize()
        grads = ("dq", "dk", "dv")
        r = {"form": bwd_form(b, h, l, dh, BF16),
             "max_rel_err": {t: rel_err(a.float(), p.float())
                             for t, a, p in zip(grads, got, plain)},
             "vs_staged": {t: rel_err(a.float(), p.float())
                           for t, a, p in zip(grads, got, staged)},
             "max_abs_err": max((a.float() - p.float()).abs().max().item()
                                for a, p in zip(got, plain)),
             "stats_rel_err": {t: rel_err(got[3][..., i], staged[3][..., i])
                               for i, t in enumerate(("m", "l"))},
             "D_err_over_bound": fa.bf16_d_err_over_bound(
                 got[3][..., 2], staged[3][..., 2], q, k, v, do, keep).max().item(),
             "saved_output_D_err_over_bound": fa.bf16_d_err_over_bound(
                 (do.float() * o.float()).sum(-1), staged[3][..., 2], q, k, v, do,
                 keep).max().item(),
             "bit_identical": all(torch.equal(a, c) for a, c in zip(got, again))}
        del again, plain
        bad = [t for t, a in zip(grads, got)
               if not (a.dtype == BF16 and torch.isfinite(a.float()).all())]
        worst = max(*r["max_rel_err"].values(), *r["vs_staged"].values())
        if bad or not worst <= BF16_ATTN_GRAD_TOL:
            raise AssertionError(f"{name} {shape}: kernel disagrees with plain version "
                                 f"(not finite bf16: {bad}): {r}")
        if not (max(r["stats_rel_err"].values()) <= STATS_TOL and r["D_err_over_bound"] <= 1.0):
            raise AssertionError(f"{name} {shape}: launch 1's statistics disagree with the "
                                 f"staged plain version: {r}")
        if not r["saved_output_D_err_over_bound"] > 1.0:
            raise AssertionError(f"{name} {shape}: the D bound does not tell the saved "
                                 f"output's D from the recomputed one: {r}")
        if not r["bit_identical"]:
            raise AssertionError(f"{name} {shape}: two calls on the same inputs differ")
        prof = device_us_by_kernel(call, launches=BWD_LAUNCHES)
        r["device_us_by_kernel"], r["launches_per_call"], r["profile_traces"] = \
            prof.us_by_kernel, prof.launches, prof.traces
        if r["launches_per_call"] != BWD_LAUNCHES:
            raise AssertionError(f"{name} {shape}: {r['launches_per_call']} CUDA launches per "
                                 f"call, expected {BWD_LAUNCHES}")
        if timed:
            sdpa = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
            r.update(ms=time_ms(call), plain_ms=time_ms(plain_fn, iters=10),
                     library_ms=time_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                                                    retain_graph=True)))
            del sdpa
            # The five products of 2 B H L^2 dh (S, dP, dq, dk, dv); q, k, v,
            # dO read and dq, dk, dv written once, in bf16.
            r["bound_ms"], r["bound_by"] = bound(10 * b * h * l * l * dh,
                                                 7 * n * 2 + (0 if sd is None else 8), BF16)
        print(f"  {name} {shape}: {json.dumps(r)} (gradients tol {BF16_ATTN_GRAD_TOL:.3e} of "
              f"max; m, l tol {STATS_TOL:.0e} of max, D within its bound at <= 1, the saved "
              f"output's D beyond it at > 1; before launch 1's redesign "
              f"{PRIOR_MS[name].get(shape)} ms)", flush=True)
        del got, staged, keep
        out[name] = r
    return out


def cudnn_lstm_kernels(model) -> dict:
    """The CUDA kernels of one forward and backward of ``model`` (the bf16
    LSTM score network) on a batch of TRAIN_BATCH, from ``torch.profiler``:
    the names and launches of each, and the dtypes of an LSTM layer's
    output and of the score."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(TRAIN_BATCH, MAX_LEN, N_CHANNELS, device="cuda")
    t = torch.rand(TRAIN_BATCH, device="cuda")
    model.train()
    for _ in range(2):
        model(x, t).sum().backward()
    torch.cuda.synchronize()
    seen = []
    hook = model.backbone[0].register_forward_hook(lambda m, i, o: seen.append(str(o.dtype)))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = model(x, t)
        y.sum().backward()
        torch.cuda.synchronize()
    hook.remove()
    names = {kernel_name(e.key): e.count for e in prof.key_averages()
             if getattr(e, "device_time_total", 0.0) > 0}
    return {"kernels": names, "layer_dtype": seen[0], "score_dtype": str(y.dtype),
            "cudnn": torch.backends.cudnn.enabled, "cudnn_version": torch.backends.cudnn.version()}


def bf16_net_steps(model_type: str, dm: SyntheticDatamodule) -> dict:
    """CHECK_STEPS steps of the bf16 ``model_type`` network (its config's
    widths, dropout 0, seed 0 weights) on phase 8's batches through the
    trainer on the card and on the CPU: the losses to BF16_LOSS_TOL, and
    the step-0 gradients to BF16_NET_GRAD_TOL against the CPU's or, where
    the MLP's ReLU gates (after each block's first linear) took the other
    sign on the two, against the CPU's with the card's gates (every flip
    located, within BF16_STEP_GATE_BAND x sum |terms| of 0); the parameters
    and gradients fp32."""
    cfg = compose("train", [f"score_model={model_type}"])["score_model"]
    arch = {k: cfg[k] for k in ("d_model", "num_layers") + (("d_mlp",) if "d_mlp" in cfg else ())}
    steps = draw_steps(dm, CHECK_STEPS)
    losses, grads, gates = {}, {}, {}

    def relu_linears(model) -> list:
        return [block[0] for block in model.backbone] if model_type == "mlp" else []

    for device in ("cuda", "cpu"):
        model = ScoreModelConfig(model_type=model_type, dtype="bfloat16", dropout_rate=0.0,
                                 **arch).build(N_CHANNELS, MAX_LEN, seed=0)
        trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), lr_max=cfg["lr_max"],
                          gradient_clip_val=1.0, ema_decay=0.999, device=device)
        trainer.start(dm.steps_per_epoch)
        batches = [tuple(a.to(device) for a in step[:3]) + (None,) for step in steps]
        grads[device], gates[device], pres, terms = gated_step0(trainer, batches[0],
                                                                relu_linears(model))
        if device == "cpu":
            flips = {i: gates["cuda"][i].cpu() != g for i, g in gates["cpu"].items()}
            located = [{"block": i, "chain": b, "unit": u, "pre_cpu": pres[i][b, u].item(),
                        "terms": terms[i][b, u].item()}
                       for i, where in flips.items() for b, u in where.nonzero().tolist()]
            grads["gate_matched"] = grads["cpu"] if not located else gated_step0(
                trainer, batches[0], relu_linears(model),
                {i: (where, gates["cuda"][i].cpu()) for i, where in flips.items()})[0]
        losses[device] = [trainer.train_step(*step[:3]).item() for step in batches]
        if not all(p.dtype == torch.float32 for p in trainer.params) or not all(
                g.dtype == torch.float32 for g in grads[device]):
            raise AssertionError(f"(d) {model_type} on {device}: parameters or gradients not fp32")
    names = [n for n, _ in model.named_parameters()]
    rel = {n: {"vs_cpu": rel_err(a.cpu(), b), "vs_gate_matched": rel_err(a.cpu(), m)}
           for n, a, b, m in zip(names, grads["cuda"], grads["cpu"], grads["gate_matched"])}
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    worst = max(rel.items(), key=lambda kv: kv[1]["vs_cpu"])
    worst_m = max(r["vs_gate_matched"] for r in rel.values())
    farthest = max((abs(f["pre_cpu"]) / f["terms"] for f in located), default=0.0)
    print(f"  (d) {model_type} bf16, {CHECK_STEPS} steps on the card against the CPU: losses "
          f"{losses['cuda']} / {losses['cpu']}, max rel diff {rel_loss:.3e} (tol "
          f"{BF16_LOSS_TOL:.0e}); step-0 gradients, worst against the CPU {worst[0]} "
          f"{json.dumps(worst[1])}, worst against the CPU with the card's ReLU gates "
          f"{worst_m:.3e} (tol {BF16_NET_GRAD_TOL:.3e}); gates flipped: {len(located)}, the "
          f"farthest {farthest:.3e} x sum |terms| from 0 (band {BF16_STEP_GATE_BAND:.1e}), the "
          f"first {json.dumps(located[:5])}; per tensor {json.dumps(rel)}", flush=True)
    if not all(math.isfinite(x) for x in losses["cuda"] + losses["cpu"]):
        raise AssertionError(f"(d) {model_type}: losses not finite: {losses}")
    bad = {n: r for n, r in rel.items()
           if not (r["vs_cpu"] <= BF16_NET_GRAD_TOL
                   or (located and r["vs_gate_matched"] <= BF16_NET_GRAD_TOL))}
    if not rel_loss <= BF16_LOSS_TOL or bad or farthest > BF16_STEP_GATE_BAND:
        raise AssertionError(f"(d) {model_type}: the card and the CPU disagree: losses "
                             f"{rel_loss}, gradients {bad}, gates up to {farthest} x terms")
    return {"losses": losses, "loss_rel_err": rel_loss, "grad_rel_err": worst[1]["vs_cpu"],
            "grad_rel_err_gate_matched": worst_m, "gate_flips": len(located),
            "gate_flip_farthest": farthest}


def checkpoint_dtypes(run_dir: Path) -> list[str]:
    params = load_checkpoint(get_best_checkpoint(run_dir / "checkpoints"))
    return sorted({str(t.dtype) for t in params.values()})


def check_bf16_unfused(phase12: dict) -> dict:
    """Phase 21 (a)-(d); the seconds of each."""
    seconds, attn = {}, {}
    t0 = time.perf_counter()
    for b, h, l, dh in dict.fromkeys(DROPOUT_FWD_SHAPES + BWD_SHAPES):
        attn[f"B={b} H={h} L={l} dh={dh}"] = check_bf16_attention(
            b, h, l, dh, timed=(b, l) == (TRAIN_BATCH, MAX_LEN))
    seconds["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dm = synthetic_data(str(root / "check"))
        t0 = time.perf_counter()
        check = {rate: check_unfused_training(dm, rate, "bfloat16") for rate in (DROPOUT, 0.0)}
        fit = {rate: run_unfused_training(dm, rate, "bfloat16") for rate in (DROPOUT, 0.0)}
        print(f"  (b) unfused steps/s, train seconds only (C3's steps_per_sec in brackets): "
              + "; ".join(f"dropout {rate}: bf16 {fit[rate]['steps_per_s']:.3f} "
                          f"({fit[rate]['epoch_steps_per_sec']}), fp32 (phase 12) "
                          f"{phase12[rate]['steps_per_s']:.3f} "
                          f"({phase12[rate]['epoch_steps_per_sec']})" for rate in fit),
              flush=True)
        seconds["b"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        steps = UNFUSED_EPOCHS * -(-TRAIN_SERIES // TRAIN_BATCH)
        val = steps * VAL_DRAWS * N_LAYERS
        expected = {**{k: 0 for k in read_counts()}, "B2": val,
                    "B6-fwd": steps * N_LAYERS, "B6-bwd": steps * N_LAYERS}
        with unfused_training():
            cli = train_with_cli(bf16_cli_overrides(root, "bfloat16")
                                 + [f"trainer.max_epochs={UNFUSED_EPOCHS}"],
                                 "(c) unfused bf16", expected=expected)
        cli["B2 fast bf16"] = fa.fast_launches
        run_dir = Path(cli["run_dir"])
        records = [json.loads(s) for s in (run_dir / "metrics.jsonl").read_text().splitlines()]
        cli["steps_per_sec"] = [r["steps_per_sec"] for r in records if "epoch" in r]
        cli["checkpoint_dtypes"] = checkpoint_dtypes(run_dir)
        print(f"  (c) unfused bf16 through fdiff-torch-train: B2 fast {cli['B2 fast bf16']} of "
              f"{cli['launches']['B2']}; steps/s per epoch (C3) {cli['steps_per_sec']} beside "
              f"phase 12's fp32 {phase12[DROPOUT]['epoch_steps_per_sec']}; checkpoint "
              f"{cli['checkpoint_dtypes']}", flush=True)
        if cli["B2 fast bf16"] != val or cli["checkpoint_dtypes"] != ["torch.float32"]:
            raise AssertionError(f"(c) unfused bf16: B2 fast {cli['B2 fast bf16']} of {val}, "
                                 f"checkpoint {cli['checkpoint_dtypes']}")
        seconds["c"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        none = {k: 0 for k in read_counts()}
        nets = {}
        for model_type in ("mlp", "lstm"):
            run = train_with_cli(
                [f"run_dir={root / 'runs'}", f"score_model={model_type}", "datamodule=synthetic",
                 f"datamodule.data_dir={root / 'data'}", "fourier_transform=true",
                 "score_model.dtype=bfloat16", "trainer.callbacks.sampling.enabled=false",
                 f"trainer.max_epochs={BF16_NET_EPOCHS}"], f"(d) {model_type} bf16",
                expected=none)
            run["checkpoint_dtypes"] = checkpoint_dtypes(Path(run["run_dir"]))
            sampled = sample_with_cli(Path(run["run_dir"]), BF16_SAMPLES, BF16_SAMPLE_STEPS,
                                      QUALITY_SEED, f"(d) {model_type} bf16", none,
                                      (MAX_LEN, N_CHANNELS))
            sampled.pop("results")
            nets[model_type] = {"train": run, "sample": sampled,
                                "steps": bf16_net_steps(model_type, dm)}
            if run["checkpoint_dtypes"] != ["torch.float32"]:
                raise AssertionError(f"(d) {model_type}: checkpoint {run['checkpoint_dtypes']}")
        lstm = ScoreModelConfig(model_type="lstm", dtype="bfloat16").build(
            N_CHANNELS, MAX_LEN, seed=0).to("cuda")
        nets["lstm"]["kernels"] = cudnn_lstm_kernels(lstm)
        print(f"  (d) the bf16 LSTM's kernels, one forward and backward at B={TRAIN_BATCH}: "
              f"{json.dumps(nets['lstm']['kernels'])}", flush=True)
        lstm_run = nets["lstm"]["kernels"]
        if lstm_run["layer_dtype"] != "torch.bfloat16" or not any(
                "lstm" in k.lower() or "rnn" in k.lower() for k in lstm_run["kernels"]):
            raise AssertionError(f"(d) lstm: the layer did not run an LSTM kernel in bf16: "
                                 f"{lstm_run}")
        seconds["d"] = time.perf_counter() - t0
    print("  seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in seconds.items()), flush=True)
    return {"attention": attn, "check": check, "fit": fit, "cli": cli, "nets": nets,
            "seconds": seconds}


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
        print(f"  B1 {dtype} B={SAMPLE_CHAINS}: {checks[dtype][SAMPLE_CHAINS]['kernel_ms']:.4f} "
              f"ms (before C1's repair: {B1_BEFORE_C1_MS[dtype]} ms)", flush=True)
    c1 = check_batch_independence(load_flagship(torch.float32, "cuda").backbone.layers[0])
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
        attn_kernels = {f"B={b} H={h} L={l} dh={dh}": check_attention_kernels(b, h, l, dh)
                        for b, h, l, dh in DROPOUT_FWD_SHAPES}
        attn_bwd = {f"B={b} H={h} L={l} dh={dh}": check_attention_bwd(b, h, l, dh)
                    for b, h, l, dh in BWD_SHAPES}
        attn_main = {**attn_kernels[f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD}"],
                     **attn_bwd[f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD}"]}
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
    turns: dict = {0: [], **{level: [] for level in INT8_LEVELS}}
    for _ in range(2):
        turns[0].append(run_main_path(torch.bfloat16)["samples_per_s"])
        for level in INT8_LEVELS:
            turns[level].append(run_int8_main_path(level, main[torch.bfloat16]))
    int8_main = {level: {**runs[0], "samples_per_s_runs": [r["samples_per_s"] for r in runs],
                         "bf16_samples_per_s_runs": turns[0]}
                 for level, runs in turns.items() if level}
    print(f"  samples/s in turns, bf16 {turns[0]}, "
          + ", ".join(f"{INT8_NAMES[level]} {int8_main[level]['samples_per_s_runs']}"
                      for level in INT8_LEVELS), flush=True)
    int8_traj = {level: check_int8_trajectory(level) for level in INT8_LEVELS}
    phase("14 int8 main path", t0)

    t0 = time.perf_counter()
    pc = run_pc_main_path()
    phase("15 pc main path", t0)

    t0 = time.perf_counter()
    quality = check_quality()
    phase("16 sample quality", t0)

    t0 = time.perf_counter()
    cli = check_cli(quality)
    phase("17 CLI path", t0)

    t0 = time.perf_counter()
    datasets = check_datasets_and_networks()
    phase("18 datasets, MLP and LSTM", t0)

    t0 = time.perf_counter()
    parallel = check_data_parallel(main[torch.float32]["samples"], training)
    phase("19 data-parallel training and sharded sampling", t0)

    t0 = time.perf_counter()
    bf16 = check_bf16(flagship)
    phase("20 bf16 training", t0)

    t0 = time.perf_counter()
    bf16_unfused = check_bf16_unfused(unfused)
    phase("21 bf16 on the unfused path, MLP and LSTM", t0)

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
            "profile_traces": breakdown[f"B1 {name}"]["profile_traces"],
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
                           **{f"float32 {k}": a["B2"] for k, a in attn_kernels.items()}},
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
            "attention_functions": [f"{f}<float, *, kDh, true{', false' if 'dq' in f else ''}>"
                                    for f in TRAIN_ATTENTION_FUNCTIONS
                                    if key == "bwd" or "fwd" in f],
            "sass": {k: v for k, v in sass.items() if k.startswith("fused_encoder_train: ")},
            "device_us_by_kernel": breakdown[count]["device_us_by_kernel"],
            "profile_traces": breakdown[count]["profile_traces"],
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
        checked = attn_kernels if key == "B6-fwd" else attn_bwd
        extra = {"functions": ["attention_fwd_mma_kernel<float, false, true, kDh, false, "
                               "false>"]} \
            if key == "B6-fwd" else {
            "functions": [f"{f}<float, {str(key == 'B6-bwd').lower()}, kDh, false"
                          f"{', false' if 'dq' in f else ''}>" for f in BWD_FUNCTIONS],
            "launches_per_call": r["launches_per_call"],
            "device_us_by_kernel": r["device_us_by_kernel"],
            "profile_traces": r["profile_traces"],
            "sass": {k: v for k, v in sass.items() if k.startswith("flash_attention: ")
                     and "attention_bwd" in k}}
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(a[key]["max_abs_err"] for a in checked.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], **extra,
            "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} float32"
                     + ("" if key == "B5" else f" dropout {DROPOUT}"),
            "sdpa_backend": attn_main["sdpa_backend"],
            "checked_shapes": {k: a[key] for k, a in checked.items()},
        })
    bf16_runs = bf16["cli"]["bfloat16"]
    b16 = attention[torch.bfloat16]
    kernels.append({
        "name": "flash_attention_fast/bfloat16", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_FAST_REPLACES, "launches": bf16_runs["launches"]["B2 fast bf16"],
        "max_abs_err": max([b16["max_abs_err"]] + [c["max_abs_err"] for k, c in
                                                   attn_shapes.items() if k.startswith("bfloat16")
                                                   and int(k.split("dh=")[1]) < fa.DH_PAD]),
        "ms": b16["ms"], "plain_ms": b16["plain_ms"], "bound_ms": b16["bound_ms"],
        "bound_by": b16["bound_by"], "library_ms": b16["library_ms"],
        "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} bfloat16",
        "launches_note": f"validation of the bf16 training run, phase 20 (c), {BF16_EPOCHS} epochs",
    })
    flagship_key = f"L={MAX_LEN} D=72 B={TRAIN_BATCH}"
    for key, name, replaces, count in (
        ("fwd", "fused_encoder_layer_train_fwd/bfloat16", TRAIN_FWD_REPLACES, "B3"),
        ("bwd", "fused_encoder_layer_train_bwd/bfloat16", TRAIN_BWD_REPLACES, "B4"),
    ):
        r = bf16["layers"][flagship_key][key]
        kernels.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCE, "replaces": replaces,
            "launches": bf16_runs["launches"][count],
            "max_abs_err": max(c[key]["max_abs_err"] for c in bf16["layers"].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"B={TRAIN_BATCH} L={MAX_LEN} D=72 H={N_HEAD} F=2048 bf16 dropout {DROPOUT}",
            "steps_per_sec": bf16_runs["steps_per_sec"],
            "launches_per_call": breakdown[f"{count} bfloat16"]["launches_per_call"],
            "attention_functions": [f"{f}<__nv_bfloat16, *, kDh, true"
                                    f"{'' if 'dkv' in f else ', kKept'}>"
                                    for f in TRAIN_ATTENTION_FUNCTIONS
                                    if key == "bwd" or "fwd" in f],
            "sass": {k: v for k, v in sass.items() if k.startswith("fused_encoder_train_bf16: ")},
            "device_us_by_kernel": breakdown[f"{count} bfloat16"]["device_us_by_kernel"],
            "profile_traces": breakdown[f"{count} bfloat16"]["profile_traces"],
            **({"stage_ms": r["stage_ms"]} if key == "bwd" else {}),
            "checked_lengths": {k: v[key] for k, v in bf16["layers"].items()},
        })
    main_attn = bf16_unfused["attention"][
        f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD}"]
    for key, name, replaces, launches in (
        ("B5", "flash_attention_bwd/bfloat16", FLASH_BWD_REPLACES,
         bf16_unfused["fit"][0.0]["launches"]["B5"]),
        ("B6-fwd", "flash_attention_dropout_fwd/bfloat16", DROPOUT_FWD_REPLACES,
         bf16_unfused["fit"][DROPOUT]["launches"]["B6-fwd"]),
        ("B6-bwd", "flash_attention_dropout_bwd/bfloat16", DROPOUT_BWD_REPLACES,
         bf16_unfused["fit"][DROPOUT]["launches"]["B6-bwd"]),
    ):
        r = main_attn[key]
        checked = {k: a[key] for k, a in bf16_unfused["attention"].items() if key in a}
        extra = {"functions": [
            "attention_fwd_mma_kernel<__nv_bfloat16, false, true, kDh, false, kKept>"],
            "form": r["form"], "device_us_by_kernel": r["device_us_by_kernel"],
            "launches_per_call": r["launches_per_call"]} \
            if key == "B6-fwd" else {
            "functions": [f"{f}<__nv_bfloat16, {str(key == 'B6-bwd').lower()}, kDh, false"
                          f"{', kKept' if 'dq' in f else ''}>" for f in BWD_FUNCTIONS],
            "launches_per_call": r["launches_per_call"],
            "device_us_by_kernel": r["device_us_by_kernel"],
            "profile_traces": r["profile_traces"]}
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checked.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], **extra,
            "shape": f"B={TRAIN_BATCH} H={N_HEAD} L={MAX_LEN} dh={72 // N_HEAD} bfloat16"
                     + ("" if key == "B5" else f" dropout {DROPOUT}"),
            "launches_cli": bf16_unfused["cli"]["launches"].get(key, 0),
            "sass": {k: v for k, v in sass.items() if k.startswith("flash_attention: ")
                     and "__nv_bfloat16" in k and ("attention_bwd" in k) == (key != "B6-fwd")},
            "checked_shapes": checked,
        })
    breakdown8 = int8_checks["breakdown"]
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
            "launches_per_call": breakdown8[f"{INT8_NAMES[level]} bfloat16"]["launches_per_call"],
            "device_us_per_launch": {
                k: v["device_us_per_launch"] for k, v in breakdown8.items()
                if k.startswith(INT8_NAMES[level])},
            "profile_traces": breakdown8[f"{INT8_NAMES[level]} bfloat16"]["profile_traces"],
            "sass": {k: v for k, v in sass.items() if k.startswith("fused_encoder_int8: ")},
            "shape": f"B={SAMPLE_CHAINS} L={MAX_LEN} D=72 H={N_HEAD} F=2048 bfloat16, "
                     f"FDIFF_FUSED_INT8={level}",
            "samples_per_s": int8_main[level]["samples_per_s"],
            "samples_per_s_runs": int8_main[level]["samples_per_s_runs"],
            "bf16_samples_per_s_runs": int8_main[level]["bf16_samples_per_s_runs"],
            "rel_l2_vs_bf16_samples": int8_main[level]["rel_l2_vs_bf16"],
            "trajectory": {k: int8_traj[level][k] for k in ("with_kernel_codes",
                                                             "with_own_codes")},
            "checked_shapes": {k: {f: c[f] for f in ("max_abs_err", "ms", "plain_ms", "b1_ms",
                                                     "bound_ms")}
                               for k, c in by_shape.items()},
        })
    # The launches of phase 17's CLI path ((a) and (c); the CLIs run fp32).
    cli_counts = {k: cli["train"]["launches"][k] + cli["sample"]["launches"][k]
                  for k in cli["train"]["launches"]}
    cli_names = {"fused_encoder_layer/float32": "B1", "flash_attention": "B2",
                 "fused_encoder_layer_train_fwd": "B3", "fused_encoder_layer_train_bwd": "B4"}
    for k in kernels:
        if "launches_cli" not in k:  # phase 21's rows hold their own CLI run's
            k["launches_cli"] = cli_counts[cli_names[k["name"]]] if k["name"] in cli_names else 0
    # The launches of phase 18's dataset paths ((b) ECG, (c) NASDAQ, NASA,
    # droughts), by dataset.
    by_dataset = {"ecg": {k: datasets["ecg_train"]["launches"][k]
                          + datasets["ecg_sample"]["launches"][k]
                          for k in datasets["ecg_train"]["launches"]},
                  **{n: r["launches"] for n, r in datasets["fused_epoch"].items()}}
    for k in kernels:
        k["launches_datasets"] = {n: c[cli_names[k["name"]]] if k["name"] in cli_names else 0
                                  for n, c in by_dataset.items()}
    # Phase 19's launches on each rank: (b)'s fit and (c)'s sampling run.
    mesh_names = {**cli_names, "flash_attention_bwd": "B5", "flash_attention_dropout_fwd":
                  "B6-fwd", "flash_attention_dropout_bwd": "B6-bwd",
                  "fused_encoder_layer_int8/bfloat16": "B7",
                  "fused_encoder_layer_int8_attn/bfloat16": "B8"}
    for k in kernels:
        k["launches_mesh"] = {
            f"rank {i}": b[mesh_names[k["name"]]] + c[mesh_names[k["name"]]]
            if k["name"] in mesh_names else 0
            for i, (b, c) in enumerate(zip(parallel["b"]["launches"], parallel["c"]["launches"]))}
    print(f"pc: {json.dumps(pc)}", flush=True)
    print(f"quality: {json.dumps(quality)}", flush=True)
    print(f"cli: {json.dumps(cli)}", flush=True)
    print(f"datasets: {json.dumps(datasets)}", flush=True)
    print(f"parallel: {json.dumps(parallel)}", flush=True)
    print(f"bf16: {json.dumps({k: v for k, v in bf16.items() if k != 'layers'})}", flush=True)
    print("bf16 unfused: "
          + json.dumps({k: v for k, v in bf16_unfused.items() if k != "attention"}), flush=True)
    print(f"C1: {json.dumps(c1)}", flush=True)
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
    sys.exit(rank_main(*sys.argv[2:4]) if sys.argv[1:2] == ["--rank"] else main())
