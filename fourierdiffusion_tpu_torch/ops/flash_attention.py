"""Multi-head attention over ``(B, H, L, dh)`` tensors, forward and backward,
with and without dropout on the attention weights (port of
``fourierdiffusion_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T / sqrt(dh)) v`` and is
differentiable:

* on CUDA tensors (``FlashAttention``) the forward launches the
  hand-written kernel B2 (on the tensor cores, ``attention_fwd_plan``) and
  the backward the kernel B5 (two launches on the tensor cores,
  ``attention_bwd_plan``; in fp32 it takes the forward's output, which the
  Function saves beside q, k and v) (``csrc/flash_attention.cu``);
  ``launches`` and ``bwd_launches`` count them, one per call;
* on CPU tensors (``PlainAttention``) it runs ``flash_attention_reference``
  and, for the gradient, ``flash_attention_bwd_reference``, the plain
  PyTorch versions.

``flash_attention_dropout(q, k, v, seed, rate)`` is the same with dropout
on the normalised attention weights: the kernels B6-fwd (B2's kernel with
the keep factors, on B2's plan of the dtype) and B6-bwd
(``FlashAttentionDropout``; ``dropout_fwd_launches``,
``dropout_bwd_launches``), or ``flash_attention_dropout_reference`` and
``..._bwd_reference`` (``PlainAttentionDropout``). Its mask is
``attention_keep``: the TPU kernels' interpret-mode hash at tag
``seed + chain*131071 + g0`` (uint32), g0 the first head of the head group
(``attention_group``, the same in forward and backward), so the kernels,
the plain versions and the JAX package in interpret mode draw bit-identical
masks. ``seed`` is an int or an integer tensor on the inputs' device (read
there by the kernels, so drawing it does not synchronise).

Numerics, as the TPU kernels, in fp32 and bf16 alike: fp32, and bf16 with
``dh >= 16``, take ``S = (q k^T) * scale`` in fp32 and the exact softmax;
bf16 with ``dh < 16`` takes the max-free forward (q pre-scaled and rounded
to bf16, S clamped to +-60, exp, reciprocal of the row sum); the dropout
forward takes the exact form in either dtype. P (times keep) is rounded to
the input dtype and ``O = P v`` accumulates in fp32. The backward
(``_bwd_core``) recomputes P with the exact softmax in fp32, D = dO . O
from ``O = P_used v`` unrounded, and rounds P_used and dS to the input
dtype before their products; dq, dk and dv come out in it. The bf16
backward kernel recomputes that O (the saved output is rounded, and at a
rate of 0 comes from the fast form); the fp32 one takes D from the saved
output, which differs only in summation order. ``attention_bwd_staged`` is
the plain version of the backward as its two launches split the work (row
statistics over key blocks, in bf16 O, then dq; then dk and dv over blocks
of query rows), beside the plain versions of JAX's ``_bwd_core``.
``PlainAttention`` and ``PlainAttentionDropout`` are the plain versions as
differentiable functions on any device: the CPU route of the wrappers, and
the bf16 plain route of the unfused module on the card
(``models/attention.py``, ``plain=True``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fourierdiffusion_tpu_torch.ops.dropout_hash import (
    CHAIN_STRIDE,
    M32,
    hash_bits,
    head_group,
    head_positions,
    keep_scale,
    keep_threshold,
    lanes,
)

SCORE_CLAMP = 60.0
DH_PAD = 16  # the TPU kernels' head padding; the fast form is for dh < 16
MAX_DH = 64  # the CUDA kernels' largest head dim
# B2's tiles (csrc/flash_attention.cu): keys in blocks of 64 streamed
# through a ring of two, a warp per 16 query rows, at most 8 warps (128
# rows) per CTA.
KEY_BLOCK, WARP_ROWS, MAX_WARPS, FWD_STAGES = 64, 16, 8, 2
TILE_ROWS = MAX_WARPS * WARP_ROWS
# B5/B6-bwd's statistics per query row (softmax max, sum, D = dO . O); its
# two launches take B2's tiles and ring.
STAT_COLS = 3

#: Kernel launches so far in this process; only the CUDA branches add to
#: them (B2, B5, B6-fwd, B6-bwd). Callers reset them to 0 to count a run.
#: ``fast_launches`` counts, of B2's ``launches``, those of the bf16 fast
#: form (``_fast_fwd_kernel``'s counterpart: bf16 with dh < 16).
launches = 0
fast_launches = 0
bwd_launches = 0
dropout_fwd_launches = 0
dropout_bwd_launches = 0


def _fast(q: torch.Tensor) -> bool:
    return q.dtype == torch.bfloat16 and q.shape[-1] < DH_PAD


@functools.cache
def _bf16_scale(dh: int) -> float:
    """``1/sqrt(dh)`` rounded to bf16, as the TPU wrapper's fast form
    multiplies q by it."""
    return torch.tensor(1.0 / math.sqrt(dh), dtype=torch.bfloat16).float().item()


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """``q / sqrt(dh)`` as the TPU wrapper forms it in bf16: the scale is a
    bf16 value and the product is rounded to bf16 (the kernel B2 does the
    same as it loads q)."""
    return (q.float() * _bf16_scale(q.shape[-1])).to(torch.bfloat16)


# ---- masks ------------------------------------------------------------------------


def attention_group(n_head: int, max_len: int) -> int:
    """Heads per group of the attention masks (JAX's ``_bwd_group`` at the
    padded Lp): one group of 12 for L <= 256, three of 4 at L=365."""
    return head_group(n_head, lanes(max_len), live_bytes_per_elem=17)


def _seed_tensor(seed: torch.Tensor | int, device: torch.device) -> torch.Tensor:
    """The seed as one int64 on ``device``."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).reshape(1)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


def attention_keep(
    batch: int, n_head: int, max_len: int, seed: torch.Tensor | int, rate: float,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """``keep / (1 - rate)`` (fp32, ``(B, H, L, L)``) of the attention
    weights: entry (b, h, i, j) is the TPU kernel's (g, i, j) of program b
    and head group g0 = h - h % group, keyed by ``seed + b*131071 + g0``."""
    device = torch.device(device)
    idx, g0 = head_positions(n_head, max_len, attention_group(n_head, max_len), device)
    chain = torch.arange(batch, dtype=torch.int64, device=device)
    key = (_seed_tensor(seed, device) + chain[:, None] * CHAIN_STRIDE + g0[None, :]) & M32
    return keep_scale(hash_bits(idx[None], key[:, :, None, None]), rate)


# ---- the plain versions ------------------------------------------------------------


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the forward, rounding at the same points."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    if _fast(q):
        s = _prescale(q).float() @ k.float().transpose(-1, -2)
        e = torch.exp(torch.clamp(s, -SCORE_CLAMP, SCORE_CLAMP))
        p = e * (1.0 / e.sum(-1, keepdim=True))
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
    return (p.to(dtype).float() @ v.float()).to(dtype)


def _probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The exact softmax of ``(q k^T) * scale``, fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)


def _bwd_core(q, k, v, do, keep: torch.Tensor | None):
    """The TPU kernels' ``_bwd_core``: with ``keep`` the chain rule runs
    through ``P_used = P * keep``."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = _probs(q, k)
    p_used = (p if keep is None else p * keep).to(dtype).float()
    o = p_used @ vf
    d_col = (dof * o).sum(-1, keepdim=True)
    dp = dof @ vf.transpose(-1, -2)
    if keep is not None:
        dp = dp * keep
    ds = (p * (dp - d_col)).to(dtype).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p_used.transpose(-1, -2) @ dof
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def flash_attention_bwd_reference(q, k, v, do):
    """Plain PyTorch version of the backward: ``(dq, dk, dv)``."""
    return _bwd_core(q, k, v, do, None)


def _keep_of(q: torch.Tensor, seed, rate: float) -> torch.Tensor:
    b, h, l, _ = q.shape
    return attention_keep(b, h, l, seed, rate, q.device)


def flash_attention_dropout_reference(q, k, v, seed, rate: float) -> torch.Tensor:
    """Plain PyTorch version of the forward with dropout."""
    p = _probs(q, k) * _keep_of(q, seed, rate)
    return (p.to(q.dtype).float() @ v.float()).to(q.dtype)


def flash_attention_dropout_bwd_reference(q, k, v, do, seed, rate: float):
    """Plain PyTorch version of the backward with dropout: ``(dq, dk, dv)``."""
    return _bwd_core(q, k, v, do, _keep_of(q, seed, rate))


def attention_bwd_staged(q, k, v, o, do, keep: torch.Tensor | None = None):
    """Plain PyTorch version of B5 (``keep`` None) and B6-bwd as their two
    launches split the work: launch 1 keeps each query row's running max
    and rescaled sum over key blocks of 64, takes D = dO . O (fp32: O the
    forward's output ``o``; bf16: ``o`` unused, O = P_used v recomputed in
    fp32 over the key blocks from the exact softmax, P_used = P keep rounded
    to bf16, as JAX's ``_bwd_core`` forms it) and adds dq block by block;
    launch 2 forms P from those statistics and adds dk and dv over blocks of
    64 query rows. In bf16 dS and P_used are rounded to bf16 before their
    products, and dq, dk, dv come out in bf16. Returns ``(dq, dk, dv,
    stats)``, stats ``(B, H, L, 3)`` fp32: m, l, D."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    n = q.shape[-2]
    blocks = [(i0, min(n, i0 + KEY_BLOCK)) for i0 in range(0, n, KEY_BLOCK)]

    def scores(qb, kb):
        return (qb @ kb.transpose(-1, -2)) * scale

    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).float()

    def kept(rows: slice, cols: slice):
        return 1.0 if keep is None else keep[..., rows, cols]

    m = torch.full(q.shape[:-1] + (1,), torch.finfo(torch.float32).min, device=q.device)
    total = torch.zeros_like(m)
    for j0, j1 in blocks:
        s = scores(qf, kf[..., j0:j1, :])
        mb = torch.maximum(m, s.amax(-1, keepdim=True))
        total = total * torch.exp(m - mb) + torch.exp(s - mb).sum(-1, keepdim=True)
        m = mb
    if dtype == torch.float32:
        d_col = (dof * of).sum(-1, keepdim=True)
    else:
        o_acc = torch.zeros_like(qf)
        for j0, j1 in blocks:
            p = torch.exp(scores(qf, kf[..., j0:j1, :]) - m) / total
            o_acc = o_acc + rounded(p * kept(slice(None), slice(j0, j1))) @ vf[..., j0:j1, :]
        d_col = (dof * o_acc).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    for j0, j1 in blocks:
        p = torch.exp(scores(qf, kf[..., j0:j1, :]) - m) / total
        dp = dof @ vf[..., j0:j1, :].transpose(-1, -2)
        ds = rounded(p * (dp * kept(slice(None), slice(j0, j1)) - d_col))
        dq = dq + ds @ kf[..., j0:j1, :]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0, i1 in blocks:
        rows = slice(i0, i1)
        p = torch.exp(scores(qf[..., rows, :], kf) - m[..., rows, :]) / total[..., rows, :]
        kp = kept(rows, slice(None))
        dp = dof[..., rows, :] @ vf.transpose(-1, -2)
        ds = rounded(p * (dp * kp - d_col[..., rows, :]))
        dk = dk + ds.transpose(-1, -2) @ qf[..., rows, :]
        dv = dv + rounded(p * kp).transpose(-1, -2) @ dof[..., rows, :]
    return ((dq * scale).to(dtype), (dk * scale).to(dtype), dv.to(dtype),
            torch.cat([m, total, d_col], dim=-1))


# The bound of bf16_d_err_over_bound: the fp32 sums' share of the row's
# sum of |terms|, and the fp32 ulps from a bf16 rounding tie within which
# an entry of P keep may round to the other neighbour in another fp32 order.
D_SUM_TOL = 2.0**-16
D_TIE_ULPS = 256


def bf16_d_err_over_bound(d, d_ref, q, k, v, do, keep: torch.Tensor | None = None) -> torch.Tensor:
    """Per query row, ``|d - d_ref|`` over the bound that two bf16
    backward statistics D meet when both are JAX's ``D = dO . (P_used v)``
    (P_used = bf16(P keep), O unrounded) and differ only in fp32 roundings:
    D_SUM_TOL of the row's sum of |terms| ``sum_j P_used,ij sum_c
    |dO_ic v_jc|`` (fp32 sums in other orders), plus 2**-6 (two bf16 ulps
    at least: an entry moves by one) of each term ``P_used,ij (dO_i . v_j)``
    whose ``P keep`` lies within D_TIE_ULPS fp32 ulps of a bf16 rounding tie
    (an entry the two P's may round to different neighbours). A value up to 1
    holds the bound; D taken from a bf16 output (the forward's, rounded, or
    the fast form's) reads far above it."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.softmax((qf @ kf.transpose(-1, -2)) / math.sqrt(q.shape[-1]), -1)
    if keep is not None:
        p = p * keep
    near_tie = ((p.view(torch.int32) & 0xFFFF) - 0x8000).abs() <= D_TIE_ULPS
    p = p.to(torch.bfloat16).float()
    sums = (p * (dof.abs() @ vf.abs().transpose(-1, -2))).sum(-1)
    ties = (p * near_tie * (dof @ vf.transpose(-1, -2)).abs()).sum(-1)
    limit = (D_SUM_TOL * sums + 2.0**-6 * ties).clamp_min(torch.finfo(torch.float32).tiny)
    return (d - d_ref).abs() / limit


class PlainAttention(torch.autograd.Function):
    """The plain versions of B2 and B5 as one differentiable function on
    tensors on any device, never a kernel: the forward
    ``flash_attention_reference`` (in bf16 with dh < 16 the fast form), the
    backward ``flash_attention_bwd_reference`` (JAX's ``_bwd_core``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_reference(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd_reference(*ctx.saved_tensors, do)


class PlainAttentionDropout(torch.autograd.Function):
    """The plain versions of B6-fwd and B6-bwd as one differentiable
    function on tensors on any device, never a kernel."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate: float):
        seed = _seed_tensor(seed, q.device)
        ctx.save_for_backward(q, k, v, seed)
        ctx.rate = rate
        return flash_attention_dropout_reference(q, k, v, seed, rate)

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed = ctx.saved_tensors
        return (*flash_attention_dropout_bwd_reference(q, k, v, do, seed, ctx.rate), None, None)


# ---- the kernels ---------------------------------------------------------------------


class AttnFwdPlan(ctypes.Structure):
    """B2's launch as the kernel takes it (``AttnFwdPlan`` of
    ``csrc/attention_mma.cuh``): the instance's head width, warps per CTA,
    CTAs per head, key blocks, the row stride of a staged block, the
    elements of a stage of the ring, the shared memory in bytes, and
    whether the head's K and V are staged whole and S kept in registers."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kdh", "warps", "q_tiles", "key_blocks", "stride", "stage", "bytes", "resident", "kept")]


# The key blocks over which a warp keeps its rows' S in registers (the
# forward's pass 1 for pass 2; B5/B6-bwd's launch 1 for its later passes),
# and the instance head width it does so at.
KEPT_BLOCKS, KEPT_DH = 2, 16


@functools.lru_cache(maxsize=64)
def attention_fwd_plan(max_len: int, dh: int, dtype: torch.dtype, fast: bool = False) -> dict:
    """B2's launch at length ``max_len`` and head width ``dh`` in ``dtype``
    (for every chain and head alike; B6-fwd and the training layer's
    attention take the same; ``fast``: B2's max-free bf16 form): the head
    width of the instance (``kdh``: the mma's k step, 8 in fp32 and 16 in
    bf16, doubled up to cover dh), the warps of a CTA (one per 16 query rows of the first tile,
    at most 8), the CTAs per head (tiles of 128 query rows), the key blocks
    of 64, the row stride of a staged K or V block, the elements of a stage
    of the ring (a block of K and one of V), ``resident`` where the head's K
    and V are staged whole (``2 blocks x 64 x stride`` elements, at most
    half of ``SMEM_LIMIT``: two CTAs to an SM), ``kept`` where bf16's exact
    form also keeps S in registers (at most KEPT_BLOCKS key blocks, kdh
    KEPT_DH), the shared memory (the head where resident, else FWD_STAGES
    stages whatever L) and all of it as ``AttnFwdPlan`` (``struct``)."""
    from fourierdiffusion_tpu_torch.ops.fused_encoder import SMEM_LIMIT, tile_stride  # (cycle)

    size = torch.finfo(dtype).bits // 8
    kdh = 8 if size == 4 else 16
    while kdh < dh:
        kdh *= 2
    stride = tile_stride(size, kdh, True)
    stage = 2 * KEY_BLOCK * stride
    blocks = -(-max_len // KEY_BLOCK)
    head = 2 * blocks * KEY_BLOCK * stride * size
    resident = head <= SMEM_LIMIT // 2
    kept = resident and size == 2 and not fast and blocks <= KEPT_BLOCKS and kdh == KEPT_DH
    plan = {"kdh": kdh, "warps": min(MAX_WARPS, -(-max_len // WARP_ROWS)),
            "q_tiles": -(-max_len // TILE_ROWS), "key_blocks": blocks,
            "stride": stride, "stage": stage,
            "bytes": head if resident else FWD_STAGES * stage * size,
            "resident": int(resident), "kept": int(kept)}
    return {**plan, "struct": AttnFwdPlan(**plan)}


def attention_fwd_form(max_len: int, dh: int, dtype: torch.dtype, form: str,
                       fast: bool = False) -> dict | None:
    """``attention_fwd_plan(max_len, dh, dtype, fast)`` in another form, for
    checks that every form gives the same bits: ``"ring"`` (K and V
    streamed) or ``"resident"`` (staged whole, S not kept); None where the
    head's K and V take more than half of ``SMEM_LIMIT``."""
    from fourierdiffusion_tpu_torch.ops.fused_encoder import SMEM_LIMIT  # (import cycle)

    plan = attention_fwd_plan(max_len, dh, dtype, fast)
    size = torch.finfo(dtype).bits // 8
    head = 2 * plan["key_blocks"] * KEY_BLOCK * plan["stride"] * size
    fields = {k: plan[k] for k, _ in AttnFwdPlan._fields_}
    if form == "ring":
        fields.update(resident=0, kept=0, bytes=FWD_STAGES * plan["stage"] * size)
    elif form != "resident":
        raise ValueError(f"no forward form {form!r}")
    elif head > SMEM_LIMIT // 2:
        return None
    else:
        fields.update(resident=1, kept=0, bytes=head)
    return {**fields, "struct": AttnFwdPlan(**fields)}


class AttnBwdPlan(ctypes.Structure):
    """B5/B6-bwd's two launches as the kernels take them (``AttnBwdPlan`` of
    ``csrc/attention_mma.cuh``): the instance's head width, warps per CTA,
    CTAs per head, blocks of 64 rows, the row stride of a staged block, the
    elements of a stage of the ring, launch 2's shared memory in bytes,
    whether launch 1 holds the head's K and V whole and keeps S in
    registers, and launch 1's shared memory in bytes."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kdh", "warps", "tiles", "blocks", "stride", "stage", "bytes", "resident", "kept",
        "dq_bytes")]


# Launch 1 of B5/B6-bwd holds the head's K and V whole in shared memory
# where they take at most half of it (two CTAs to an SM): at dh 16 up to
# L = 1152 in bf16 (past the 896 that JAX's backward serves there) and 704
# in fp32; beyond, they stream through the ring. In bf16, where the keys fit
# in KEPT_BLOCKS blocks (L <= 128) and kdh is 16, each warp also keeps its
# S, then P, in registers for the two later passes (fp32 has one later pass,
# and keeping S there measured no faster than the resident form).


@functools.lru_cache(maxsize=64)
def attention_bwd_plan(max_len: int, dh: int, dtype: torch.dtype = torch.float32) -> dict:
    """B5/B6-bwd's launches at length ``max_len`` and head width ``dh`` in
    ``dtype`` (every chain and head alike). Both take tiles of 128 rows
    (query rows in launch 1, keys in launch 2), a warp per 16 of them (at
    most 8): ``kdh`` (the mma's k step, 8 in fp32 and 16 in bf16, doubled up
    to cover dh), ``warps``, ``tiles``, ``blocks`` (of 64 rows: keys in
    launch 1, query rows in launch 2), the row ``stride`` of a staged block,
    the elements of ``dtype`` of a ``stage`` of the ring (two blocks and 64
    rows of STAT_COLS fp32 statistics), the ring's shared memory in
    ``bytes`` (FWD_STAGES stages, whatever L: launch 2's, and launch 1's
    where it streams), ``resident`` where launch 1 holds the head's K and V
    whole (``2 blocks x 64 x stride`` elements, at most half of
    ``SMEM_LIMIT``), ``kept`` where it also keeps S in registers,
    ``dq_bytes`` launch 1's shared memory, and all of it as ``AttnBwdPlan``
    (``struct``)."""
    from fourierdiffusion_tpu_torch.ops.fused_encoder import SMEM_LIMIT, tile_stride  # (cycle)

    size = torch.finfo(dtype).bits // 8
    kdh = 8 if size == 4 else 16
    while kdh < dh:
        kdh *= 2
    stride = tile_stride(size, kdh, True)
    stage = 2 * KEY_BLOCK * stride + KEY_BLOCK * STAT_COLS * 4 // size
    blocks = -(-max_len // KEY_BLOCK)
    ring = FWD_STAGES * stage * size
    head = 2 * blocks * KEY_BLOCK * stride * size
    resident = head <= SMEM_LIMIT // 2
    kept = resident and size == 2 and blocks <= KEPT_BLOCKS and kdh == KEPT_DH
    plan = {"kdh": kdh, "warps": min(MAX_WARPS, -(-max_len // WARP_ROWS)),
            "tiles": -(-max_len // TILE_ROWS), "blocks": blocks, "stride": stride,
            "stage": stage, "bytes": ring, "resident": int(resident), "kept": int(kept),
            "dq_bytes": head if resident else ring}
    return {**plan, "struct": AttnBwdPlan(**plan)}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, dh), got shape {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; q is "
                f"{tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build and load ``csrc/flash_attention.cu``, with its C signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
    dropout = [p, u, f, i, p]  # seed, threshold, scale, group, stream
    lib.fdiff_attention_fwd.restype = i
    lib.fdiff_attention_fwd.argtypes = [i] + [p] * 4 + [i] * 4 + [f, p] + dropout
    lib.fdiff_attention_bwd.restype = i
    lib.fdiff_attention_bwd.argtypes = [i] + [p] * 9 + [i] * 4 + [f, p] + dropout
    lib.fdiff_attention_dropout_masks.restype = i
    lib.fdiff_attention_dropout_masks.argtypes = [p] + [i] * 3 + dropout
    lib.fdiff_attention_error_string.restype = ctypes.c_char_p
    lib.fdiff_attention_error_string.argtypes = [i]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _library().fdiff_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: {msg}")


def _dims(q: torch.Tensor) -> tuple[int, int, int, int]:
    b, h, l, dh = q.shape
    if dh > MAX_DH:
        raise ValueError(f"kernel takes head dims up to {MAX_DH}, got {dh}")
    return b, h, l, dh


def _dropout_args(q: torch.Tensor, seed: torch.Tensor | None, rate: float) -> list:
    """seed pointer (None: no dropout), threshold, scale, group and stream."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if seed is None:
        return [None, 0, 1.0, 1, stream]
    thr, scale = keep_threshold(rate)
    return [seed.data_ptr(), thr, scale, attention_group(q.shape[1], q.shape[2]), stream]


def _launch_fwd(q, k, v, seed: torch.Tensor | None = None, rate: float = 0.0,
                plan: dict | None = None):
    """B2 (seed None) or B6-fwd on contiguous CUDA tensors, on
    ``attention_fwd_plan`` or the given ``plan`` (another form of it:
    ``attention_fwd_form``)."""
    global launches, fast_launches, dropout_fwd_launches
    b, h, l, dh = _dims(q)
    scale = 1.0 / math.sqrt(dh)
    if _fast(q) and seed is None:
        variant, scale = 2, _bf16_scale(dh)
    else:
        variant = 0 if q.dtype == torch.float32 else 1
    plan = (plan or attention_fwd_plan(l, dh, q.dtype, variant == 2))["struct"]
    out = torch.empty_like(q)
    err = _library().fdiff_attention_fwd(
        variant, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, l, dh, scale, ctypes.byref(plan), *_dropout_args(q, seed, rate),
    )
    _raise_on(err, "attention forward")
    if seed is None:
        launches += 1
        fast_launches += variant == 2
    else:
        dropout_fwd_launches += 1
    return out


def _launch_bwd(q, k, v, o, do, seed: torch.Tensor | None = None, rate: float = 0.0):
    """B5 (seed None) or B6-bwd on contiguous CUDA tensors, from the
    forward's output ``o`` (read in fp32 only: the bf16 kernels recompute
    O): ``(dq, dk, dv, stats)``, stats the rows' (m, l, D) that launch 1
    wrote for launch 2."""
    global bwd_launches, dropout_bwd_launches
    b, h, l, dh = _dims(q)
    fp32 = q.dtype == torch.float32
    o = o.to(q.dtype).contiguous() if fp32 else None
    do = do.to(q.dtype).contiguous()
    plan = attention_bwd_plan(l, dh, q.dtype)["struct"]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((b, h, l, STAT_COLS), dtype=torch.float32, device=q.device)
    err = _library().fdiff_attention_bwd(
        0 if fp32 else 1,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr() if fp32 else None, do.data_ptr(),
        dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, l, dh, 1.0 / math.sqrt(dh),
        ctypes.byref(plan), *_dropout_args(q, seed, rate),
    )
    _raise_on(err, "attention backward")
    if seed is None:
        bwd_launches += 1
    else:
        dropout_bwd_launches += 1
    return dq, dk, dv, stats


def attention_keep_cuda(
    batch: int, n_head: int, max_len: int, seed: torch.Tensor | int, rate: float,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """``attention_keep`` as the CUDA kernels draw it (for checks)."""
    device = torch.device(device)
    out = torch.empty(batch, n_head, max_len, max_len, device=device)
    seed_t = _seed_tensor(seed, device)
    err = _library().fdiff_attention_dropout_masks(
        out.data_ptr(), batch, n_head, max_len, *_dropout_args(out, seed_t, rate))
    _raise_on(err, "attention mask")
    return out


class FlashAttention(torch.autograd.Function):
    """Attention with its backward on CUDA tensors: B2 and B5. Saves q, k, v
    and the output; the backward recomputes P (B5 in fp32 takes D = dO . O
    from the saved output)."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = _launch_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        return _launch_bwd(q, k, v, out, do)[:3]


class FlashAttentionDropout(torch.autograd.Function):
    """Attention with dropout on the weights, and its backward with the mask
    regenerated, on CUDA tensors: B6-fwd and B6-bwd. Saves q, k, v, the
    output and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate: float):
        seed = _seed_tensor(seed, q.device)
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = _launch_fwd(q, k, v, seed, rate)
        ctx.save_for_backward(q, k, v, out, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, seed = ctx.saved_tensors
        return (*_launch_bwd(q, k, v, out, do, seed, ctx.rate)[:3], None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over ``(B, H, L, dh)``, differentiable: the kernels on CUDA
    tensors (``FlashAttention``), the plain versions on CPU tensors
    (``PlainAttention``)."""
    _check(q, k, v)
    return (FlashAttention if q.device.type == "cuda" else PlainAttention).apply(q, k, v)


def flash_attention_dropout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: torch.Tensor | int,
    rate: float,
) -> torch.Tensor:
    """Attention with dropout at ``rate`` on the attention weights, keyed by
    the int32 ``seed``, differentiable in q, k and v: the kernels on CUDA
    tensors (``FlashAttentionDropout``), the plain versions on CPU tensors
    (``PlainAttentionDropout``)."""
    _check(q, k, v)
    keep_threshold(rate)
    fn = FlashAttentionDropout if q.device.type == "cuda" else PlainAttentionDropout
    return fn.apply(q, k, v, seed, float(rate))


__all__ = [
    "FlashAttention",
    "FlashAttentionDropout",
    "PlainAttention",
    "PlainAttentionDropout",
    "attention_bwd_plan",
    "attention_bwd_staged",
    "attention_fwd_form",
    "attention_fwd_plan",
    "attention_group",
    "attention_keep",
    "attention_keep_cuda",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_dropout",
    "flash_attention_dropout_bwd_reference",
    "flash_attention_dropout_reference",
    "flash_attention_reference",
]
