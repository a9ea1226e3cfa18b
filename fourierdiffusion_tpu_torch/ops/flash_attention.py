"""Multi-head attention over ``(B, H, L, dh)`` tensors, forward and backward,
with and without dropout on the attention weights (port of
``fourierdiffusion_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T / sqrt(dh)) v`` and is
differentiable (``FlashAttention``):

* on CUDA tensors the forward launches the hand-written kernel B2 (on the
  tensor cores, ``attention_fwd_plan``) and the backward the kernel B5
  (``csrc/flash_attention.cu``); ``launches`` and ``bwd_launches`` count
  them;
* on CPU tensors it runs ``flash_attention_reference`` and, for the
  gradient, ``flash_attention_bwd_reference``, the plain PyTorch versions.

``flash_attention_dropout(q, k, v, seed, rate)`` (``FlashAttentionDropout``)
is the same with dropout on the normalised attention weights: the kernels
B6-fwd and B6-bwd (``dropout_fwd_launches``, ``dropout_bwd_launches``), or
``flash_attention_dropout_reference`` and ``..._bwd_reference``. Its mask is
``attention_keep``: the TPU kernels' interpret-mode hash at tag
``seed + chain*131071 + g0`` (uint32), g0 the first head of the head group
(``attention_group``, the same in forward and backward), so the kernels,
the plain versions and the JAX package in interpret mode draw bit-identical
masks. ``seed`` is an int or an integer tensor on the inputs' device (read
there by the kernels, so drawing it does not synchronise).

Numerics, as the TPU kernels: fp32, and bf16 with ``dh >= 16``, take
``S = (q k^T) * scale`` in fp32 and the exact softmax; bf16 with
``dh < 16`` takes the max-free forward (q pre-scaled and rounded to bf16, S
clamped to +-60, exp, reciprocal of the row sum). P is rounded to the
input dtype and ``O = P v`` accumulates in fp32. The backward recomputes P
with the exact softmax in fp32. The kernels of the backward and of the
dropout forward are fp32 only: a bf16 tensor on the card raises there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fourierdiffusion_tpu_torch.ops.dropout_hash import (
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
SMEM_LIMIT = 232448  # bytes of shared memory a block can opt into on sm_90

#: Kernel launches so far in this process; only the CUDA branches add to
#: them (B2, B5, B6-fwd, B6-bwd). Callers reset them to 0 to count a run.
launches = 0
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
    key = (_seed_tensor(seed, device) + chain[:, None] * 131071 + g0[None, :]) & M32
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


# ---- the kernels ---------------------------------------------------------------------


class AttnFwdPlan(ctypes.Structure):
    """B2's launch as the kernel takes it (``AttnFwdPlan`` of
    ``csrc/flash_attention.cu``): the instance's head width, warps per CTA,
    CTAs per head, key blocks, the row stride of a staged block, the
    elements of a stage of the ring and the shared memory in bytes."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kdh", "warps", "q_tiles", "key_blocks", "stride", "stage", "bytes")]


@functools.lru_cache(maxsize=64)
def attention_fwd_plan(max_len: int, dh: int, dtype: torch.dtype) -> dict:
    """B2's launch at length ``max_len`` and head width ``dh`` in ``dtype``
    (for every chain and head alike): the head width of the instance
    (``kdh``: the mma's k step, 8 in fp32 and 16 in bf16, doubled up to
    cover dh), the warps of a CTA (one per 16 query rows of the first tile,
    at most 8), the CTAs per head (tiles of 128 query rows), the key blocks
    of 64, the row stride of a staged K or V block, the elements of a stage
    of the ring (a block of K and one of V), the shared memory (FWD_STAGES
    stages, whatever L) and all of it as ``AttnFwdPlan`` (``struct``)."""
    from fourierdiffusion_tpu_torch.ops.fused_encoder import tile_stride  # (import cycle)

    size = torch.finfo(dtype).bits // 8
    kdh = 8 if size == 4 else 16
    while kdh < dh:
        kdh *= 2
    stride = tile_stride(size, kdh, True)
    stage = 2 * KEY_BLOCK * stride
    plan = {"kdh": kdh, "warps": min(MAX_WARPS, -(-max_len // WARP_ROWS)),
            "q_tiles": -(-max_len // TILE_ROWS), "key_blocks": -(-max_len // KEY_BLOCK),
            "stride": stride, "stage": stage, "bytes": FWD_STAGES * stage * size}
    return {**plan, "struct": AttnFwdPlan(**plan)}


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
    lib.fdiff_attention_bwd.argtypes = [p] * 7 + [i] * 4 + [f] + dropout
    lib.fdiff_attention_dropout_masks.restype = i
    lib.fdiff_attention_dropout_masks.argtypes = [p] + [i] * 3 + dropout
    lib.fdiff_attention_bwd_smem_bytes.restype = i
    lib.fdiff_attention_bwd_smem_bytes.argtypes = [i, i]
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


def _fp32_only(q: torch.Tensor, what: str) -> None:
    if q.dtype != torch.float32:
        raise ValueError(f"the {what} kernel is fp32 only, got {q.dtype}")


def _launch_fwd(q, k, v, seed: torch.Tensor | None = None, rate: float = 0.0):
    """B2 (seed None) or B6-fwd on contiguous CUDA tensors."""
    global launches, dropout_fwd_launches
    b, h, l, dh = _dims(q)
    scale = 1.0 / math.sqrt(dh)
    if seed is not None:
        _fp32_only(q, "dropout attention")
        variant = 0
    elif _fast(q):
        variant, scale = 2, _bf16_scale(dh)
    else:
        variant = 0 if q.dtype == torch.float32 else 1
    plan = None if seed is not None else attention_fwd_plan(l, dh, q.dtype)["struct"]
    lib = _library()
    out = torch.empty_like(q)
    err = lib.fdiff_attention_fwd(
        variant, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, l, dh, scale, None if plan is None else ctypes.byref(plan),
        *_dropout_args(q, seed, rate),
    )
    _raise_on(err, "attention forward")
    if seed is None:
        launches += 1
    else:
        dropout_fwd_launches += 1
    return out


def _launch_bwd(q, k, v, do, seed: torch.Tensor | None = None, rate: float = 0.0):
    """B5 (seed None) or B6-bwd on contiguous CUDA tensors: ``(dq, dk, dv)``."""
    global bwd_launches, dropout_bwd_launches
    _fp32_only(q, "attention backward")
    b, h, l, dh = _dims(q)
    do = do.to(q.dtype).contiguous()
    lib = _library()
    if lib.fdiff_attention_bwd_smem_bytes(l, dh) > SMEM_LIMIT:
        raise ValueError(f"L={l}, dh={dh} needs too much shared memory for the backward")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = lib.fdiff_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, l, dh, 1.0 / math.sqrt(dh),
        *_dropout_args(q, seed, rate),
    )
    _raise_on(err, "attention backward")
    if seed is None:
        bwd_launches += 1
    else:
        dropout_bwd_launches += 1
    return dq, dk, dv


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
    """Attention with its backward: B2 and B5 on CUDA tensors, the plain
    versions on CPU tensors. Saves q, k and v; the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cuda":
            q, k, v = (t.contiguous() for t in (q, k, v))
            out = _launch_fwd(q, k, v)
        else:
            out = flash_attention_reference(q, k, v)
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cuda":
            return _launch_bwd(q, k, v, do)
        return flash_attention_bwd_reference(q, k, v, do)


class FlashAttentionDropout(torch.autograd.Function):
    """Attention with dropout on the weights, and its backward with the mask
    regenerated: B6-fwd and B6-bwd on CUDA tensors, the plain versions on CPU
    tensors. Saves q, k, v and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate: float):
        seed = _seed_tensor(seed, q.device)
        if q.device.type == "cuda":
            q, k, v = (t.contiguous() for t in (q, k, v))
            out = _launch_fwd(q, k, v, seed, rate)
        else:
            out = flash_attention_dropout_reference(q, k, v, seed, rate)
        ctx.save_for_backward(q, k, v, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = _launch_bwd(q, k, v, do, seed, ctx.rate)
        else:
            grads = flash_attention_dropout_bwd_reference(q, k, v, do, seed, ctx.rate)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over ``(B, H, L, dh)``, differentiable: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v)


def flash_attention_dropout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: torch.Tensor | int,
    rate: float,
) -> torch.Tensor:
    """Attention with dropout at ``rate`` on the attention weights, keyed by
    the int32 ``seed``, differentiable in q, k and v: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""
    _check(q, k, v)
    keep_threshold(rate)
    return FlashAttentionDropout.apply(q, k, v, seed, float(rate))


__all__ = [
    "FlashAttention",
    "FlashAttentionDropout",
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
