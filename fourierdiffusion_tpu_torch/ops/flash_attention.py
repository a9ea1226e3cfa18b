"""Multi-head attention forward over ``(B, H, L, dh)`` tensors (port of the
forward of ``flash_attention`` in ``fourierdiffusion_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T / sqrt(dh)) v``:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/flash_attention.cu`` and adds one to ``launches``;
* on a CPU tensor it runs ``flash_attention_reference``, the plain PyTorch
  version of the same arithmetic.

Numerics of both, as the TPU kernels: fp32, and bf16 with ``dh >= 16``,
take ``S = (q k^T) * scale`` in fp32 and the exact softmax; bf16 with
``dh < 16`` takes the max-free form (q pre-scaled and rounded to bf16, S
clamped to +-60, exp, reciprocal of the row sum). P is rounded to the
input dtype and ``O = P v`` accumulates in fp32.

Only the forward is ported. The backward (the TPU's ``_bwd_kernel``, ROADMAP
B5) is not, so the wrapper raises when autograd would need it; the unfused
model takes the plain ``dot_product_attention`` whenever a gradient is needed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

SCORE_CLAMP = 60.0
DH_PAD = 16  # the TPU kernels' head padding; the fast form is for dh < 16
MAX_DH = 64  # the CUDA kernel's largest head dim

#: Kernel launches so far in this process; only the CUDA branch of
#: ``flash_attention`` adds to it. Callers reset it to 0 to count a run.
launches = 0


def _fast(q: torch.Tensor) -> bool:
    return q.dtype == torch.bfloat16 and q.shape[-1] < DH_PAD


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` as the TPU wrapper forms it in bf16: the scale is a
    bf16 value and the product is rounded to bf16."""
    s = torch.tensor(scale, dtype=torch.bfloat16).float().item()
    return (q.float() * s).to(torch.bfloat16)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding at the same points."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    if _fast(q):
        s = _prescale(q, scale).float() @ k.float().transpose(-1, -2)
        e = torch.exp(torch.clamp(s, -SCORE_CLAMP, SCORE_CLAMP))
        p = e * (1.0 / e.sum(-1, keepdim=True))
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
    return (p.to(dtype).float() @ v.float()).to(dtype)


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


@functools.cache
def _library() -> ctypes.CDLL:
    """Build and load ``csrc/flash_attention.cu``, with its C signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    lib.fdiff_attention_fwd.restype = ctypes.c_int
    lib.fdiff_attention_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.fdiff_attention_error_string.restype = ctypes.c_char_p
    lib.fdiff_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    b, h, l, dh = q.shape
    if dh > MAX_DH:
        raise ValueError(f"kernel takes head dims up to {MAX_DH}, got {dh}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k and v")
    scale = 1.0 / math.sqrt(dh)
    if _fast(q):
        variant, q = 2, _prescale(q, scale)
    else:
        variant = 0 if q.dtype == torch.float32 else 1
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fdiff_attention_fwd(
        variant, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, l, dh, scale, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"attention kernel failed: {lib.fdiff_attention_error_string(err).decode()}"
        )
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention forward over ``(B, H, L, dh)``: the kernel on a CUDA tensor,
    the plain version on a CPU tensor. Raises if autograd would need its
    gradient: the backward kernel (ROADMAP B5) is not ported."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only: its backward, the TPU's "
            "flash_attention _bwd_kernel (ROADMAP B5), is not ported; use "
            "models.attention.dot_product_attention where a gradient is needed"
        )
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


__all__ = ["flash_attention", "flash_attention_reference"]
