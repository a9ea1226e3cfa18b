"""The hashed dropout masks that the TPU kernels draw in interpret mode,
shared by the attention kernels (``ops/flash_attention.py``) and the
training layer (``ops/fused_encoder_train.py``).

A mask entry is ``keep / (1 - rate)`` with ``keep = hash_bits(idx, tag) <
keep_threshold(rate)``: ``hash_bits`` is the murmur3 finalizer of
``fourierdiffusion_tpu/ops/flash_attention.py::_hash_bits``, ``idx`` the
position in the TPU kernel's own coordinates and ``tag`` a per-(chain,
site, head group) key. The uint32 arithmetic is done in int64 with a split
32-bit multiply, so every value stays exact.

Every key is ``seed + chain*131071 + ...``, so a rank that holds chains
``c0, c0+1, ...`` of a larger batch draws the masks of those global chains
with the seed ``shift_seed(seed, c0)``.
"""

from __future__ import annotations

import torch

LANE = 128
_VMEM_BUDGET = 14 * 1024 * 1024
M32 = 0xFFFFFFFF
C0, C1 = 1000003, 19349663
CHAIN_STRIDE = 131071  # a mask key's step from one chain to the next


def head_group(n_head: int, lp: int, live_bytes_per_elem: int) -> int:
    """Largest divisor of ``n_head`` whose ``(g, Lp, Lp)`` fp32 intermediates
    fit the TPU kernel's VMEM budget (a copy of ``_head_group``): the mask
    of an attention site is keyed per head group."""
    g = n_head
    while g > 1 and g * lp * lp * live_bytes_per_elem > _VMEM_BUDGET:
        g -= 1
        while g > 1 and n_head % g:
            g -= 1
    return max(g, 1)


def lanes(max_len: int) -> int:
    """``max_len`` rounded up to the TPU's 128 lanes (its padded Lp)."""
    return -(-max_len // LANE) * LANE


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def hash_bits(idx: torch.Tensor, key: torch.Tensor | int) -> torch.Tensor:
    """The TPU kernel's murmur3 finalizer, on uint32 values held in int64."""
    x = idx ^ key
    x = mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> tuple[int, float]:
    """Keep where the bits are below the threshold; kept values are scaled."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int((1.0 - rate) * (2**32 - 1)), 1.0 / (1.0 - rate)


def keep_scale(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """``1 / (1 - rate)`` (fp32) where ``bits`` keep, else 0."""
    thr, scale = keep_threshold(rate)
    kept = torch.tensor(scale, dtype=torch.float32, device=bits.device)
    return torch.where(bits < thr, kept, torch.zeros((), device=bits.device))


def shift_seed(seed: torch.Tensor | int, first_chain: int) -> torch.Tensor | int:
    """``seed`` for the chains that start at global chain ``first_chain``:
    ``(seed + first_chain*131071) mod 2**32``, so local chain c keys its
    masks as global chain ``first_chain + c`` does. Unchanged at 0."""
    if first_chain == 0:
        return seed
    return (seed + first_chain * CHAIN_STRIDE) & M32


def head_positions(
    n_head: int, max_len: int, group: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of an attention site, ``(H, L, L)``: head h's (i, j) is the
    TPU kernel's (g, i, j) of the head group that starts at g0 = h - h %
    group, with g = h - g0. Returns the positions and g0 ``(H,)``."""
    i64 = dict(dtype=torch.int64, device=device)
    head = torch.arange(n_head, **i64)
    pos = torch.arange(max_len, **i64)
    g, g0 = head % group, head - head % group
    gi = (mul32(mul32(g, C0), C1)[:, None] + pos[None, :]) & M32  # (H, L)
    return (mul32(gi, C1)[:, :, None] + pos[None, None, :]) & M32, g0


__all__ = [
    "head_group",
    "head_positions",
    "hash_bits",
    "keep_scale",
    "keep_threshold",
    "lanes",
    "mul32",
    "shift_seed",
]
