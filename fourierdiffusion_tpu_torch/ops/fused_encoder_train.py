"""One post-LN encoder layer in training mode, forward and backward (port of
``fourierdiffusion_tpu/ops/fused_encoder_train.py``), fp32.

``fused_encoder_layer_train(x, layer, seed, n_head=, rate=)`` runs the layer
over activations ``(B, L, D)`` with dropout at four sites (attention
probabilities, attention output, FFN hidden layer, FFN output) and is
differentiable in ``x`` and the packed weights:

* on a CUDA tensor it applies ``FusedEncoderLayerTrain``: the forward
  launches the hand-written kernel B3 and the backward the kernel B4
  (``csrc/fused_encoder_train.cu``), which recomputes the forward from
  ``x``, regenerates the masks and returns ``dx`` and the 12 weight
  gradients; ``fwd_launches`` and ``bwd_launches`` count them;
* on a CPU tensor it runs ``fused_encoder_layer_train_reference``, the
  plain PyTorch version, and autograd through it is the plain backward.

The masks are ``keep / (1 - rate)`` from ``hash_bits``, the murmur3
finalizer of the TPU kernel's interpret mode, at the TPU kernel's site
coordinates (``dropout_masks``), so the kernels, the plain version and the
JAX package in interpret mode draw bit-identical masks. ``pack_encoder_layer_train``
packs a layer's parameters with differentiable operations, so autograd
carries the packed-weight gradients back to the module's parameters.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from fourierdiffusion_tpu_torch.models.transformer import LN_EPS, TransformerEncoderLayer
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops.dropout_hash import (
    C0,
    C1,
    M32,
    hash_bits,
    head_group,
    head_positions,
    keep_scale,
    keep_threshold,
    lanes,
    mul32,
)

SITE_ATTN, SITE_OUT, SITE_FF, SITE_FF2 = 0, 1, 2, 3

LAYER_KEYS = fe._LAYER_KEYS  # the packed layout is the sampling kernel's

#: Kernel launches so far in this process; only the CUDA branch adds to
#: them (B3 once per forward, B4 once per backward, its reduction included).
fwd_launches = 0
bwd_launches = 0


# ---- head groups and dropout masks ---------------------------------------------


def train_group(n_head: int, max_len: int) -> int:
    """Heads per group of the training kernels: one group of 12 at L=100,
    two of 6 at L=187, three of 4 at L=365."""
    return head_group(n_head, lanes(max_len), live_bytes_per_elem=24)


def mask_key(seed: int, chain: torch.Tensor, site: int, extra=0) -> torch.Tensor:
    """``seed + chain*131071 + site*7919 + extra*104729`` wrapped to uint32."""
    return (seed + chain * 131071 + site * 7919 + extra * 104729) & M32


def dropout_masks(
    batch: int, max_len: int, d_model: int, d_ff: int, n_head: int, seed: int,
    rate: float, device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """The four masks (``keep / (1 - rate)``, fp32) in the port's layouts:
    ``attn`` (B, H, L, L), ``out`` and ``ff2`` (B, L, D), ``ff`` (B, L, F).

    Position (b, l, d) of the OUT/FF2 sites is the TPU kernel's (d, l) of
    program b; (b, l, f) of FF its (f, l); (b, h, i, j) of ATTN its (g, i, j)
    of head group g0 = h - h % group, with g = h - g0.
    """
    i64 = dict(dtype=torch.int64, device=device)
    chain = torch.arange(batch, **i64)
    pos = torch.arange(max_len, **i64)

    def site_2d(n_cols: int, site: int) -> torch.Tensor:
        row = mul32(mul32(torch.arange(n_cols, **i64), C0), C1)  # (N,)
        idx = (row[None, :] + pos[:, None]) & M32  # (L, N)
        key = mask_key(seed, chain, site)[:, None, None]
        return keep_scale(hash_bits(idx[None], key), rate)

    idx, g0 = head_positions(n_head, max_len, train_group(n_head, max_len), device)
    key = mask_key(seed, chain[:, None], SITE_ATTN, g0[None, :])  # (B, H)
    return {
        "attn": keep_scale(hash_bits(idx[None], key[:, :, None, None]), rate),
        "out": site_2d(d_model, SITE_OUT),
        "ff": site_2d(d_ff, SITE_FF),
        "ff2": site_2d(d_model, SITE_FF2),
    }


# ---- packing and the plain version --------------------------------------------------


def pack_encoder_layer_train(
    layer: TransformerEncoderLayer, n_head: int
) -> dict[str, torch.Tensor]:
    """Pack one layer's parameters for the training kernels, with
    differentiable operations and in the parameters' dtype (fp32; fp64 only
    for reference computations): matrices ``(in, out)`` row-major, the q
    columns of the QKV weight and bias scaled by ``1/sqrt(dh)``."""
    d_model = layer.norm1.weight.shape[0]
    w_in = layer.self_attn.in_proj_weight
    col_scale = torch.ones(3 * d_model, dtype=w_in.dtype, device=w_in.device)
    col_scale[:d_model] = 1.0 / math.sqrt(d_model // n_head)
    w_in = w_in * col_scale[:, None]  # (3D, D)
    b_in = layer.self_attn.in_proj_bias * col_scale

    def mat(w: torch.Tensor) -> torch.Tensor:  # (out, in) -> (in, out)
        return w.t().contiguous()

    def vec(v: torch.Tensor) -> torch.Tensor:
        return v.contiguous()

    return {
        "w_qkv": mat(w_in),
        "b_qkv": vec(b_in),
        "w_out": mat(layer.self_attn.out_proj.weight),
        "b_out": vec(layer.self_attn.out_proj.bias),
        "ln1_s": vec(layer.norm1.weight),
        "ln1_b": vec(layer.norm1.bias),
        "w1": mat(layer.linear1.weight),
        "b1": vec(layer.linear1.bias),
        "w2": mat(layer.linear2.weight),
        "b2": vec(layer.linear2.bias),
        "ln2_s": vec(layer.norm2.weight),
        "ln2_b": vec(layer.norm2.bias),
    }


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPS)


def fused_encoder_layer_train_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], seed: int, *, n_head: int,
    rate: float,
) -> torch.Tensor:
    """Plain PyTorch version of the training layer (fp32), with the same masks."""
    b, l, d = x.shape
    masks = dropout_masks(b, l, d, layer["w1"].shape[1], n_head, seed, rate, x.device)
    x1 = attention_sublayer(x, layer, masks, n_head)
    return ffn_sublayer(x1, torch.relu(x1 @ layer["w1"] + layer["b1"]), layer, masks)


def attention_sublayer(
    x: torch.Tensor, layer: dict[str, torch.Tensor], masks: dict[str, torch.Tensor],
    n_head: int,
) -> torch.Tensor:
    """The plain version up to LN1: ``x1 = LN1(x + drop(attention(x)))``."""
    b, l, d = x.shape
    dh = d // n_head
    qkv = x @ layer["w_qkv"] + layer["b_qkv"]
    q, k, v = (t.reshape(b, l, n_head, dh).transpose(1, 2) for t in qkv.split(d, -1))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = ((p * masks["attn"]) @ v).transpose(1, 2).reshape(b, l, d)
    a = x + (o @ layer["w_out"] + layer["b_out"]) * masks["out"]
    return _ln(a, layer["ln1_s"], layer["ln1_b"])


def ffn_sublayer(
    x1: torch.Tensor, hidden: torch.Tensor, layer: dict[str, torch.Tensor],
    masks: dict[str, torch.Tensor],
) -> torch.Tensor:
    """The plain version after the FFN's ReLU: ``hidden`` is
    ``relu(x1 W1 + b1)``; returns ``LN2(x1 + drop(drop(hidden) W2 + b2))``."""
    f2 = (hidden * masks["ff"]) @ layer["w2"] + layer["b2"]
    return _ln(x1 + f2 * masks["ff2"], layer["ln2_s"], layer["ln2_b"])


# ---- the kernels ----------------------------------------------------------------------


def _check(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> None:
    """fp32 only; then the sampling layer's checks of shapes, dtypes and devices."""
    if x.dtype != torch.float32:
        raise ValueError(f"the training layer is fp32 only, got x of {x.dtype}")
    fe._check(x, layer, n_head)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build and load ``csrc/fused_encoder_train.cu``, with its C signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library("fused_encoder_train")
    i, u, p, f = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_float
    dropout = [i, u, u, f, p]  # group, seed, threshold, scale, stream
    lib.fdiff_train_fwd.argtypes = [p, p, p, p] + [i] * 5 + dropout
    lib.fdiff_train_bwd.argtypes = [p] * 7 + [i] * 5 + dropout
    lib.fdiff_dropout_masks.argtypes = [p] * 4 + [i] * 5 + dropout
    for name in ("fdiff_train_fwd", "fdiff_train_bwd", "fdiff_dropout_masks"):
        getattr(lib, name).restype = i
    for name in ("fdiff_train_fwd_smem_bytes", "fdiff_train_fwd_kv_floats",
                 "fdiff_train_bwd_smem_bytes", "fdiff_train_bwd_workspace_floats",
                 "fdiff_train_grad_floats"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i, i]
    lib.fdiff_train_error_string.restype = ctypes.c_char_p
    lib.fdiff_train_error_string.argtypes = [i]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().fdiff_train_error_string(err).decode()}")


def _dims(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> tuple:
    b, l, d = x.shape
    if d % 4:
        raise ValueError(f"kernel needs d_model divisible by 4, got {d}")
    if b > 65535:
        raise ValueError(f"kernel takes at most 65535 chains per launch, got {b}")
    if not all(t.is_contiguous() for t in [x, *layer.values()]):
        raise ValueError("fused_encoder_layer_train needs contiguous tensors")
    return b, l, d, n_head, layer["w1"].shape[1], train_group(n_head, l)


def _dropout_args(seed: int, rate: float, x: torch.Tensor) -> list:
    thr, scale = keep_threshold(rate)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return [seed & M32, thr, scale, stream]


def _weight_ptrs(layer: dict[str, torch.Tensor]):
    return (ctypes.c_void_p * len(LAYER_KEYS))(*(layer[k].data_ptr() for k in LAYER_KEYS))


def _launch_fwd(x, layer, seed: int, n_head: int, rate: float) -> torch.Tensor:
    global fwd_launches
    b, l, d, h, f, group = _dims(x, layer, n_head)
    lib = _library()
    if lib.fdiff_train_fwd_smem_bytes(l, d) > fe.SMEM_LIMIT:
        raise ValueError(f"L={l}, D={d} needs too much shared memory for the forward")
    out = torch.empty_like(x)
    kv = fe.kv_workspace(lib.fdiff_train_fwd_kv_floats(l, d), x)
    err = lib.fdiff_train_fwd(
        x.data_ptr(), _weight_ptrs(layer), out.data_ptr(), fe.data_ptr(kv), b, l, d, h, f,
        group,
        *_dropout_args(seed, rate, x),
    )
    _raise_on(err, "training forward kernel")
    fwd_launches += 1
    return out


def _launch_bwd(x, dy, layer, seed: int, n_head: int, rate: float):
    global bwd_launches
    b, l, d, h, f, group = _dims(x, layer, n_head)
    dy = dy.contiguous()
    lib = _library()
    if lib.fdiff_train_bwd_smem_bytes(l, d) > fe.SMEM_LIMIT:
        raise ValueError(f"L={l}, D={d} needs too much shared memory for the backward")
    n_grad = lib.fdiff_train_grad_floats(d, f)
    workspace = torch.empty(b, lib.fdiff_train_bwd_workspace_floats(l, d), device=x.device)
    partials = torch.empty(b, n_grad, device=x.device)
    grads = torch.empty(n_grad, device=x.device)
    dx = torch.empty_like(x)
    err = lib.fdiff_train_bwd(
        x.data_ptr(), dy.data_ptr(), _weight_ptrs(layer), dx.data_ptr(),
        partials.data_ptr(), workspace.data_ptr(), grads.data_ptr(),
        b, l, d, h, f, group, *_dropout_args(seed, rate, x),
    )
    _raise_on(err, "training backward kernel")
    bwd_launches += 1
    views, offset = [], 0
    for key in LAYER_KEYS:
        n = layer[key].numel()
        views.append(grads[offset : offset + n].view(layer[key].shape))
        offset += n
    return dx, views


def dropout_masks_cuda(
    batch: int, max_len: int, d_model: int, d_ff: int, n_head: int, seed: int,
    rate: float, device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """``dropout_masks`` as the CUDA kernels draw them (for checks)."""
    lib = _library()
    out = {
        "attn": torch.empty(batch, n_head, max_len, max_len, device=device),
        "out": torch.empty(batch, max_len, d_model, device=device),
        "ff": torch.empty(batch, max_len, d_ff, device=device),
        "ff2": torch.empty(batch, max_len, d_model, device=device),
    }
    ref = out["out"]
    err = lib.fdiff_dropout_masks(
        *(out[k].data_ptr() for k in ("attn", "out", "ff", "ff2")),
        batch, max_len, d_model, n_head, d_ff, train_group(n_head, max_len),
        *_dropout_args(seed, rate, ref),
    )
    _raise_on(err, "dropout mask kernel")
    return out


class FusedEncoderLayerTrain(torch.autograd.Function):
    """The training layer on the card: B3 forward, B4 backward. The forward
    saves only ``x``, the weights and the seed; the backward recomputes."""

    @staticmethod
    def forward(ctx, x, seed: int, n_head: int, rate: float, *weights):
        layer = dict(zip(LAYER_KEYS, weights))
        ctx.save_for_backward(x, *weights)
        ctx.seed, ctx.n_head, ctx.rate = seed, n_head, rate
        return _launch_fwd(x, layer, seed, n_head, rate)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        layer = dict(zip(LAYER_KEYS, weights))
        dx, grads = _launch_bwd(x, dy, layer, ctx.seed, ctx.n_head, ctx.rate)
        return (dx, None, None, None, *grads)


def fused_encoder_layer_train(
    x: torch.Tensor, layer: dict[str, torch.Tensor], seed: int, *, n_head: int,
    rate: float,
) -> torch.Tensor:
    """One training layer over ``(B, L, D)``: the kernels on a CUDA tensor,
    the plain version on a CPU tensor. ``seed`` is the layer's int32 seed."""
    _check(x, layer, n_head)
    keep_threshold(rate)
    if x.device.type == "cuda":
        return FusedEncoderLayerTrain.apply(
            x, int(seed), n_head, float(rate), *(layer[k] for k in LAYER_KEYS)
        )
    if x.device.type == "cpu":
        return fused_encoder_layer_train_reference(x, layer, int(seed), n_head=n_head, rate=rate)
    raise ValueError(f"fused_encoder_layer_train runs on cuda or cpu, not {x.device}")


__all__ = [
    "FusedEncoderLayerTrain",
    "attention_sublayer",
    "dropout_masks",
    "dropout_masks_cuda",
    "ffn_sublayer",
    "fused_encoder_layer_train",
    "fused_encoder_layer_train_reference",
    "hash_bits",
    "pack_encoder_layer_train",
    "train_group",
]
