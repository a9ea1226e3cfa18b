"""One post-LN encoder layer in training mode, forward and backward (port of
``fourierdiffusion_tpu/ops/fused_encoder_train.py``), fp32 and bf16.

``fused_encoder_layer_train(x, layer, seed, n_head=, rate=)`` runs the layer
over activations ``(B, L, D)`` with dropout at four sites (attention
probabilities, attention output, FFN hidden layer, FFN output) and is
differentiable in ``x`` and the packed weights:

* on a CUDA tensor it applies ``FusedEncoderLayerTrain``: the forward
  launches the hand-written kernels of B3 and the backward those of B4
  (``csrc/fused_encoder_train.cuh``, built for fp32 from
  ``csrc/fused_encoder_train.cu`` and for bf16 from
  ``csrc/fused_encoder_train_bf16.cu``, over all B*L rows on the tensor cores:
  B3 in 4 launches, 7 for layers wider than 256, ``train_fwd_plan``; B4 in
  17, or 20, ``train_bwd_plan``; their attention stages are
  ``csrc/attention_mma.cuh``'s kernels, B2's and B5's over the packed qkv,
  on those kernels' plans, ``attention_launches``, for head widths up to
  64), which recompute the forward from ``x``
  with B3's launches on B3's plan, regenerate the masks and return ``dx``
  and the 12 weight gradients; ``fwd_launches`` and ``bwd_launches`` count
  one per call;
* on a CPU tensor it runs ``fused_encoder_layer_train_reference``, the
  plain PyTorch version: in fp32 autograd through it is the plain backward;
  in bf16 its backward is ``train_backward_staged``, which rounds where the
  TPU kernel rounds.

Numerics in bf16 are the TPU kernel's: x, the packed weight matrices and the
output in bf16, every product on bf16 operands with fp32 sums, P times its
keep factor rounded to bf16 before P V, LayerNorm and softmax in fp32, the
residual around the FFN (LN1's output) in fp32; the backward recomputes the
forward, rounds dO, P keep, dS and every other product operand to bf16,
sums the weight gradients in fp32 and rounds each to its packed weight's
dtype (bf16 for the four matrices, fp32 for the vectors), and returns dx in
bf16.

``train_backward_staged`` is a plain PyTorch backward that follows B4's
stages and sums (row slices, then their partials in slice order); the tests
and ``chip_smoke.py`` hold B4's stages to it.

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
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops.dropout_hash import (
    C0,
    C1,
    CHAIN_STRIDE,
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
    return (seed + chain * CHAIN_STRIDE + site * 7919 + extra * 104729) & M32


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
    layer: TransformerEncoderLayer, n_head: int, dtype: torch.dtype | None = None
) -> dict[str, torch.Tensor]:
    """Pack one layer's parameters for the training kernels, with
    differentiable operations: matrices ``(in, out)`` row-major in ``dtype``
    (default: the parameters' dtype; bf16 casts of the fp32 parameters for a
    bf16 model, as JAX packs them), the vectors in the parameters' dtype
    (fp32; fp64 only for reference computations), the q columns of the QKV
    weight and bias scaled by ``1/sqrt(dh)`` before any cast."""
    d_model = layer.norm1.weight.shape[0]
    w_in = layer.self_attn.in_proj_weight
    col_scale = torch.ones(3 * d_model, dtype=w_in.dtype, device=w_in.device)
    col_scale[:d_model] = 1.0 / math.sqrt(d_model // n_head)
    w_in = w_in * col_scale[:, None]  # (3D, D)
    b_in = layer.self_attn.in_proj_bias * col_scale

    def mat(w: torch.Tensor) -> torch.Tensor:  # (out, in) -> (in, out)
        return w.t().to(dtype or w.dtype).contiguous()

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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain version computes in: fp32 for bf16 activations
    (bf16 products are exact in fp32 and summed there), else the dtype."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _rounder(dtype: torch.dtype):
    """``t -> t`` rounded to ``dtype`` and back to ``_acc(dtype)``: where the
    TPU kernel casts to the activation dtype (nothing in fp32 or fp64)."""
    acc = _acc(dtype)
    return lambda t: t.to(dtype).to(acc)


def fused_encoder_layer_train_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], seed: int, *, n_head: int,
    rate: float, gates: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the training layer, with the same masks. In
    bf16 its backward is ``train_backward_staged`` (``PlainTrainLayer``),
    with the TPU kernel's roundings; in fp32 (and fp64) autograd through it.
    ``gates`` (B, L, F), if given, are the FFN's ReLU gates to take instead
    of ``pre > 0`` (``chip_smoke.py``'s check, with a kernel's gates)."""
    if x.dtype == torch.bfloat16:
        return PlainTrainLayer.apply(x, int(seed), n_head, float(rate), gates,
                                     *(layer[k] for k in LAYER_KEYS))
    return _reference_forward(x, layer, seed, n_head, rate, gates)


def _reference_forward(x, layer, seed: int, n_head: int, rate: float,
                       gates: torch.Tensor | None = None) -> torch.Tensor:
    b, l, d = x.shape
    rnd = _rounder(x.dtype)
    masks = dropout_masks(b, l, d, layer["w1"].shape[1], n_head, seed, rate, x.device)
    x1 = attention_sublayer(x, layer, masks, n_head)
    pre = rnd(x1) @ layer["w1"].to(x1.dtype) + layer["b1"]
    hidden = torch.relu(pre) if gates is None else pre * gates
    return ffn_sublayer(x1, hidden, layer, masks).to(x.dtype)


def attention_sublayer(
    x: torch.Tensor, layer: dict[str, torch.Tensor], masks: dict[str, torch.Tensor],
    n_head: int,
) -> torch.Tensor:
    """The plain version up to LN1: ``x1 = LN1(x + drop(attention(x)))``, in
    ``_acc(x.dtype)`` (unrounded, as the residual around the FFN)."""
    b, l, d = x.shape
    dh = d // n_head
    acc, rnd = _acc(x.dtype), _rounder(x.dtype)
    xa = x.to(acc)
    qkv = rnd(xa @ layer["w_qkv"].to(acc) + layer["b_qkv"])
    q, k, v = (t.reshape(b, l, n_head, dh).transpose(1, 2) for t in qkv.split(d, -1))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = rnd(rnd(p * masks["attn"]) @ v).transpose(1, 2).reshape(b, l, d)
    a = xa + (o @ layer["w_out"].to(acc) + layer["b_out"]) * masks["out"]
    return _ln(a, layer["ln1_s"], layer["ln1_b"])


def ffn_sublayer(
    x1: torch.Tensor, hidden: torch.Tensor, layer: dict[str, torch.Tensor],
    masks: dict[str, torch.Tensor],
) -> torch.Tensor:
    """The plain version after the FFN's ReLU: ``hidden`` is
    ``relu(x1 W1 + b1)``; returns ``LN2(x1 + drop(drop(hidden) W2 + b2))``
    in x1's dtype, the dropped hidden layer rounded to the dtype of W2."""
    hd = (hidden * masks["ff"]).to(layer["w2"].dtype).to(x1.dtype)
    f2 = hd @ layer["w2"].to(x1.dtype) + layer["b2"]
    return _ln(x1 + f2 * masks["ff2"], layer["ln2_s"], layer["ln2_b"])


# ---- the kernels ----------------------------------------------------------------------


#: The activation dtypes of the training layer and the sources of their kernels.
DTYPES = {torch.float32: "fused_encoder_train", torch.bfloat16: "fused_encoder_train_bf16"}


def _check(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> None:
    """float32 or bfloat16; then the sampling layer's checks of shapes,
    dtypes (the matrices in x's dtype, the vectors fp32) and devices."""
    if x.dtype not in DTYPES:
        raise ValueError(f"the training layer takes float32 or bfloat16, got x of {x.dtype}")
    fe._check(x, layer, n_head)


@functools.cache
def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """Build and load the kernels of ``dtype`` (``DTYPES``: one library per
    activation dtype, with the same C functions; the fp32 one also holds the
    dropout masks, the gradient size and B4's stage count), with their C
    signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library(DTYPES[dtype])
    i, u, p, f = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_float
    dropout = [i, u, u, f, p]  # group, seed, threshold, scale, stream
    lib.fdiff_train_fwd.argtypes = [p, p, p, p, ctypes.POINTER(FwdPlan)] + [i] * 5 + dropout
    lib.fdiff_train_bwd.argtypes = [p] * 6 + [ctypes.POINTER(BwdPlan)] + [i] * 6 + [u, u, f, p, p]
    for name in ("fdiff_train_fwd", "fdiff_train_bwd"):
        getattr(lib, name).restype = i
    lib.fdiff_train_error_string.restype = ctypes.c_char_p
    lib.fdiff_train_error_string.argtypes = [i]
    if dtype == torch.float32:
        lib.fdiff_dropout_masks.argtypes = [p] * 4 + [i] * 5 + dropout
        lib.fdiff_dropout_masks.restype = i
        lib.fdiff_train_grad_floats.restype = i
        lib.fdiff_train_grad_floats.argtypes = [i, i]
        lib.fdiff_train_bwd_stages.restype = i
        lib.fdiff_train_bwd_stages.argtypes = []
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
    if d // n_head > fa.MAX_DH:
        raise ValueError(f"kernel takes head dims up to {fa.MAX_DH}, got {d // n_head}")
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
    """B3 on contiguous CUDA tensors: its launches on ``train_fwd_plan``."""
    global fwd_launches
    b, l, d, h, f, group = _dims(x, layer, n_head)
    lib = _library(x.dtype)
    plan = train_fwd_plan(b, l, d, h, f, fe.sm_count(x.device), x.dtype)
    workspace = torch.empty(plan["workspace_floats"], device=x.device)
    out = torch.empty_like(x)
    err = lib.fdiff_train_fwd(
        x.data_ptr(), _weight_ptrs(layer), out.data_ptr(), workspace.data_ptr(),
        ctypes.byref(plan["struct"]), b, l, d, h, f, group, *_dropout_args(seed, rate, x),
    )
    _raise_on(err, "training forward kernels")
    fwd_launches += 1
    return out


# ---- the forward's plan ----------------------------------------------------------------

#: Workspace regions of the forward, in floats, in the kernel's order
#: (``FwdPlan``): qkv (N x 3D) and the attention output (N x D) in the
#: activation dtype, x1 (N x D, fp32), the wide route's pre (N x D, fp32)
#: and h (N x F, in the dtype), and the fused route's f2 partials
#: (``fe.tail_schedule``'s parts planes of N x D), with N = B*L.
FWD_WS_FIELDS = ("qkv", "attn", "x1", "pre", "h", "tail_part")


def _floats(count: int, dtype: torch.dtype) -> int:
    """Floats (4 bytes) that ``count`` elements of ``dtype`` take."""
    return -(-count * (torch.finfo(dtype).bits // 8) // 4)


class FwdPlan(ctypes.Structure):
    """B3's plan as the kernels take it (``FwdPlan`` of
    ``csrc/fused_encoder_train.cuh``): the tail's plan and CTAs, the
    workspace offsets (``FWD_WS_FIELDS``) and the attention's launch."""

    _fields_ = ([("tail", fe.TailPlan), ("tail_ctas", ctypes.c_longlong)]
                + [(k, ctypes.c_longlong) for k in FWD_WS_FIELDS]
                + [("attn_fwd", fa.AttnFwdPlan)])


def attention_launches(batch: int, max_len: int, d_model: int, n_head: int,
                       dtype: torch.dtype) -> dict:
    """The training layer's attention stages on ``csrc/attention_mma.cuh``'s
    kernels, on the plans of B2 and B5 at the head width (their tiles and
    ring at the same L): the forward's plan and launch (B3, and B4's
    recompute), the backward's plan and two launches (B4), each launch as
    (kernel, grid, shared memory bytes)."""
    dh = d_model // n_head
    fwd = fa.attention_fwd_plan(max_len, dh, dtype)
    bwd = fa.attention_bwd_plan(max_len, dh, dtype)
    heads = batch * n_head
    return {
        "fwd_plan": fwd, "bwd_plan": bwd,
        "fwd": [("attention_fwd_mma_kernel", (heads, fwd["q_tiles"]), fwd["bytes"])],
        "bwd": [("attention_bwd_dq_mma_kernel", (heads, bwd["tiles"]), bwd["dq_bytes"]),
                ("attention_bwd_dkv_mma_kernel", (heads, bwd["tiles"]), bwd["bytes"])],
    }


@functools.lru_cache(maxsize=32)
def train_fwd_plan(batch: int, max_len: int, d_model: int, n_head: int,
                   d_ff: int, sms: int = fe.SMS, dtype: torch.dtype = torch.float32) -> dict:
    """B3's plan on a card of ``sms`` SMs for activations in ``dtype``: the
    tail's plan and persistent schedule (those of B4's forward stage, which
    ``train_bwd_plan`` takes from here), the workspace offsets (in floats,
    16-byte aligned), its size, the CUDA launches of one call (4: the QKV
    product, attention, the tail and its finish; 7 where the tail runs wide)
    and all of it as ``FwdPlan`` (``struct``)."""
    n, d, f = batch * max_len, d_model, d_ff
    tail = fe.tail_plan(d, dtype)
    wide = bool(tail["wide"])
    sched = None if wide else fe.tail_schedule(n, d, f, dtype, sms)
    sizes = {"qkv": _floats(3 * n * d, dtype), "attn": _floats(n * d, dtype), "x1": n * d,
             "pre": n * d if wide else 0, "h": _floats(n * f, dtype) if wide else 0,
             "tail_part": 0 if wide else sched["parts"] * n * d}
    attention = attention_launches(batch, max_len, d_model, n_head, dtype)
    plan: dict = {"tail": tail, "tail_schedule": sched, "attention": attention}
    offset = 0
    for k in FWD_WS_FIELDS:
        plan[k] = offset
        offset += fe._round_up(sizes[k], 4)
    plan["workspace_floats"] = offset
    plan["launches"] = 7 if wide else 4
    plan["struct"] = FwdPlan(tail=fe.TailPlan(**tail), tail_ctas=0 if wide else sched["ctas"],
                             attn_fwd=attention["fwd_plan"]["struct"],
                             **{k: plan[k] for k in FWD_WS_FIELDS})
    return plan


# ---- the backward's plan and its plain staged version ---------------------------------

#: Workspace regions of the backward, in floats, in the kernel's order
#: (``BwdPlan``): qkv and dqkv (N x 3D), h and dh (N x F), the LN
#: statistics inv1 and inv2 (N), the softmax statistics (B x H x L x 3), the
#: partials of dh W1^T per d_ff slice (slices x N x D), in bf16 the
#: product operands x1t, df2t, daot (N x D), dht (N x F) and dqkvt (N x 3D)
#: (none in fp32, whose products read x1, df2, dh, dao and dqkv), the
#: tail's f2 partials (``fe.tail_schedule``'s parts planes of N x D; none
#: on the wide route), the rest N x D, with N = B*L. qkv, attn, h, dattn
#: (dO, rounded) and the operands hold the activation dtype, the rest fp32.
WS_FIELDS = ("qkv", "attn", "x1", "xhat1", "inv1", "xhat2", "inv2", "g2", "df2", "h", "dh",
             "dx1", "da", "dao", "dattn", "dqkv", "stats", "dx1p", "x1t", "df2t", "dht",
             "daot", "dqkvt", "tail_part")
#: Rows per slice of the column sums (bias and LayerNorm gradients).
COLSUM_ROWS = 256
#: The weight products over rows, by the gradient they make: (rows of the
#: output, columns of the output) as functions of (D, F).
WEIGHT_PRODUCTS = {"w1": lambda d, f: (d, f), "w2": lambda d, f: (f, d),
                   "w_out": lambda d, f: (d, d), "w_qkv": lambda d, f: (d, 3 * d)}
#: B4's stages, between the events ``_launch_bwd`` records.
BWD_STAGES = ("forward", "hidden", "ffn_products", "ln1_out_proj", "attention", "qkv",
              "reduce")


class BwdPlan(ctypes.Structure):
    """B4's plan as the kernels take it (``BwdPlan`` of
    ``csrc/fused_encoder_train.cuh``): the tail's plan and CTAs, the
    workspace offsets (``WS_FIELDS``, then the partials), rows per slice (``ks_``) and slices
    (``sp_``) of the weight products, of dh W1^T over d_ff and of the column
    sums, per gradient the offset and number of its partials, and the
    attention stages' plans."""

    _fields_ = (
        [("tail", fe.TailPlan), ("tail_ctas", ctypes.c_longlong)]
        + [(k, ctypes.c_longlong) for k in (*WS_FIELDS, "part")]
        + [(f"{a}_{k}", ctypes.c_longlong) for a in ("ks", "sp") for k in WEIGHT_PRODUCTS]
        + [(k, ctypes.c_longlong) for k in ("ks_dx1", "sp_dx1", "cs_rows", "cs_slices")]
        + [(k, ctypes.c_longlong * len(LAYER_KEYS)) for k in ("p_off", "p_n")]
        + [("attn_fwd", fa.AttnFwdPlan), ("attn_bwd", fa.AttnBwdPlan)]
    )


def _row_slices(n_rows: int, out_rows: int, out_cols: int) -> tuple[int, int]:
    """(rows per slice, slices) of a weight product summed over ``n_rows``
    rows: enough slices for two waves of 64 x 64 output tiles on the SMs,
    each slice a multiple of the product's depth step."""
    tiles = -(-out_rows // fe.GEMM_BM) * -(-out_cols // fe.GEMM_BN)
    # (also dh W1^T's slices of d_ff: n_rows = F, output N x D)
    want = max(1, -(-2 * fe.SMS // tiles))
    per = fe._round_up(-(-n_rows // want), fe.GEMM_BK)
    return per, -(-n_rows // per)


@functools.lru_cache(maxsize=32)
def train_bwd_plan(batch: int, max_len: int, d_model: int, n_head: int,
                   d_ff: int, sms: int = fe.SMS, dtype: torch.dtype = torch.float32) -> dict:
    """B4's plan on a card of ``sms`` SMs for activations in ``dtype``: the
    tail's plan and schedule (``train_fwd_plan``'s, so the recompute runs
    B3's launches), the workspace offsets (in floats, 16-byte aligned), the
    row slices of the four weight products and of the column sums, the d_ff
    slices of dh W1^T, the offsets and counts of every gradient's partials,
    the attention stages' launches (``attention``, ``train_fwd_plan``'s: the
    recompute's forward and the backward's two), the workspace size, the
    CUDA launches of one call (17; 20 where the tail runs wide) and all of
    it as ``BwdPlan`` (``struct``)."""
    n, d, f = batch * max_len, d_model, d_ff
    fwd = train_fwd_plan(batch, max_len, d_model, n_head, d_ff, sms, dtype)
    tail = fwd["tail"]
    plan: dict = {"tail": tail, "dx1_slices": _row_slices(f, n, d),
                  "tail_schedule": fwd["tail_schedule"], "attention": fwd["attention"]}
    bf16 = dtype == torch.bfloat16
    sizes = {k: n * d for k in WS_FIELDS}
    sizes.update(qkv=_floats(3 * n * d, dtype), attn=_floats(n * d, dtype), dqkv=3 * n * d,
                 h=_floats(n * f, dtype), dh=n * f, inv1=n, inv2=n, stats=3 * n * n_head,
                 dx1p=plan["dx1_slices"][1] * n * d,
                 **{k: _floats(c, dtype) if bf16 else 0 for k, c in (
                     ("x1t", n * d), ("df2t", n * d), ("dht", n * f), ("daot", n * d),
                     ("dqkvt", 3 * n * d))},
                 tail_part=0 if tail["wide"] else plan["tail_schedule"]["parts"] * n * d)
    offset = 0
    for k in WS_FIELDS:
        plan[k] = offset
        offset += fe._round_up(sizes[k], 4)
    plan["part"] = offset
    plan["slices"] = {k: _row_slices(n, *shape(d, f)) for k, shape in WEIGHT_PRODUCTS.items()}
    plan["cs_rows"], plan["cs_slices"] = COLSUM_ROWS, -(-n // COLSUM_ROWS)
    numel = {"w_qkv": 3 * d * d, "b_qkv": 3 * d, "w_out": d * d, "w1": d * f, "b1": f,
             "w2": f * d}
    p_off, p_n, part = [], [], 0
    for k in LAYER_KEYS:
        count = plan["slices"][k][1] if k in WEIGHT_PRODUCTS else plan["cs_slices"]
        p_off.append(part)
        p_n.append(count)
        part += fe._round_up(count * numel.get(k, d), 4)
    plan["p_off"], plan["p_n"] = p_off, p_n
    plan["workspace_floats"] = offset + part
    plan["launches"] = 20 if tail["wide"] else 17
    fields = {k: plan[k] for k in (*WS_FIELDS, "part", "cs_rows", "cs_slices")}
    for k, (per, slices) in plan["slices"].items():
        fields.update({f"ks_{k}": per, f"sp_{k}": slices})
    fields["ks_dx1"], fields["sp_dx1"] = plan["dx1_slices"]
    per_grad = ctypes.c_longlong * len(LAYER_KEYS)
    plan["struct"] = BwdPlan(tail=fe.TailPlan(**tail), tail_ctas=fwd["struct"].tail_ctas,
                             p_off=per_grad(*p_off), p_n=per_grad(*p_n),
                             attn_fwd=fwd["attention"]["fwd_plan"]["struct"],
                             attn_bwd=fwd["attention"]["bwd_plan"]["struct"], **fields)
    return plan


def _slice_sum(a: torch.Tensor, b: torch.Tensor, per: int) -> torch.Tensor:
    """``sum_z a[z]^T b[z]`` over row slices of ``per`` rows, in slice order."""
    out = None
    for r in range(0, a.shape[0], per):
        part = a[r:r + per].transpose(0, 1) @ b[r:r + per]
        out = part if out is None else out + part
    return out


def _col_sum(a: torch.Tensor, per: int) -> torch.Tensor:
    """Column sums over row slices of ``per`` rows, added in slice order."""
    out = None
    for r in range(0, a.shape[0], per):
        part = a[r:r + per].sum(0)
        out = part if out is None else out + part
    return out


def train_backward_staged(
    x: torch.Tensor, dy: torch.Tensor, layer: dict[str, torch.Tensor], seed: int, *,
    n_head: int, rate: float, gates: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[torch.Tensor], dict[str, torch.Tensor]]:
    """Plain PyTorch backward of the training layer that follows B4's
    stages over the N = B*L rows and its sums: the forward recomputed with
    the FFN summed over the tail's d_ff chunks in chunk order; LN2's
    backward; the hidden layer and its gradient; the weight products summed
    per row slice of ``train_bwd_plan`` and the slices added in order; dx1
    summed over d_ff chunks of ``GEMM_BK`` per d_ff slice, the slices added
    in order; LN1's backward; attention per head; the column sums per row
    slice. In bf16 it rounds where the TPU kernel rounds (the product
    operands x1, h, dF2, dh, dao, dO, P keep, dS and dqkv; O recomputed in
    fp32 for dO . O) and returns dx in bf16; the gradients stay fp32.
    Returns ``dx``, the 12 gradients (packed order) and the stages' outputs
    ``df2``, ``dx1``, ``da``, ``dqkv`` and the FFN's ReLU ``gates`` (B, L,
    .). ``gates`` (B, L, F), if given, are the ReLU gates to take in the
    backward instead of ``pre > 0`` (a kernel's, where a gate's input lies
    within rounding of 0). Used by tests and ``chip_smoke.py``, and as the
    bf16 plain version's backward; never on the main path."""
    b, l, d = x.shape
    f, h = layer["w1"].shape[1], n_head
    dh_ = d // h
    n = b * l
    acc, rnd = _acc(x.dtype), _rounder(x.dtype)
    plan = train_bwd_plan(b, l, d, h, f, dtype=x.dtype if x.dtype in DTYPES else torch.float32)
    masks = dropout_masks(b, l, d, f, h, seed, rate, x.device)
    m_out, m_ff, m_ff2 = (masks[k].reshape(n, -1) for k in ("out", "ff", "ff2"))
    w = {k: t.to(acc) for k, t in layer.items()}
    xf, dyf = x.reshape(n, d).to(acc), dy.reshape(n, d).to(acc)

    # forward recompute
    qkv = rnd(xf @ w["w_qkv"] + w["b_qkv"])
    q, k, v = (t.reshape(b, l, h, dh_).transpose(1, 2) for t in qkv.split(d, -1))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    pk = rnd(p * masks["attn"])
    o32 = pk @ v
    attn = rnd(o32).transpose(1, 2).reshape(n, d)
    a = xf + (attn @ w["w_out"] + w["b_out"]) * m_out
    mean1, var1 = a.mean(-1, keepdim=True), a.var(-1, unbiased=False, keepdim=True)
    inv1 = torch.rsqrt(var1 + LN_EPS)
    xhat1 = (a - mean1) * inv1
    x1 = xhat1 * w["ln1_s"] + w["ln1_b"]
    x1t = rnd(x1)
    fc = plan["tail"]["fc"] if plan["tail_schedule"] is not None else f
    f2 = None  # the chunks' partials in chunk order (one product on the wide tail)
    for c in range(0, f, fc):
        hd = rnd(torch.relu(x1t @ w["w1"][:, c:c + fc] + w["b1"][c:c + fc]) * m_ff[:, c:c + fc])
        part = hd @ w["w2"][c:c + fc]
        f2 = part if f2 is None else f2 + part
    y2 = x1 + (f2 + w["b2"]) * m_ff2
    mean2, var2 = y2.mean(-1, keepdim=True), y2.var(-1, unbiased=False, keepdim=True)
    inv2 = torch.rsqrt(var2 + LN_EPS)
    xhat2 = (y2 - mean2) * inv2

    def ln_bwd(g, xhat, inv, scale):
        gs = g * scale
        return inv * (gs - gs.mean(-1, keepdim=True) - xhat * (gs * xhat).mean(-1, keepdim=True))

    g2 = ln_bwd(dyf, xhat2, inv2, w["ln2_s"])
    df2 = g2 * m_ff2
    # the hidden layer and its gradient
    pre = x1t @ w["w1"] + w["b1"]
    gate = pre > 0 if gates is None else gates.reshape(n, f)
    zero = torch.zeros_like(m_ff)
    hid = rnd(torch.where(gate, pre, zero) * m_ff)
    dh = torch.where(gate, m_ff, zero) * (rnd(df2) @ w["w2"].t())
    sl = {kk: per for kk, (per, _) in plan["slices"].items()}
    dw1 = _slice_sum(x1t, rnd(dh), sl["w1"])
    dw2 = _slice_sum(hid, rnd(df2), sl["w2"])
    acc_dx1 = None
    per_f = plan["dx1_slices"][0]
    for z in range(0, f, per_f):
        part = torch.zeros_like(x1)
        for c in range(z, min(f, z + per_f), fe.GEMM_BK):
            part = part + rnd(dh[:, c:c + fe.GEMM_BK]) @ w["w1"][:, c:c + fe.GEMM_BK].t()
        acc_dx1 = part if acc_dx1 is None else acc_dx1 + part
    dx1 = g2 + acc_dx1
    # LN1 backward, out projection
    da = ln_bwd(dx1, xhat1, inv1, w["ln1_s"])
    dao = da * m_out
    dattn = rnd(dao) @ w["w_out"].t()
    dw_out = _slice_sum(attn, rnd(dao), sl["w_out"])
    # attention backward, per head
    do = rnd(dattn).reshape(b, l, h, dh_).transpose(1, 2)
    dcol = (do * o32).sum(-1, keepdim=True)
    ds = rnd(p * ((do @ v.transpose(-1, -2)) * masks["attn"] - dcol))
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    dv = pk.transpose(-1, -2) @ do
    dqkv = torch.cat([t.transpose(1, 2).reshape(n, d) for t in (dq, dk, dv)], -1)
    # QKV projection
    dw_qkv = _slice_sum(xf, rnd(dqkv), sl["w_qkv"])
    dx = (da + rnd(dqkv) @ w["w_qkv"].t()).to(x.dtype)
    cs = plan["cs_rows"]
    grads = {
        "w_qkv": dw_qkv, "b_qkv": _col_sum(dqkv, cs), "w_out": dw_out,
        "b_out": _col_sum(dao, cs), "ln1_s": _col_sum(dx1 * xhat1, cs),
        "ln1_b": _col_sum(dx1, cs), "w1": dw1, "b1": _col_sum(dh, cs), "w2": dw2,
        "b2": _col_sum(df2, cs), "ln2_s": _col_sum(dyf * xhat2, cs),
        "ln2_b": _col_sum(dyf, cs),
    }
    stages = {"df2": df2, "dx1": dx1, "da": da, "dqkv": dqkv, "gates": pre > 0}
    return (dx.reshape(b, l, d), [grads[kk] for kk in LAYER_KEYS],
            {kk: t.reshape(b, l, -1) for kk, t in stages.items()})


class PlainTrainLayer(torch.autograd.Function):
    """The plain version in bf16: its forward, and ``train_backward_staged``
    as its backward, which rounds where the TPU kernel rounds; each weight
    gradient is rounded to its packed weight's dtype, dx is bf16. ``gates``:
    None, or the ReLU gates both take (``fused_encoder_layer_train_reference``)."""

    @staticmethod
    def forward(ctx, x, seed: int, n_head: int, rate: float, gates, *weights):
        layer = dict(zip(LAYER_KEYS, weights))
        ctx.save_for_backward(x, *weights)
        ctx.seed, ctx.n_head, ctx.rate, ctx.gates = seed, n_head, rate, gates
        return _reference_forward(x, layer, seed, n_head, rate, gates)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        layer = dict(zip(LAYER_KEYS, weights))
        gates = None if ctx.gates is None else ctx.gates > 0
        dx, grads, _ = train_backward_staged(x, dy, layer, ctx.seed, n_head=ctx.n_head,
                                             rate=ctx.rate, gates=gates)
        return (dx, None, None, None, None,
                *(g.to(wt.dtype) for g, wt in zip(grads, weights)))


def _launch_bwd(x, dy, layer, seed: int, n_head: int, rate: float, events=None,
                stages: bool = False):
    """B4: ``dx`` and the 12 gradient views; with ``stages``, also the
    workspace's ``df2``, ``dx1``, ``da`` and ``dqkv`` and the ReLU gates the
    kernel took where dropout kept the unit (``h > 0``), (B, L, .). ``events``:
    ``len(BWD_STAGES) + 1`` timing ``torch.cuda.Event``s, recorded around
    the stages."""
    global bwd_launches
    b, l, d, h, f, group = _dims(x, layer, n_head)
    dy = dy.to(x.dtype).contiguous()
    lib = _library(x.dtype)
    plan = train_bwd_plan(b, l, d, h, f, fe.sm_count(x.device), x.dtype)
    workspace = torch.empty(plan["workspace_floats"], device=x.device)
    grads = torch.empty(_library().fdiff_train_grad_floats(d, f), device=x.device)
    dx = torch.empty_like(x)
    handles = None
    if events is not None:
        if len(events) != _library().fdiff_train_bwd_stages() + 1:
            raise ValueError(f"need {len(BWD_STAGES) + 1} events, got {len(events)}")
        for e in events:
            e.record()  # PyTorch creates an event's handle at its first record
        handles = (ctypes.c_void_p * len(events))(*(e.cuda_event for e in events))
    thr, scale = keep_threshold(rate)
    err = lib.fdiff_train_bwd(
        x.data_ptr(), dy.data_ptr(), _weight_ptrs(layer), dx.data_ptr(), grads.data_ptr(),
        workspace.data_ptr(), ctypes.byref(plan["struct"]),
        b, l, d, h, f, group, seed & M32, thr, scale, handles,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "training backward kernels")
    bwd_launches += 1
    views, offset = [], 0
    for key in LAYER_KEYS:
        n = layer[key].numel()
        views.append(grads[offset : offset + n].view(layer[key].shape))
        offset += n
    if not stages:
        return dx, views
    n_rows = b * l
    widths = {"df2": d, "dx1": d, "da": d, "dqkv": 3 * d}
    ws = {k: workspace[plan[k]:plan[k] + n_rows * wdt].view(b, l, wdt)
          for k, wdt in widths.items()}
    hidden = workspace[plan["h"]:plan["h"] + _floats(n_rows * f, x.dtype)].view(x.dtype)
    ws["gates"] = hidden[:n_rows * f].view(b, l, f) > 0
    return dx, views, ws


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
    saves only ``x``, the weights and the seed; the backward recomputes the
    forward with B3's launches."""

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
        return (dx, None, None, None, *(g.to(w.dtype) for g, w in zip(grads, weights)))


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
    "PlainTrainLayer",
    "attention_sublayer",
    "dropout_masks",
    "dropout_masks_cuda",
    "ffn_sublayer",
    "fused_encoder_layer_train",
    "fused_encoder_layer_train_reference",
    "hash_bits",
    "pack_encoder_layer_train",
    "train_backward_staged",
    "train_bwd_plan",
    "train_fwd_plan",
    "train_group",
]
