"""One whole post-LN encoder layer per kernel launch, for the sampling path.

Port of ``fourierdiffusion_tpu/ops/fused_encoder.py``: the fp32/bf16 layer
and its two W8A8 int8 variants. ``pack_encoder_layer`` repacks an encoder
layer's weights once per sampling run (``int8_ffn``/``int8_attn`` quantize
them); ``fused_encoder_layer`` runs the layer over activations
``(B, L, D)``, choosing the kernel by the packed keys as JAX does:

* ``w_qkv_q``: the int8 FFN and attention layer (B8, ``FDIFF_FUSED_INT8=2``);
* ``w1_q``: the int8 FFN layer (B7, ``FDIFF_FUSED_INT8=1``);
* otherwise the fp32/bf16 layer (B1).

On a CUDA tensor it launches the hand-written kernel (``csrc/fused_encoder.cu``
for B1, ``csrc/fused_encoder_int8.cu`` for B7 and B8: four CUDA launches
each, every int8 product on the tensor cores, as ``int8_plan`` lays them
out) and adds one to that kernel's count (``launches``, ``int8_launches``,
``int8_attn_launches``); on a CPU tensor it runs the plain PyTorch version
of the same arithmetic.

Numerics of B1: products take operands in the activation dtype and
accumulate in fp32; results are rounded to the activation dtype after
qkv, the softmax, PV, LN1, the ReLU and LN2; LayerNorm statistics are fp32
(eps 1e-5). fp32 takes the exact softmax, bf16 the max-free one (scores
clamped to +-60, exp, reciprocal of the row sum), as on the TPU.

Numerics of B7 and B8 (the TPU kernels' rounding points): int8 codes with
one fp32 scale per slice (``quantize_along``, bit for bit JAX's), exact
integer sums, dequantized as ``sum * (w_scale * a_scale) + bias``. B7 runs
B1's attention, keeps x1 in fp32 and quantizes x1 per token and the ReLU
output per (512-unit chunk, token). B8 also quantizes x per token for the
QKV product (q and k then rounded to the dtype, V kept fp32 and quantized
per column over the chain's keys), the unrounded softmax per (head, query)
and the attention output per token.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F

from fourierdiffusion_tpu_torch.models.transformer import LN_EPS, TransformerEncoderLayer

SCORE_CLAMP = 60.0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a block can opt into on sm_90
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472  # bytes of shared memory per SM on sm_90

# The tensor-core kernels' tiles (csrc/mma_tile.cuh, csrc/encoder_layer_tc.cuh).
TAIL_MAX_KT, TAIL_MAX_FC = 128, 128  # k-rows of a streamed weight tile; d_ff chunk
GEMM_BM, GEMM_BN, GEMM_BK, GEMM_STAGES = 64, 64, 32, 4
MAX_TAIL_D = 256  # the tail's register tiles hold up to 256 columns; wider runs wide


class TailPlan(ctypes.Structure):
    """The tail's plan as the kernel takes it (``fdiff::TailPlan``): the
    wide route, or rows per tile, k-rows of a weight tile, d_ff chunk, weight
    tiles in the ring, D rounded to the k step and to 8, element strides of
    the activation, hidden and weight tiles, elements of a ring slot, byte
    offsets of the shared-memory regions and their total."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "wide", "tm", "kt", "fc", "slots", "kd", "dn", "sa", "sh", "swo", "sw1", "slot",
        "off_a", "off_h", "off_ring", "off_pre", "off_run", "bytes")]


#: Kernel launches so far in this process, of B1, B7 and B8; only the CUDA
#: branch of ``fused_encoder_layer`` adds to them. Callers reset them to 0
#: to count a run.
launches = 0
int8_launches = 0
int8_attn_launches = 0

#: Hidden units per chunk of the int8 FFN (JAX's ``_INT8_FFN_CHUNK``): the
#: hidden layer's scales are per (chunk, token), whatever the kernel's tiles.
INT8_FFN_CHUNK = 512
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)  # JAX's fp32 constant

_LAYER_KEYS = (
    "w_qkv", "b_qkv", "w_out", "b_out", "ln1_s", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_s", "ln2_b",
)
_LAYER_KEYS_INT8 = (
    "w_qkv", "b_qkv", "w_out", "b_out", "ln1_s", "ln1_b",
    "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2", "ln2_s", "ln2_b",
)
_LAYER_KEYS_INT8_ATTN = (
    "w_qkv_q", "w_qkv_s", "b_qkv", "w_out_q", "w_out_s", "b_out", "ln1_s", "ln1_b",
    "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2", "ln2_s", "ln2_b",
)
#: The order of the int8 kernel's weight pointers (``Int8Weights``).
_INT8_ARGS = (
    "w_qkv", "w_qkv_q", "w_qkv_s", "b_qkv", "w_out", "w_out_q", "w_out_s", "b_out",
    "ln1_s", "ln1_b", "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2", "ln2_s", "ln2_b",
)
#: Quantization sites of B7/B8, in the order of the kernel's probe buffers.
PROBE_SITES = ("x", "v", "p", "o", "x1", "h")


def quantize_along(xf: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes with one scale per slice along ``dim``.

    ``xf`` fp32; returns ``(q int8, scale fp32)`` with ``xf ~= q * scale``,
    ``scale`` keeping ``dim`` with size 1. Bit for bit JAX's
    ``_quantize_along``: ``scale = max(absmax, 1e-12) * fp32(1/127)``,
    ``q = clamp(round(xf * (1/scale)), -127, 127)``, the reciprocal
    correctly rounded and ``round`` half to even.
    """
    absmax = xf.abs().amax(dim=dim, keepdim=True)
    scale = absmax.clamp_min(1e-12) * _INV_127.to(xf.device)
    q = torch.round(xf * torch.reciprocal(scale)).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-row int8 codes of an ``(out, in)`` weight: ``(q (out, in)
    int8 row-major, scale (out,) fp32)``, as JAX's ``_quantize_rows``."""
    q, scale = quantize_along(w.detach().float(), 1)
    return q.contiguous(), scale[:, 0].contiguous()


def layer_kind(layer: dict[str, torch.Tensor]) -> str:
    """Which kernel the packed layer selects: "int8_attn" (B8), "int8"
    (B7) or "float" (B1), by its keys as in JAX."""
    if "w_qkv_q" in layer:
        return "int8_attn"
    if "w1_q" in layer:
        return "int8"
    return "float"


def pack_encoder_layer(
    layer: TransformerEncoderLayer, n_head: int, dtype: torch.dtype,
    int8_ffn: bool = False, int8_attn: bool = False,
) -> dict[str, torch.Tensor]:
    """Repack one encoder layer for the kernel.

    Weight matrices become ``(in, out)`` row-major in ``dtype``; the q
    columns of the QKV weight and bias carry the ``1/sqrt(dh)`` scale.
    Biases and LayerNorm parameters stay fp32. ``int8_ffn`` replaces W1
    and W2 with int8 codes ``(out, in)`` and one fp32 scale per output row
    (``w1_q``, ``w1_s``, ``w2_q``, ``w2_s``); ``int8_attn`` (which needs
    ``int8_ffn``) does the same for the QKV weight, after the q scale is
    folded in, and the out-projection (``w_qkv_q``, ``w_qkv_s``,
    ``w_out_q``, ``w_out_s``). The codes are JAX's without its zero pad
    rows (each head padded from dh to 16).
    """
    if dtype not in DTYPES:
        raise ValueError(f"fused encoder supports float32 and bfloat16, not {dtype}")
    if int8_attn and not int8_ffn:
        raise ValueError("int8_attn needs int8_ffn, as in JAX")
    with torch.no_grad():
        d_model = layer.norm1.weight.shape[0]
        scale = 1.0 / math.sqrt(d_model // n_head)
        w_in = layer.self_attn.in_proj_weight.float().clone()  # (3D, D)
        b_in = layer.self_attn.in_proj_bias.float().clone()
        w_in[:d_model] *= scale
        b_in[:d_model] *= scale

        def mat(w: torch.Tensor) -> torch.Tensor:  # (out, in) -> (in, out)
            return w.detach().t().to(dtype).contiguous()

        def vec(v: torch.Tensor) -> torch.Tensor:
            return v.detach().float().contiguous()

        packed = {}
        if int8_attn:
            packed["w_qkv_q"], packed["w_qkv_s"] = quantize_rows(w_in)
        else:
            packed["w_qkv"] = mat(w_in)
        packed["b_qkv"] = vec(b_in)
        if int8_attn:
            packed["w_out_q"], packed["w_out_s"] = quantize_rows(layer.self_attn.out_proj.weight)
        else:
            packed["w_out"] = mat(layer.self_attn.out_proj.weight)
        packed["b_out"] = vec(layer.self_attn.out_proj.bias)
        packed["ln1_s"] = vec(layer.norm1.weight)
        packed["ln1_b"] = vec(layer.norm1.bias)
        for name, lin in (("1", layer.linear1), ("2", layer.linear2)):
            if int8_ffn:
                packed[f"w{name}_q"], packed[f"w{name}_s"] = quantize_rows(lin.weight)
            else:
                packed[f"w{name}"] = mat(lin.weight)
            packed[f"b{name}"] = vec(lin.bias)
        packed["ln2_s"] = vec(layer.norm2.weight)
        packed["ln2_b"] = vec(layer.norm2.bias)
        return packed


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPS)


def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round fp32 ``t`` to the activation dtype, back in fp32."""
    return t.to(dtype).float()


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:  # (B, L, D) -> (B, H, L, dh)
    b, l, d = t.shape
    return t.reshape(b, l, n_head, d // n_head).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:  # (B, H, L, dh) -> (B, L, D)
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh)


def _softmax(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax of the scores: exact in fp32, max-free in bf16."""
    if dtype == torch.bfloat16:
        e = torch.exp(torch.clamp(s, -SCORE_CLAMP, SCORE_CLAMP))
        return e * (1.0 / e.sum(-1, keepdim=True))
    return torch.softmax(s, dim=-1)


def _attention_ln1(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> torch.Tensor:
    """B1's attention, residual and LN1; the LN1 output in fp32 (unrounded)."""
    dtype, d = x.dtype, x.shape[-1]
    xf = x.float()
    qkv = _rnd(xf @ layer["w_qkv"].float() + layer["b_qkv"], dtype)
    q, k, v = (_heads(t, n_head) for t in qkv.split(d, -1))
    p = _rnd(_softmax(q @ k.transpose(-1, -2), dtype), dtype)
    o = _merge_heads(_rnd(p @ v, dtype))
    return _ln(xf + (o @ layer["w_out"].float() + layer["b_out"]), layer["ln1_s"], layer["ln1_b"])


def fused_encoder_layer_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel B1, rounding at the same points."""
    dtype = x.dtype
    x1 = _rnd(_attention_ln1(x, layer, n_head), dtype)
    h = _rnd(torch.relu(x1 @ layer["w1"].float() + layer["b1"]), dtype)
    y = _ln(x1 + (h @ layer["w2"].float() + layer["b2"]), layer["ln2_s"], layer["ln2_b"])
    return y.to(dtype)


#: ``quant(site, xf, dim) -> (codes, scale)``: how the plain int8 versions
#: quantize at each site ("x", "v", "p", "o", "x1", and "h<first unit>" per
#: FFN chunk). The default is ``quantize_along``; a caller may substitute
#: codes (``chip_smoke.py`` puts in the kernel's, to locate every flip).
Quantizer = Callable[[str, torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]]


def _quantize_site(site: str, xf: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    return quantize_along(xf, dim)


def _idot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer sums ``a @ w.T`` of int8 codes, as fp32: the products
    are taken in fp64, exact for sums below 2**53 (the kernel's int32 sums
    stay below 2**31), then rounded to fp32 as the kernel rounds its int32."""
    return (a.double() @ w.double().transpose(-1, -2)).float()


def _ffn_int8(x1f: torch.Tensor, layer: dict[str, torch.Tensor], quant: Quantizer) -> torch.Tensor:
    """The W8A8 FFN over the fp32 LN1 output (JAX ``_ffn_int8``), ``f + b2``."""
    qx, s_x = quant("x1", x1f, -1)
    d_ff = layer["w1_q"].shape[0]
    f = torch.zeros_like(x1f)
    for c0 in range(0, d_ff, INT8_FFN_CHUNK):
        c1 = min(c0 + INT8_FFN_CHUNK, d_ff)
        h = torch.relu(
            _idot(qx, layer["w1_q"][c0:c1]) * (layer["w1_s"][c0:c1] * s_x) + layer["b1"][c0:c1]
        )
        qh, s_h = quant(f"h{c0}", h, -1)
        f = f + _idot(qh, layer["w2_q"][:, c0:c1]) * (layer["w2_s"] * s_h)
    return f + layer["b2"]


def fused_encoder_layer_int8_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int,
    quant: Quantizer = _quantize_site,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel B7 (JAX
    ``_encoder_layer_kernel_int8``): B1's attention with x1 kept in fp32,
    then the W8A8 FFN; the output rounded to the activation dtype."""
    x1f = _attention_ln1(x, layer, n_head)
    y = _ln(x1f + _ffn_int8(x1f, layer, quant), layer["ln2_s"], layer["ln2_b"])
    return y.to(x.dtype)


def _attention_ln1_int8(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int, quant: Quantizer
) -> torch.Tensor:
    """JAX ``_attention_ln1_int8``: int8 QKV, PV and out-projection, the S
    product in the activation dtype; the LN1 output in fp32."""
    dtype, d = x.dtype, x.shape[-1]
    xf = x.float()
    qx, s_x = quant("x", xf, -1)
    qkv_f = _idot(qx, layer["w_qkv_q"]) * (layer["w_qkv_s"] * s_x) + layer["b_qkv"]
    q, k, v_f = qkv_f.split(d, -1)
    s = _heads(_rnd(q, dtype), n_head) @ _heads(_rnd(k, dtype), n_head).transpose(-1, -2)
    qv, s_v = quant("v", v_f.contiguous(), 1)  # per (chain, column) over the keys
    qp, s_p = quant("p", _softmax(s, dtype), -1)  # per (head, query) over the keys
    o = _idot(qp, _heads(qv, n_head).transpose(-1, -2)) * (_heads(s_v, n_head) * s_p)
    qo, s_o = quant("o", _merge_heads(o), -1)
    attn = _idot(qo, layer["w_out_q"]) * (layer["w_out_s"] * s_o) + layer["b_out"]
    return _ln(xf + attn, layer["ln1_s"], layer["ln1_b"])


def fused_encoder_layer_int8_attn_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int,
    quant: Quantizer = _quantize_site,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel B8 (JAX
    ``_encoder_layer_kernel_int8_attn``)."""
    x1f = _attention_ln1_int8(x, layer, n_head, quant)
    y = _ln(x1f + _ffn_int8(x1f, layer, quant), layer["ln2_s"], layer["ln2_b"])
    return y.to(x.dtype)


def _expected_shapes(layer: dict[str, torch.Tensor], d: int, dtype: torch.dtype) -> dict:
    """(shape, dtype) of every packed tensor the layer's kind needs."""
    f32, i8 = torch.float32, torch.int8
    kind = layer_kind(layer)
    d_ff = layer["w1"].shape[1] if kind == "float" else layer["w1_q"].shape[0]
    out = {"b_qkv": ((3 * d,), f32), "b_out": ((d,), f32), "ln1_s": ((d,), f32),
           "ln1_b": ((d,), f32), "b1": ((d_ff,), f32), "b2": ((d,), f32),
           "ln2_s": ((d,), f32), "ln2_b": ((d,), f32)}
    if kind == "int8_attn":
        out.update(w_qkv_q=((3 * d, d), i8), w_qkv_s=((3 * d,), f32),
                   w_out_q=((d, d), i8), w_out_s=((d,), f32))
    else:
        out.update(w_qkv=((d, 3 * d), dtype), w_out=((d, d), dtype))
    if kind == "float":
        out.update(w1=((d, d_ff), dtype), w2=((d_ff, d), dtype))
    else:
        out.update(w1_q=((d_ff, d), i8), w1_s=((d_ff,), f32),
                   w2_q=((d, d_ff), i8), w2_s=((d,), f32))
    keys = {"float": _LAYER_KEYS, "int8": _LAYER_KEYS_INT8,
            "int8_attn": _LAYER_KEYS_INT8_ATTN}[kind]
    return {k: out[k] for k in keys}


def _check(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    for key, (shape, want) in _expected_shapes(layer, d, x.dtype).items():
        t = layer[key]
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(
                f"{key}: expected {shape} {want}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, x on {x.device}")
    if d % n_head:
        raise ValueError(f"d_model {d} is not a multiple of n_head {n_head}")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build and load ``csrc/fused_encoder.cu``, with its C signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library("fused_encoder")
    lib.fdiff_encoder_layer.restype = ctypes.c_int
    lib.fdiff_encoder_layer.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.POINTER(TailPlan)]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.fdiff_error_string.restype = ctypes.c_char_p
    lib.fdiff_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _int8_library() -> ctypes.CDLL:
    """Build and load ``csrc/fused_encoder_int8.cu``, with its C signatures."""
    from fourierdiffusion_tpu_torch.ops._build import load_library

    lib = load_library("fused_encoder_int8")
    lib.fdiff_encoder_layer_int8.restype = ctypes.c_int
    lib.fdiff_encoder_layer_int8.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.POINTER(Int8Plan)]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.fdiff_error_string.restype = ctypes.c_char_p
    lib.fdiff_error_string.argtypes = [ctypes.c_int]
    return lib


def data_ptr(t: torch.Tensor | None) -> int | None:
    """``t.data_ptr()``, or None (a null pointer for ctypes) for None."""
    return None if t is None else t.data_ptr()


# ---- launch plans of the tensor-core layer (B1, and B4's forward) ---------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_stride(elem_bytes: int, n: int, kmaj: bool) -> int:
    """Row stride (elements) of a shared tile whose rows hold ``n``
    elements (``tc::tile_stride``): fp32 rows of k ``S % 8 == 4``, else
    ``S % 16 == 8``, so a warp's fragment loads hit distinct banks."""
    if elem_bytes == 4 and kmaj:
        return (n + 3) // 8 * 8 + 4
    return (n + 7) // 16 * 16 + 8


def gemm_smem_bytes(elem_bytes: int) -> int:
    """Shared memory of the tile product: GEMM_STAGES stages of a 64 x 32 A
    and B tile in the larger of their layouts."""
    tile = max(tile_stride(elem_bytes, GEMM_BK, True) * GEMM_BM,
               tile_stride(elem_bytes, GEMM_BM, False) * GEMM_BK)
    return GEMM_STAGES * 2 * tile * elem_bytes


@functools.lru_cache(maxsize=64)
def tail_plan(d_model: int, dtype: torch.dtype) -> dict[str, int]:
    """The tail's plan (``TailPlan``'s fields). Up to D = ``MAX_TAIL_D``:
    row tiles of 32 rows up to D = 128, else 16; d_ff chunks of 64; weight
    tiles of all of D's k-rows up to 96, else of 64; three weight tiles in
    the ring where they fit, else two; the shared-memory regions
    (activation tile, hidden chunk, the weight ring, an fp32 tile of tm x
    dn that holds the rows before LN1 and, per d_ff chunk, one half of the
    chunk's W2 sums, and one that holds the running sum of a row tile's
    chunks), each 16-byte aligned. Wider layers take the wide route
    (``wide`` 1, the other fields 0): five launches through device
    memory."""
    p = dict.fromkeys(f for f, _ in TailPlan._fields_)
    if d_model > MAX_TAIL_D:
        return {**dict.fromkeys(p, 0), "wide": 1}
    size = torch.finfo(dtype).bits // 8
    kstep = 8 if size == 4 else 16
    tm = 32 if d_model <= 128 else 16
    kd, dn = _round_up(d_model, kstep), _round_up(d_model, 8)
    kt, fc = (kd if kd <= 96 else 64), 64
    p.update(wide=0, tm=tm, kt=kt, fc=fc, kd=kd, dn=dn, sa=tile_stride(size, kd, True),
             sh=tile_stride(size, fc, True), swo=tile_stride(size, dn, False),
             sw1=tile_stride(size, fc, False))
    p["slot"] = max(kt * p["swo"], kt * p["sw1"], fc * p["swo"])  # W_out, W1, W2 tiles
    for slots in (3, 2):
        p["slots"] = slots
        regions = (("off_a", tm * p["sa"] * size), ("off_h", tm * p["sh"] * size),
                   ("off_ring", slots * p["slot"] * size), ("off_pre", tm * dn * 4),
                   ("off_run", tm * dn * 4))
        offset = 0
        for name, nbytes in regions:
            p[name] = offset
            offset += _round_up(nbytes, 16)
        p["bytes"] = offset
        if offset <= SMEM_LIMIT:
            return p
    raise AssertionError(f"no tail plan fits D={d_model}")  # D <= 256 always fits


@functools.lru_cache(maxsize=64)
def _tail_plan_struct(d_model: int, dtype: torch.dtype) -> TailPlan:
    return TailPlan(**tail_plan(d_model, dtype))


def tail_ctas_per_sm(plan: dict[str, int]) -> int:
    """Tail CTAs that fit on one SM at once: two where two plans' shared
    memory (and the 1 KB the card reserves per block) fit in an SM's
    233,472 bytes; the kernel's registers are bounded for two."""
    return 2 if 2 * (plan["bytes"] + 1024) <= SM_SMEM else 1


def _schedule(n_rows: int, tm: int, fc: int, d_ff: int, per_sm: int, sms: int) -> dict:
    tiles, chunks = -(-n_rows // tm), -(-d_ff // fc)
    ctas = min(sms * per_sm, tiles * chunks)
    return {"tiles": tiles, "chunks": chunks, "units": tiles * chunks, "ctas": ctas,
            "parts": chunks}


def tail_schedule(n_rows: int, d_model: int, d_ff: int, dtype: torch.dtype,
                  sms: int = SMS) -> dict[str, int]:
    """The fused tail's persistent schedule (``fdiff::TailSchedule``): its
    units are (row tile, d_ff chunk), tile-major; ``ctas`` = min(SMs x
    ``tail_ctas_per_sm``, units) CTAs each take a contiguous range of them.
    A row's FFN sum is the fold of its chunks' partials in chunk order,
    (p0 + p1) + p2 ..., whatever CTAs hold them (``tail_partials``): the
    partials go to ``parts`` (= chunks) planes of N x D, so a row's sum
    does not depend on the batch it is in."""
    p = tail_plan(d_model, dtype)
    return _schedule(n_rows, p["tm"], p["fc"], d_ff, tail_ctas_per_sm(p), sms)


def tail_segments(schedule: dict[str, int]) -> list[tuple[int, int, int, int, tuple]]:
    """(CTA, row tile, first chunk, end chunk, partials) of every segment of
    the schedule, in the kernel's order: CTA k takes the units [k U / G,
    (k + 1) U / G), a row tile at a time. A segment that holds a tile's
    chunk 0 folds its chunks in order and writes one partial, (slot c_hi -
    1, chunks [0, c_hi)); any other writes each chunk's partial, (slot c,
    chunks [c, c + 1)). Slot c is plane c of the partials, rows of tile t."""
    units, ctas, chunks = schedule["units"], schedule["ctas"], schedule["chunks"]
    out = []
    for k in range(ctas):
        u, end = k * units // ctas, (k + 1) * units // ctas
        while u < end:
            tile = u // chunks
            c_lo, c_hi = u - tile * chunks, min(chunks, end - tile * chunks)
            parts = (((c_hi - 1, 0, c_hi),) if c_lo == 0 else
                     tuple((c, c, c + 1) for c in range(c_lo, c_hi)))
            out.append((k, tile, c_lo, c_hi, parts))
            u = tile * chunks + c_hi
    return out


def tail_partials(schedule: dict[str, int]) -> dict[int, list[tuple[int, int, int]]]:
    """Per row tile, its partials (slot, first chunk, end chunk) in the order
    ``tail_finish_kernel`` adds them: the prefix that the tile's first
    segment folded, then each later chunk's partial, one at a time."""
    by_tile: dict[int, list] = {}
    for _, tile, _, _, parts in tail_segments(schedule):
        by_tile.setdefault(tile, []).extend(parts)
    return {tile: sorted(parts, key=lambda p: p[1]) for tile, parts in sorted(by_tile.items())}


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def row_tiles(n_rows: int, tile: int) -> list[tuple[int, int]]:
    """The rows ``[start, stop)`` of each CTA of a grid of ``ceil(n_rows /
    tile)`` row tiles, as the kernels clip the last one."""
    return [(r, min(n_rows, r + tile)) for r in range(0, n_rows, tile)]


def sample_plan(batch: int, max_len: int, d_model: int, n_head: int, d_ff: int,
                dtype: torch.dtype, sms: int = SMS) -> dict:
    """B1's launches: the QKV tile product (GEMM tiles over the B*L rows),
    attention (a CTA per 128 query rows, head and chain) and the tail (its
    persistent schedule and the finish, or five launches on the wide
    route)."""
    n = batch * max_len
    size = torch.finfo(dtype).bits // 8
    tail = tail_plan(d_model, dtype)
    return {
        "qkv_grid": (-(-n // GEMM_BM), -(-3 * d_model // GEMM_BN)),
        "qkv_smem_bytes": gemm_smem_bytes(size),
        "attention_grid": (-(-max_len // 128), n_head, batch),
        "tail": tail,
        "tail_schedule": None if tail["wide"] else tail_schedule(n, d_model, d_ff, dtype, sms),
        "launches": 7 if tail["wide"] else 4,
    }


# ---- launch plan of the int8 layers (B7, B8) ---------------------------------------------

# (W1 rows / W2 columns per weight tile, weight tiles in the ring) of the
# int8 tail, in order of preference: the first ran the tail fastest on an
# H100 at the flagship's shape (scripts/int8_tail_sweep.py; PERF.md section
# 6), the second keeps two CTAs per SM at D=128, the third at D 168-248
INT8_TAIL_LAYOUTS = ((256, 2), (128, 3), (128, 2))
INT8_OUT_KT = 32  # B7: k-rows of a W_out tile of the int8 tail
TAIL_WARPS = 8
QKV8_TILE = 64  # B8's QKV: 64 rows x 64 columns per CTA
KEY_BLOCK, MAX_WARPS, WARP_ROWS, TILE_ROWS = 64, 8, 16, 128  # B8's attention, as B2's
INT8_MAX_DH = 64  # B8's attention: the widest head of its instances


class Int8Plan(ctypes.Structure):
    """The int8 layer's plan as the kernels take it (``Int8Plan`` of
    ``csrc/fused_encoder_int8.cu``): B8's attention (head width of the
    instance, warps, query tiles, key blocks, the strides of a staged K and
    V block, a stage's bytes, its shared memory), B8's QKV shared memory,
    and the tail's rows per tile, D rounded to the k step of the dtype and to
    32, the strides of its tiles, its ring's slot bytes and slots, the byte
    offsets of its shared-memory regions and their total."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kdh", "warps", "q_tiles", "key_blocks", "sk", "sv", "stage", "attn_bytes",
        "qkv_bytes", "tm", "kd", "kq", "sa", "sq", "sh", "swo", "wt", "sw2", "slot", "slots",
        "off_a", "off_pre", "off_q", "off_h", "off_sc", "off_par", "off_ring", "bytes")]


def tile_stride_s8(n: int) -> int:
    """Row stride (bytes) of a shared tile of int8 codes whose rows hold
    ``n`` codes (``tc::tile_stride_s8``): n padded to 32, plus 16."""
    return _round_up(n, 32) + 16


def int8_tail_layout(d_model: int, dtype: torch.dtype, level: int, tm: int, wt: int,
                     slots: int) -> dict[str, int]:
    """The int8 tail's fields of ``Int8Plan`` for row tiles of ``tm`` rows,
    weight tiles of ``wt`` W1 rows or W2 columns and ``slots`` of them in
    the ring: tiles of codes padded to 32 (``tile_stride_s8``); a slot
    holds the largest weight tile (B7: 32 k-rows of W_out in the dtype, B8:
    W_out's codes; W1's or W2's tile); the regions (the O tile, the fp32
    pre-LN1 rows, x1's codes, h's codes, row maxima and scales, five fp32
    vectors over D, the ring) 16-byte aligned, and their total ``bytes``."""
    size = torch.finfo(dtype).bits // 8
    attn8 = level == 2
    kd, kq = _round_up(d_model, 8 if size == 4 else 16), _round_up(d_model, 32)
    sq, sh, sw2 = tile_stride_s8(d_model), tile_stride_s8(INT8_FFN_CHUNK), tile_stride_s8(wt)
    sa = sq if attn8 else tile_stride(size, kd, True)
    swo = 0 if attn8 else tile_stride(size, d_model, False)
    out_tile = d_model * sq if attn8 else INT8_OUT_KT * swo * size
    slot = _round_up(max(out_tile, wt * sq, d_model * sw2), 16)
    p = {"tm": tm, "kd": kd, "kq": kq, "sa": sa, "sq": sq, "sh": sh, "swo": swo, "wt": wt,
         "sw2": sw2, "slot": slot, "slots": slots}
    regions = (("off_a", tm * sa * (1 if attn8 else size)), ("off_pre", tm * d_model * 4),
               ("off_q", tm * sq), ("off_h", tm * sh), ("off_sc", (TAIL_WARPS + 3) * tm * 4),
               ("off_par", 5 * d_model * 4), ("off_ring", slots * slot))
    offset = 0
    for name, nbytes in regions:
        p[name] = offset
        offset += _round_up(nbytes, 16)
    p["bytes"] = offset
    return p


@functools.lru_cache(maxsize=64)
def int8_layer_plan(max_len: int, d_model: int, n_head: int, dtype: torch.dtype,
                    level: int, layout: tuple[int, int, int] | None = None) -> dict[str, int]:
    """``Int8Plan``'s fields for B7 (``level`` 1) or B8 (2), for every chain
    alike. The tail (``int8_tail_layout``): row tiles of 32 rows up to D =
    128, else 16 (up to ``MAX_TAIL_D``); the first of ``INT8_TAIL_LAYOUTS``
    whose shared memory fits twice on an SM, else the first that fits once;
    or ``layout`` (rows per tile, weight-tile width, ring slots) where given.
    B8's attention: B2's tiles
    (``kdh`` the k step of S's mma, 8 in fp32 and 16 in bf16, doubled up to
    cover dh; a warp per 16 query rows, at most 8; blocks of 64 keys in a
    ring of two stages of a K block in the dtype and a V block in fp32), V's
    codes of a block and the head's scales. B8's QKV: 64 rows of x and of
    x's and W_qkv's codes. Raises ValueError where no plan serves the
    shape."""
    if d_model > MAX_TAIL_D or d_model % 8:
        raise ValueError(f"the int8 layers take d_model up to {MAX_TAIL_D} and divisible by "
                         f"8, got {d_model}")
    size = torch.finfo(dtype).bits // 8
    tm = 32 if d_model <= 128 else 16
    if layout is None:
        layouts = [int8_tail_layout(d_model, dtype, level, tm, wt, slots)
                   for wt, slots in INT8_TAIL_LAYOUTS]
        p = next((q for q in layouts if 2 * (q["bytes"] + 1024) <= SM_SMEM),
                 next(q for q in layouts if q["bytes"] <= SMEM_LIMIT))
    else:
        p = int8_tail_layout(d_model, dtype, level, *layout)
        if layout[0] not in (16, tm) or p["bytes"] > SMEM_LIMIT:
            raise ValueError(f"the int8 tail takes {tm} or 16 rows a tile at D={d_model} and "
                             f"{SMEM_LIMIT} bytes of shared memory; layout {layout} needs "
                             f"{p['bytes']}")
    p.update(dict.fromkeys(("kdh", "warps", "q_tiles", "key_blocks", "sk", "sv", "stage",
                            "attn_bytes", "qkv_bytes"), 0))
    if level == 2:
        dh = d_model // n_head
        if dh > INT8_MAX_DH:
            raise ValueError(f"the int8 attention takes heads up to {INT8_MAX_DH} wide, got {dh}")
        kdh = 8 if size == 4 else 16
        while kdh < dh:
            kdh *= 2
        sk, sv = tile_stride(size, kdh, True), tile_stride(4, kdh, True)
        stage = KEY_BLOCK * sk * size + KEY_BLOCK * sv * 4
        p.update(kdh=kdh, warps=min(MAX_WARPS, -(-max_len // WARP_ROWS)),
                 q_tiles=-(-max_len // TILE_ROWS), key_blocks=-(-max_len // KEY_BLOCK), sk=sk,
                 sv=sv, stage=stage, attn_bytes=2 * stage + kdh * (KEY_BLOCK + 16) + 2 * kdh * 4,
                 qkv_bytes=2 * QKV8_TILE * p["sq"] + QKV8_TILE * 4 + QKV8_TILE * d_model * size)
    return p


@functools.lru_cache(maxsize=64)
def _int8_plan_struct(max_len: int, d_model: int, n_head: int, dtype: torch.dtype,
                      level: int, layout: tuple[int, int, int] | None) -> Int8Plan:
    return Int8Plan(**int8_layer_plan(max_len, d_model, n_head, dtype, level, layout))


@functools.lru_cache(maxsize=64)
def int8_plan(batch: int, max_len: int, d_model: int, n_head: int, d_ff: int,
              dtype: torch.dtype, level: int, sms: int = SMS,
              layout: tuple[int, int, int] | None = None) -> dict:
    """B7's (``level`` 1) or B8's (2) launches, in order, each with its grid
    and shared memory; the layer plan (``int8_layer_plan``, with the tail's
    ``layout`` where given); the tail's
    persistent schedule over (row tile, 512-unit chunk) units (``tail_
    segments`` lists its segments), whose partials go to one slot per chunk;
    and the device workspaces (elements and dtype) the wrapper allocates.
    The tail runs as few CTAs as give none more units than the most that
    SMs x ``tail_ctas_per_sm`` CTAs would.

    B7: B1's QKV tile product and attention, the int8 tail, the finish. B8:
    the int8 QKV product, the int8 attention, the int8 tail, the finish.
    Cached: callers read it and do not change it."""
    n, d3 = batch * max_len, 3 * d_model
    size = torch.finfo(dtype).bits // 8
    layer = int8_layer_plan(max_len, d_model, n_head, dtype, level, layout)
    per_sm = 2 if 2 * (layer["bytes"] + 1024) <= SM_SMEM else 1
    sched = _schedule(n, layer["tm"], INT8_FFN_CHUNK, d_ff, per_sm, sms)
    # as few CTAs as keep the largest share: each takes ceil(U / G) units,
    # so at the flagship's 4 chunks a tile no CTA straddles two row tiles
    per_cta = -(-sched["units"] // sched["ctas"])
    sched.update(ctas=-(-sched["units"] // per_cta))
    qkv_grid = (-(-n // QKV8_TILE), -(-d3 // QKV8_TILE))
    if level == 2:
        first = [("qkv_int8_kernel", qkv_grid, layer["qkv_bytes"]),
                 ("attention_int8_kernel", (batch * n_head, layer["q_tiles"]),
                  layer["attn_bytes"])]
        ws = {"qkv": (n * 2 * d_model, dtype), "v": (n * d_model, torch.float32),
              "o": (n * d_model, torch.float32)}
    else:
        first = [("gemm_kernel", (-(-n // GEMM_BM), -(-d3 // GEMM_BN)), gemm_smem_bytes(size)),
                 ("attention_fwd_kernel", (-(-max_len // 128), n_head, batch), 0)]
        ws = {"qkv": (n * d3, dtype), "v": None, "o": (n * d_model, dtype)}
    ws.update(x1=(n * d_model, torch.float32),
              part=(sched["chunks"] * n * d_model, torch.float32))
    kernels = first + [("int8_tail_kernel", (sched["ctas"],), layer["bytes"]),
                       ("int8_finish_kernel", (-(-n // 8),), 0)]
    return {"layer": layer, "tail_schedule": sched, "tail_ctas_per_sm": per_sm,
            "kernels": kernels, "workspaces": ws, "launches": len(kernels)}


def _launch(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> torch.Tensor:
    global launches
    b, l, d = x.shape
    d_ff = layer["w1"].shape[1]
    if d % 4 or d_ff % 4:
        raise ValueError(f"kernel needs d_model and d_ff divisible by 4, got {d}, {d_ff}")
    if b > 65535:
        raise ValueError(f"kernel takes at most 65535 chains per launch, got {b}")
    tensors = [x] + [layer[k] for k in _LAYER_KEYS]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_encoder_layer needs contiguous tensors")
    lib = _library()
    out = torch.empty_like(x)
    qkv = torch.empty(b * l, 3 * d, dtype=x.dtype, device=x.device)
    o = torch.empty(b * l, d, dtype=x.dtype, device=x.device)
    plan = _tail_plan_struct(d, x.dtype)
    n = b * l
    tail_ws = [None] * 5  # fused: x1, partials (fp32); wide: pre (fp32), x1, h
    ctas = 0
    if plan.wide:
        tail_ws[2:] = [torch.empty(n, d, device=x.device),
                       torch.empty(n, d, dtype=x.dtype, device=x.device),
                       torch.empty(n, d_ff, dtype=x.dtype, device=x.device)]
    else:
        sched = tail_schedule(n, d, d_ff, x.dtype, sm_count(x.device))
        ctas = sched["ctas"]
        tail_ws[:2] = [torch.empty(n, d, device=x.device),
                       torch.empty(sched["parts"] * n * d, device=x.device)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fdiff_encoder_layer(
        DTYPES[x.dtype], *(t.data_ptr() for t in tensors), out.data_ptr(), qkv.data_ptr(),
        o.data_ptr(), *(data_ptr(t) for t in tail_ws), ctypes.byref(plan), ctas, b, l, d,
        n_head, d_ff, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused encoder kernel failed: {lib.fdiff_error_string(err).decode()}"
        )
    launches += 1
    return out


def launch_int8(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int,
    probe: dict[str, torch.Tensor] | None = None,
    layout: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Launch B7 or B8 (by the layer's keys) on CUDA tensors, four CUDA
    launches as ``int8_plan`` lays them out, and add one to its count.
    ``probe`` maps sites of ``PROBE_SITES`` to int8 buffers that receive the
    kernel's codes (``int8_codes_buffers``); ``layout`` replaces the plan's
    choice of the tail's (rows per tile, weight-tile width, ring slots), as
    ``scripts/int8_tail_sweep.py`` does to time the others."""
    global int8_launches, int8_attn_launches
    attn8 = layer_kind(layer) == "int8_attn"
    b, l, d = x.shape
    d_ff = layer["w1_q"].shape[0]
    if d % 8 or d_ff % 8:
        raise ValueError(f"int8 kernel needs d_model and d_ff divisible by 8, got {d}, {d_ff}")
    if b > 65535:
        raise ValueError(f"kernel takes at most 65535 chains per launch, got {b}")
    ptrs = [layer.get(k) for k in _INT8_ARGS]
    addrs = [x.data_ptr()] + [None if t is None else t.data_ptr() for t in ptrs]
    if not (all(t is None or t.is_contiguous() for t in [x, *ptrs])
            and all(a is None or a % 16 == 0 for a in addrs)):
        raise ValueError("fused_encoder_layer needs contiguous, 16-byte aligned tensors")
    level = 2 if attn8 else 1
    plan = int8_plan(b, l, d, n_head, d_ff, x.dtype, level, sm_count(x.device), layout)
    lib = _int8_library()
    out = torch.empty_like(x)
    ws = {k: None if v is None else torch.empty(v[0], dtype=v[1], device=x.device)
          for k, v in plan["workspaces"].items()}
    weights = (ctypes.c_void_p * len(_INT8_ARGS))(*addrs[1:])
    workspaces = (ctypes.c_void_p * 5)(*(data_ptr(ws[k]) for k in ("qkv", "v", "o", "x1", "part")))
    probes = None
    if probe is not None:
        probes = (ctypes.c_void_p * len(PROBE_SITES))(
            *(data_ptr(probe.get(site)) for site in PROBE_SITES))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fdiff_encoder_layer_int8(
        DTYPES[x.dtype], int(attn8), addrs[0], weights, out.data_ptr(), workspaces, probes,
        ctypes.byref(_int8_plan_struct(l, d, n_head, x.dtype, level, layout)),
        plan["tail_schedule"]["ctas"], b, l, d, n_head, d_ff, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"int8 fused encoder kernel failed: {lib.fdiff_error_string(err).decode()}"
        )
    if attn8:
        int8_attn_launches += 1
    else:
        int8_launches += 1
    return out


def int8_codes_buffers(x: torch.Tensor, layer: dict[str, torch.Tensor],
                       n_head: int) -> dict[str, torch.Tensor]:
    """Zeroed int8 buffers for the codes of every quantization site of the
    layer's kind, shaped as the plain versions' codes: x, v, o, x1 (B, L, D),
    p (B, H, L, L), h (B, L, F). B7 has only x1 and h."""
    b, l, d = x.shape
    d_ff = layer["w1_q"].shape[0]
    shapes = {"x1": (b, l, d), "h": (b, l, d_ff)}
    if layer_kind(layer) == "int8_attn":
        shapes.update(x=(b, l, d), v=(b, l, d), p=(b, n_head, l, l), o=(b, l, d))
    return {k: torch.zeros(v, dtype=torch.int8, device=x.device) for k, v in shapes.items()}


def _site_codes(codes: dict[str, torch.Tensor], site: str, width: int) -> tuple[str, torch.Tensor]:
    """The entry of ``codes`` for a quantizer site: "h<c0>" is the slice
    ``[..., c0:c0 + width]`` of the hidden layer's codes."""
    if site.startswith("h"):
        c0 = int(site[1:])
        return "h", codes["h"][..., c0:c0 + width]
    return site, codes[site]


def locate_code_flips(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int,
                      codes: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """Run the plain B7/B8 version with ``codes`` (a kernel's, from the
    ``probe`` of ``launch_int8``) put in at every quantization site, and
    locate every code that differs from the one the plain version takes.

    Site by site, in the layer's order, the plain version quantizes its own
    fp32 input (computed from the given codes upstream), compares, and then
    goes on with the given codes. So its output differs from the kernel's
    only by fp32 (or bf16) rounding, and each flip is located at the site
    where it arose. Returns that output and, per site, the number of codes,
    the number flipped, the largest |code difference| and the largest
    distance of a flipped code's input ``|x / scale|`` from the nearest
    rounding boundary (k + 1/2), in code units.
    """
    stats: dict[str, dict] = {}

    def quant(site: str, xf: torch.Tensor, dim: int):
        q, s = quantize_along(xf, dim)
        name, given = _site_codes(codes, site, xf.shape[-1])
        given = given.to(q.device)
        flipped = given != q
        rec = stats.setdefault(name, {"codes": 0, "flipped": 0, "max_step": 0, "max_dist": 0.0})
        rec["codes"] += q.numel()
        n = int(flipped.sum())
        if n:
            t = (xf * torch.reciprocal(s)).abs()
            dist = (t - (torch.floor(t) + 0.5)).abs()
            rec["flipped"] += n
            rec["max_step"] = max(rec["max_step"],
                                  int((given.int() - q.int()).abs().max()))
            rec["max_dist"] = max(rec["max_dist"], float(dist[flipped].max()))
        return given, s

    out = _REFERENCES[layer_kind(layer)](x, layer, n_head, quant)
    return out, stats


_REFERENCES = {
    "float": lambda x, layer, n_head, quant=None: fused_encoder_layer_reference(
        x, layer, n_head),
    "int8": fused_encoder_layer_int8_reference,
    "int8_attn": fused_encoder_layer_int8_attn_reference,
}


def fused_encoder_layer(
    x: torch.Tensor, layer: dict[str, torch.Tensor], *, n_head: int
) -> torch.Tensor:
    """One encoder layer over ``(B, L, D)``, B1, B7 or B8 by the layer's
    keys: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check(x, layer, n_head)
    kind = layer_kind(layer)
    if x.device.type == "cuda":
        return _launch(x, layer, n_head) if kind == "float" else launch_int8(x, layer, n_head)
    if x.device.type == "cpu":
        return _REFERENCES[kind](x, layer, n_head)
    raise ValueError(f"fused_encoder_layer runs on cuda or cpu, not {x.device}")


def fused_encoder_layer_plain(
    x: torch.Tensor, layer: dict[str, torch.Tensor], *, n_head: int
) -> torch.Tensor:
    """The plain version of the layer's kernel (B1, B7 or B8), on any
    device: to hold the kernels against it on the card."""
    _check(x, layer, n_head)
    return _REFERENCES[layer_kind(layer)](x, layer, n_head)


LayerFn = Callable[..., torch.Tensor]  # (x, layer, *, n_head) -> x


def fused_encoder(
    x: torch.Tensor, layers: list[dict[str, torch.Tensor]], *, n_head: int,
    layer_fn: LayerFn = fused_encoder_layer,
) -> torch.Tensor:
    """The encoder stack: ``layer_fn`` (``fused_encoder_layer``, or for
    instance ``fused_encoder_layer_plain``) once per layer."""
    for layer in layers:
        x = layer_fn(x, layer, n_head=n_head)
    return x


__all__ = [
    "INT8_FFN_CHUNK",
    "PROBE_SITES",
    "fused_encoder",
    "fused_encoder_layer",
    "fused_encoder_layer_int8_attn_reference",
    "fused_encoder_layer_int8_reference",
    "fused_encoder_layer_plain",
    "fused_encoder_layer_reference",
    "int8_codes_buffers",
    "int8_plan",
    "launch_int8",
    "layer_kind",
    "locate_code_flips",
    "pack_encoder_layer",
    "quantize_along",
    "quantize_rows",
]
