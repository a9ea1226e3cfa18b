"""One whole post-LN encoder layer per kernel launch, for the sampling path.

Port of ``fourierdiffusion_tpu/ops/fused_encoder.py`` (fp32 and bf16; the
int8 variants are not ported yet). ``pack_encoder_layer`` repacks an
encoder layer's weights once per sampling run; ``fused_encoder_layer``
runs the layer over activations ``(B, L, D)``:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/fused_encoder.cu`` and adds one to ``launches``;
* on a CPU tensor it runs ``fused_encoder_layer_reference``, the plain
  PyTorch version of the same arithmetic.

Numerics of both: products take operands in the activation dtype and
accumulate in fp32; results are rounded to the activation dtype after
qkv, the softmax, PV, LN1, the ReLU and LN2; LayerNorm statistics are fp32
(eps 1e-5). fp32 takes the exact softmax, bf16 the max-free one (scores
clamped to +-60, exp, reciprocal of the row sum), as on the TPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from fourierdiffusion_tpu_torch.models.transformer import LN_EPS, TransformerEncoderLayer

SCORE_CLAMP = 60.0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a block can opt into on sm_90

#: Kernel launches so far in this process; only the CUDA branch of
#: ``fused_encoder_layer`` adds to it. Callers reset it to 0 to count a run.
launches = 0

_LAYER_KEYS = (
    "w_qkv", "b_qkv", "w_out", "b_out", "ln1_s", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_s", "ln2_b",
)


def pack_encoder_layer(
    layer: TransformerEncoderLayer, n_head: int, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """Repack one encoder layer for the kernel.

    Weight matrices become ``(in, out)`` row-major in ``dtype``; the q
    columns of the QKV weight and bias carry the ``1/sqrt(dh)`` scale.
    Biases and LayerNorm parameters stay fp32.
    """
    if dtype not in DTYPES:
        raise ValueError(f"fused encoder supports float32 and bfloat16, not {dtype}")
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


def fused_encoder_layer_reference(
    x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding at the same points."""
    dtype = x.dtype
    b, l, d = x.shape
    dh = d // n_head

    def mm(a: torch.Tensor, w: str) -> torch.Tensor:  # fp32 accumulation
        return a @ layer[w].float()

    def rnd(t: torch.Tensor) -> torch.Tensor:  # round to the activation dtype
        return t.to(dtype).float()

    xf = x.float()
    qkv = rnd(mm(xf, "w_qkv") + layer["b_qkv"])
    q, k, v = (t.reshape(b, l, n_head, dh).transpose(1, 2) for t in qkv.split(d, -1))
    s = q @ k.transpose(-1, -2)
    if dtype == torch.bfloat16:
        e = torch.exp(torch.clamp(s, -SCORE_CLAMP, SCORE_CLAMP))
        p = e * (1.0 / e.sum(-1, keepdim=True))
    else:
        p = torch.softmax(s, dim=-1)
    o = rnd(rnd(p) @ v).transpose(1, 2).reshape(b, l, d)
    x1 = rnd(_ln(xf + (mm(o, "w_out") + layer["b_out"]), layer["ln1_s"], layer["ln1_b"]))
    h = rnd(torch.relu(mm(x1, "w1") + layer["b1"]))
    y = _ln(x1 + (mm(h, "w2") + layer["b2"]), layer["ln2_s"], layer["ln2_b"])
    return y.to(dtype)


def _check(x: torch.Tensor, layer: dict[str, torch.Tensor], n_head: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    _, _, d = x.shape
    d_ff = layer["w1"].shape[1]
    shapes = {
        "w_qkv": (d, 3 * d), "b_qkv": (3 * d,), "w_out": (d, d), "b_out": (d,),
        "ln1_s": (d,), "ln1_b": (d,), "w1": (d, d_ff), "b1": (d_ff,),
        "w2": (d_ff, d), "b2": (d,), "ln2_s": (d,), "ln2_b": (d,),
    }
    for key, shape in shapes.items():
        t = layer[key]
        want = x.dtype if key in ("w_qkv", "w_out", "w1", "w2") else torch.float32
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
        [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.fdiff_encoder_layer_smem_bytes.restype = ctypes.c_int
    lib.fdiff_encoder_layer_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fdiff_error_string.restype = ctypes.c_char_p
    lib.fdiff_error_string.argtypes = [ctypes.c_int]
    return lib


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
    smem = lib.fdiff_encoder_layer_smem_bytes(l, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"L={l}, D={d} needs {smem} bytes of shared memory per block")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fdiff_encoder_layer(
        DTYPES[x.dtype], *(t.data_ptr() for t in tensors), out.data_ptr(),
        b, l, d, n_head, d_ff, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused encoder kernel failed: {lib.fdiff_error_string(err).decode()}"
        )
    launches += 1
    return out


def fused_encoder_layer(
    x: torch.Tensor, layer: dict[str, torch.Tensor], *, n_head: int
) -> torch.Tensor:
    """One encoder layer over ``(B, L, D)``: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check(x, layer, n_head)
    if x.device.type == "cuda":
        return _launch(x, layer, n_head)
    if x.device.type == "cpu":
        return fused_encoder_layer_reference(x, layer, n_head)
    raise ValueError(f"fused_encoder_layer runs on cuda or cpu, not {x.device}")


def fused_encoder(
    x: torch.Tensor, layers: list[dict[str, torch.Tensor]], *, n_head: int
) -> torch.Tensor:
    """The encoder stack: ``fused_encoder_layer`` once per layer."""
    for layer in layers:
        x = fused_encoder_layer(x, layer, n_head=n_head)
    return x


__all__ = [
    "fused_encoder",
    "fused_encoder_layer",
    "fused_encoder_layer_reference",
    "pack_encoder_layer",
]
