"""Port parity: the int8 (W8A8) sampling layers of
``fourierdiffusion_tpu_torch.ops.fused_encoder`` (B7, B8) and their packing,
against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_int8.py`` does; the port's wrapper, given CPU tensors,
runs its plain PyTorch versions. The kernels run only on a CUDA card; their
tests are in ``tests/test_torch_cuda.py``.

Tolerances:
- quantizer codes and scales, and the packed int8 weights: bit for bit.
- layer and forward, fp32: relative L2 2e-3. Both sides take exact integer
  sums, so they differ only where an fp32 input to a quantization, summed
  in another order, lands on the other side of a rounding boundary. A
  flipped code moves its token's sublayer output by up to one quantization
  step (1/127 of the slice's largest value), ~1e-3 of that token's output,
  and the next layer's attention spreads a smaller share over the chain;
  P alone has H x L^2 codes per chain and layer, so a few flips are
  expected at L=187 and 365 (measured on the CPU: 9e-8 to 6.7e-4).
- layer and forward, bf16: relative L2 2e-2 and 0.1 absolute. JAX and
  PyTorch round bf16 at other places inside their products (one bf16 ulp
  is 0.4 %), as in ``tests/test_torch_fused_encoder.py``.
- against JAX's canonical (unquantized) forward: JAX's own bound, relative
  L2 < 0.05 (``tests/test_fused_int8.py``).
- the int8 sampling program against the bf16 one, under one generator:
  JAX's bound, relative L2 < 0.02 (``test_int8_full_sampling_program``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models, numpy_inputs

from fourierdiffusion_tpu.models import fused as jax_fused
from fourierdiffusion_tpu.ops import fused_encoder as jax_fe
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    int8_level,
    pack_score_transformer,
    pack_score_transformer_train,
)
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.sampling import make_sample_fn
from fourierdiffusion_tpu_torch.schedulers import VPScheduler

N_HEAD, D_MODEL = 4, 24
# Three FFN chunks, the last one short (512 + 512 + 16).
D_FF = 1040
FP32_REL = 2e-3
BF16_REL, BF16_ABS = 2e-2, 0.1
CANONICAL_REL = 0.05
SAMPLING_REL = 0.02
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LEVELS = {1: dict(int8_ffn=True), 2: dict(int8_ffn=True, int8_attn=True)}


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _halfway_rows(rng: np.random.Generator) -> np.ndarray:
    """Rows of fp32 values v for which v * (1/scale) is exactly k + 1/2,
    each row with one largest element that fixes its scale, and one row of
    zeros (the 1e-12 floor)."""
    rows = []
    for absmax in (3.0, 0.37, 1.0e-3, 127.0):
        scale = np.float32(np.float32(absmax) * np.float32(1.0 / 127.0))
        inv = np.float32(1.0) / scale
        k = np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)
        v = (k * scale).astype(np.float32)
        v = v[(v * inv).astype(np.float32) == k]
        assert v.size >= 20  # enough exact halves to test the rounding
        v = rng.choice(v, size=min(63, v.size), replace=False)
        rows.append(np.pad(np.concatenate([[np.float32(absmax)], v]), (0, 63 - v.size)))
    rows.append(np.zeros(64, np.float32))
    return np.stack(rows).astype(np.float32)


def test_quantize_rows_matches_jax_bit_for_bit() -> None:
    rng = np.random.default_rng(0)
    w = np.concatenate([_halfway_rows(rng), rng.normal(size=(7, 64)).astype(np.float32)])
    q_jax, s_jax = jax_fe._quantize_rows(jnp.asarray(w))
    q, s = fe.quantize_rows(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (w.shape[0],)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(s_jax)[:, 0]))
    assert s[-8].item() == np.float32(np.float32(1e-12) * np.float32(1.0 / 127.0))
    # Exact halves round to the even code.
    t = w * (np.float32(1.0) / s.numpy()[:, None])
    half = np.abs(t - np.trunc(t)) == 0.5
    assert half.sum() >= 80
    assert (q.numpy()[half] % 2 == 0).all()


@pytest.mark.parametrize("axis", [0, 2])
def test_quantize_along_matches_jax_bit_for_bit(axis: int) -> None:
    rng = np.random.default_rng(axis + 1)
    rows = _halfway_rows(rng)  # (5, 64)
    x = np.stack([rows, rng.normal(size=rows.shape).astype(np.float32) * 3.0])  # (2, 5, 64)
    x = np.moveaxis(x, 2, axis) if axis == 0 else x
    q_jax, s_jax = jax_fe._quantize_along(jnp.asarray(x), axis)
    q, s = fe.quantize_along(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(s_jax)))


def _jax_layer_codes(jax_packed: dict, n_head: int, d: int) -> dict[str, np.ndarray]:
    """JAX's int8 codes and scales without its zero pad rows (dh -> 16)."""
    dh, pad = d // n_head, jax_fe.DH_PAD
    out = {key: np.asarray(jax_packed[key]) for key in ("w1_q", "w1_s", "w2_q", "w2_s")}
    if "w_qkv_q" in jax_packed:
        for key in ("w_qkv_q", "w_qkv_s"):
            a = np.asarray(jax_packed[key]).reshape(3, n_head, pad, -1)
            out[key] = a[:, :, :dh].reshape(3 * d, -1)
        assert not np.asarray(jax_packed["w_qkv_q"]).reshape(3, n_head, pad, d)[:, :, dh:].any()
        w_out = np.asarray(jax_packed["w_out_q"]).reshape(d, n_head, pad)
        assert not w_out[:, :, dh:].any()
        out["w_out_q"] = w_out[:, :, :dh].reshape(d, d)
        out["w_out_s"] = np.asarray(jax_packed["w_out_s"])
    return {k: v[:, 0] if k.endswith("_s") else v for k, v in out.items()}


@pytest.mark.parametrize("level", [1, 2])
def test_pack_matches_jax_codes_bit_for_bit(level: int) -> None:
    _, variables, model = jax_and_port_models(19, 1, dim_feedforward=D_FF)
    for i, layer in enumerate(model.backbone.layers):
        params = variables["params"]["backbone"][f"layers_{i}"]
        jax_packed = jax_fe.pack_encoder_layer(params, N_HEAD, jnp.float32, **LEVELS[level])
        packed = fe.pack_encoder_layer(layer, N_HEAD, torch.float32, **LEVELS[level])
        want = _jax_layer_codes(jax_packed, N_HEAD, D_MODEL)
        assert set(want) <= set(packed)
        for key, ref in want.items():
            got = packed[key]
            assert got.is_contiguous()
            if key.endswith("_q"):
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=key)
            else:
                np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref), err_msg=key)
        assert fe.layer_kind(packed) == ("int8_attn" if level == 2 else "int8")
        assert fe.layer_kind(packed) == fe.layer_kind(jax_packed)


def test_pack_rejects_int8_attn_without_ffn() -> None:
    _, _, model = jax_and_port_models(19, 1)
    with pytest.raises(ValueError, match="int8_ffn"):
        fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32, int8_attn=True)


@pytest.mark.parametrize("raw,level", [(None, 0), ("", 0), ("0", 0), ("1", 1), ("2", 2),
                                       ("yes", 1)])
def test_env_knob_selects_kernel_as_jax(monkeypatch, raw, level: int) -> None:
    jmodel, variables, model = jax_and_port_models(19, 1)
    if raw is None:
        monkeypatch.delenv("FDIFF_FUSED_INT8", raising=False)
    else:
        monkeypatch.setenv("FDIFF_FUSED_INT8", raw)
    assert int8_level() == level
    ours = pack_score_transformer(model)["layers"][0]
    theirs = jax_fused.pack_score_transformer(jmodel, variables)["layers"][0]
    assert fe.layer_kind(ours) == fe.layer_kind(theirs)
    assert fe.layer_kind(ours) == ("float", "int8", "int8_attn")[level]


def test_training_pack_never_int8(monkeypatch) -> None:
    monkeypatch.setenv("FDIFF_FUSED_INT8", "2")
    _, _, model = jax_and_port_models(16, 1)
    layers = pack_score_transformer_train(model)["layers"]
    assert all("w1" in layer and "w1_q" not in layer and "w_qkv_q" not in layer
               for layer in layers)


def _jax_layer(x: np.ndarray, variables, jdtype, level: int, l_valid: int) -> np.ndarray:
    params = variables["params"]["backbone"]["layers_0"]
    layer = jax_fe.pack_encoder_layer(params, N_HEAD, jdtype, **LEVELS[level])
    xt = jax_fe.pad_lanes(jnp.swapaxes(jnp.asarray(x).astype(jdtype), 1, 2))
    out = jax_fe.fused_encoder_layer(xt, layer, n_head=N_HEAD, l_valid=l_valid)
    return np.asarray(jnp.swapaxes(out[:, :, :l_valid], 1, 2).astype(jnp.float32))


def _assert_close(ours: np.ndarray, ref: np.ndarray, dtype: str) -> None:
    if dtype == "float32":
        assert _rel(ours, ref) <= FP32_REL, _rel(ours, ref)
    else:
        assert _rel(ours, ref) <= BF16_REL, _rel(ours, ref)
        np.testing.assert_allclose(ours, ref, atol=BF16_ABS, rtol=0.0)


@pytest.mark.parametrize("max_len", [19, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [1, 2])
def test_layer_matches_jax(level: int, dtype: str, max_len: int) -> None:
    tdtype, jdtype = DTYPES[dtype]
    _, variables, model = jax_and_port_models(max_len, 1, dim_feedforward=D_FF)
    x = np.random.default_rng(2).normal(size=(3, max_len, D_MODEL)).astype(np.float32)
    packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, tdtype, **LEVELS[level])
    ours = fe.fused_encoder_layer(torch.from_numpy(x).to(tdtype), packed, n_head=N_HEAD)
    assert ours.dtype == tdtype and ours.shape == x.shape
    _assert_close(ours.float().numpy(), _jax_layer(x, variables, jdtype, level, max_len), dtype)


@pytest.mark.parametrize("max_len", [19, 100, 187])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [1, 2])
def test_fused_forward_matches_jax(level: int, dtype: str, max_len: int) -> None:
    jmodel, variables, model = jax_and_port_models(max_len, 1, dtype, dim_feedforward=D_FF)
    x, t = numpy_inputs(3, max_len, 1)
    ref = np.asarray(jax_fused.fused_score_forward(
        jmodel, jax_fused.pack_score_transformer(jmodel, variables, int8_ffn=level),
        jnp.asarray(x), jnp.asarray(t)))
    canonical = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t),
                                        deterministic=True))
    with torch.no_grad():
        ours = fused_score_forward(model, pack_score_transformer(model, level),
                                   torch.from_numpy(x), torch.from_numpy(t)).numpy()
    _assert_close(ours, ref, dtype)
    assert _rel(ours, canonical) < CANONICAL_REL


@pytest.mark.parametrize("level", [1, 2])
def test_fused_forward_matches_jax_at_length_365(level: int) -> None:
    test_fused_forward_matches_jax(level, "float32", 365)


@pytest.mark.parametrize("level", [1, 2])
def test_int8_sampling_program_close_to_bf16(level: int) -> None:
    """The whole sampling program with the int8 layers stays close to the
    bf16 one under the same generator (JAX's
    ``test_int8_full_sampling_program``)."""
    _, _, model = jax_and_port_models(16, 2, "bfloat16")
    scheduler = VPScheduler(fourier_noise_scaling=False)
    kwargs = dict(num_diffusion_steps=5, batch_size=4, max_len=16, n_channels=2,
                  fused=True, device="cpu")

    def run(raw: str) -> np.ndarray:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FDIFF_FUSED_INT8", raw)
            return make_sample_fn(model, scheduler, **kwargs)(
                torch.Generator().manual_seed(7)).numpy()

    ref, out = run("0"), run(str(level))
    assert np.isfinite(out).all()
    assert 0.0 < _rel(out, ref) < SAMPLING_REL, _rel(out, ref)


def test_int8_kernel_counts_only_on_cuda() -> None:
    """On the CPU the wrapper runs the plain versions and counts nothing."""
    _, _, model = jax_and_port_models(19, 1)
    before = (fe.launches, fe.int8_launches, fe.int8_attn_launches)
    for level in (1, 2):
        packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32,
                                       **LEVELS[level])
        fe.fused_encoder_layer(torch.zeros(2, 19, D_MODEL), packed, n_head=N_HEAD)
    assert (fe.launches, fe.int8_launches, fe.int8_attn_launches) == before


def test_int8_layer_checks_inputs() -> None:
    _, _, model = jax_and_port_models(19, 1)
    packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32,
                                   int8_ffn=True, int8_attn=True)
    bad = dict(packed, w1_q=packed["w1_q"].float())
    with pytest.raises(ValueError, match="w1_q"):
        fe.fused_encoder_layer(torch.zeros(2, 19, D_MODEL), bad, n_head=N_HEAD)
    with pytest.raises(ValueError, match="w_qkv_q"):
        fe.fused_encoder_layer(torch.zeros(2, 19, 16), packed, n_head=N_HEAD)


def test_locate_code_flips_finds_none_against_itself() -> None:
    """The flip locator, fed the plain version's own codes, finds no flip and
    reproduces the plain output exactly."""
    _, _, model = jax_and_port_models(19, 1, dim_feedforward=D_FF)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 19, D_MODEL)).astype(
        np.float32))
    for level in (1, 2):
        packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32,
                                       **LEVELS[level])
        codes = fe.int8_codes_buffers(x, packed, N_HEAD)

        def record(site: str, xf: torch.Tensor, dim: int):
            q, s = fe.quantize_along(xf, dim)
            c0 = int(site[1:]) if site.startswith("h") else 0
            name = "h" if site.startswith("h") else site
            codes[name][..., c0:c0 + q.shape[-1]] = q
            return q, s

        reference = (fe.fused_encoder_layer_int8_attn_reference if level == 2
                     else fe.fused_encoder_layer_int8_reference)
        reference(x, packed, N_HEAD, record)
        y, flips = fe.locate_code_flips(x, packed, N_HEAD, codes)
        assert set(flips) == set(codes)
        assert all(f["flipped"] == 0 for f in flips.values())
        torch.testing.assert_close(y, fe.fused_encoder_layer(x, packed, n_head=N_HEAD),
                                   atol=0.0, rtol=0.0)
        # One flipped code is found, with its distance from the boundary.
        codes["x1"][0, 3, 5] += 1 if codes["x1"][0, 3, 5] < 127 else -1
        _, flips = fe.locate_code_flips(x, packed, N_HEAD, codes)
        assert flips["x1"]["flipped"] == 1 and flips["x1"]["max_step"] == 1
