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


# ---- the redesigned kernels' decompositions ---------------------------------------------


def _ffn_int8_partials(x1f: torch.Tensor, layer: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    """The W8A8 FFN as the int8 tail computes it: each 512-unit chunk's
    partial ``int32(W2q_c . qh_c) * (w2_s * s_h_c)`` on its own, as the tail
    writes it to the chunk's slot."""
    qx, s_x = fe._quantize_site("x1", x1f, -1)
    out = []
    for c0 in range(0, layer["w1_q"].shape[0], fe.INT8_FFN_CHUNK):
        c1 = c0 + fe.INT8_FFN_CHUNK
        h = torch.relu(fe._idot(qx, layer["w1_q"][c0:c1]) * (layer["w1_s"][c0:c1] * s_x)
                       + layer["b1"][c0:c1])
        qh, s_h = fe._quantize_site(f"h{c0}", h, -1)
        out.append(fe._idot(qh, layer["w2_q"][:, c0:c1]) * (layer["w2_s"] * s_h))
    return out


def _ffn_int8_finish(partials: list[torch.Tensor], b2: torch.Tensor) -> torch.Tensor:
    """The finish's sum of the chunks' partials: in chunk order, then + b2."""
    f = partials[0]
    for part in partials[1:]:
        f = f + part
    return f + b2


def _key_positions() -> list[int]:
    """Where B8's attention stages the V code of each key of a 32-key block:
    key 8j + 2t + e of the S accumulator's n8 tile j (thread t, element e)
    goes to k = 4t + 2j + e (j < 2) or 16 + 4t + 2(j - 2) + e, the k of the
    s8 A fragment that holds it. A copy of ``key_position`` in
    ``csrc/fused_encoder_int8.cu``: this checks the formula, and only the
    card tests (``tests/test_torch_cuda.py``, B8 against its plain version)
    check the kernel's own permutation."""
    return [(kk & 16) + 4 * ((kk & 7) >> 1) + 2 * ((kk & 15) >> 3) + (kk & 1)
            for kk in range(32)]



@pytest.mark.parametrize("d_ff", [D_FF, 2048, 64])
def test_chunk_partials_in_order_are_the_plain_ffn_bit_for_bit(d_ff: int) -> None:
    """The int8 tail writes each 512-unit chunk's partial to a slot of its
    own and the finish adds them in chunk order, then b2: bit for bit the
    plain ``_ffn_int8``, and through it JAX's ``_ffn_int8`` (which starts from
    zeros and adds the chunks in order), on the same codes."""
    _, variables, model = jax_and_port_models(19, 1, dim_feedforward=d_ff)
    packed = fe.pack_encoder_layer(model.backbone.layers[0], N_HEAD, torch.float32,
                                   int8_ffn=True)
    jp = jax_fe.pack_encoder_layer(variables["params"]["backbone"]["layers_0"], N_HEAD,
                                   jnp.float32, int8_ffn=True)
    x1f = np.random.default_rng(6).normal(size=(2, 19, D_MODEL)).astype(np.float32)
    partials = _ffn_int8_partials(torch.from_numpy(x1f), packed)
    assert len(partials) == -(-d_ff // fe.INT8_FFN_CHUNK)
    ours = _ffn_int8_finish(partials, packed["b2"])
    plain = fe._ffn_int8(torch.from_numpy(x1f), packed, fe._quantize_site)
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(plain.numpy()))
    rows = x1f.reshape(-1, D_MODEL)
    ref = jax_fe._ffn_int8(jnp.asarray(rows.T), jp["w1_q"], jp["w1_s"], jp["b1"], jp["w2_q"],
                           jp["w2_s"], jp["b2"], D_MODEL)
    np.testing.assert_array_equal(_bits(ours.numpy().reshape(-1, D_MODEL)),
                                  _bits(np.asarray(ref).T))


def _score_rows(rng: np.random.Generator, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Random score rows (wide and narrow spreads, ties at the maximum, rows
    beyond the bf16 form's clamp) and a mask of the keys below L of each
    row (the rest as the kernel pads them: no weight)."""
    s = rng.normal(size=(64, 100)).astype(np.float32) * rng.choice(
        [0.1, 1.0, 8.0, 40.0], size=(64, 1)).astype(np.float32)
    s[:4, :3] = s[:4, :1]  # ties at the maximum
    s[4:8] += 70.0  # past the clamp
    valid = np.arange(100)[None, :] < rng.integers(1, 101, size=(64, 1))
    return torch.from_numpy(s), torch.from_numpy(valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_p_scale_from_the_first_pass_is_quantize_along_bit_for_bit(dtype) -> None:
    """B8's attention takes P's scale per row from the first pass's
    statistics, before any P exists: the absmax of a row of P is its value
    at the row's largest score, 1 / l in the exact form (exp(0) = 1) and
    exp(clamp(s_max)) * (1 / l) in the max-free bf16 form. Over random rows,
    padded keys included, that scale is ``quantize_along(p, -1)``'s bit for
    bit, P formed as the kernel forms it."""
    s, valid = _score_rows(np.random.default_rng(8), dtype)
    if dtype == torch.float32:
        m = torch.where(valid, s, -torch.inf).amax(-1, keepdim=True)
        e = torch.where(valid, torch.exp(s - m), 0.0)
        l = e.sum(-1, keepdim=True)
        p = e / l
        absmax = 1.0 / l
    else:
        c = torch.where(valid, s.clamp(-fe.SCORE_CLAMP, fe.SCORE_CLAMP), -torch.inf)
        e = torch.exp(c)
        inv = 1.0 / e.sum(-1, keepdim=True)
        p = e * inv
        absmax = torch.exp(c.amax(-1, keepdim=True)) * inv
    _, want = fe.quantize_along(p, -1)
    got = absmax.clamp_min(1e-12) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert (p[~valid] == 0).all()


def test_s8_key_permutation_keeps_the_integer_sums() -> None:
    """B8's P . V: each thread packs the P codes it holds in the S
    accumulator (keys 8j + 2t, 8j + 2t + 1 of the n8 tiles j, rows g and
    g + 8) into the s8 A fragment as the kernel does, and V's codes are
    staged per column at ``_key_positions``; read by the PTX fragment
    layouts of m16n8k32 (A: rows g, g + 8, k = 4t.. and 16 + 4t..; B: column
    g, the same k), the product is P . V over the unpermuted keys, exactly."""
    rng = np.random.default_rng(9)
    p = torch.from_numpy(rng.integers(-127, 128, size=(16, 32))).to(torch.int64)
    v = torch.from_numpy(rng.integers(-127, 128, size=(32, 8))).to(torch.int64)
    pos = _key_positions()
    assert sorted(pos) == list(range(32))
    a = torch.zeros(16, 32, dtype=torch.int64)
    b = torch.zeros(32, 8, dtype=torch.int64)
    vq = torch.zeros(8, 32, dtype=torch.int64)  # [column][position], as staged
    for kk in range(32):
        vq[:, pos[kk]] = v[kk]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        acc_key = [[8 * j + 2 * t + (e & 1) for e in range(4)] for j in range(4)]  # S layout
        acc_row = [g + 8 * (e >> 1) for e in range(4)]
        # the kernel's pack_codes order: a0 = (j0 e0, j0 e1, j1 e0, j1 e1) rows g, a1 rows
        # g + 8 (e2, e3), a2 and a3 the same for j = 2, 3
        regs = [[(0, 0), (0, 1), (1, 0), (1, 1)], [(0, 2), (0, 3), (1, 2), (1, 3)],
                [(2, 0), (2, 1), (3, 0), (3, 1)], [(2, 2), (2, 3), (3, 2), (3, 3)]]
        for r, bytes_ in enumerate(regs):
            row = g + 8 * (r & 1)
            for byte, (j, e) in enumerate(bytes_):
                assert acc_row[e] == row
                a[row, 4 * t + 16 * (r >> 1) + byte] = p[row, acc_key[j][e]]
        for half in range(2):
            for byte in range(4):
                k = 16 * half + 4 * t + byte
                b[k, g] = vq[g, k]
    assert torch.equal(a @ b, p @ v)
