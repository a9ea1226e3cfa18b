"""Port parity of the attention forward and backward, with and without
dropout (``ops/flash_attention.py``), against the JAX package's
``flash_attention`` and ``flash_attention_dropout``, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port's wrappers, given CPU
tensors, run their plain PyTorch versions (forward and backward). The
kernels themselves run only on a CUDA card (``tests/test_torch_cuda.py``).

Tolerances: fp32 1e-5 absolute and relative (the same arithmetic, summed
in other orders); gradients 1e-5 of each tensor's largest entry (the same
fp32 backward arithmetic, summed in other orders: JAX over 128 padded
lanes, the port over exactly L keys). bf16 2**-5 absolute on outputs of
size up to ~2: both round q, P and O to bf16 at the same points, and a
different fp32 sum order can flip one rounding, which moves an output by
one bf16 ulp (2**-7 to 2**-6 at these sizes). bf16 gradients (dq, dk, dv
in bf16) 2**-8 of each tensor's largest entry: both round P_used, dS and
the outputs at the same points, and an fp32 sum taken in another order
(JAX over 128 padded lanes, the port over L keys or in blocks of 64) now
and then rounds one of them the other way, which moves that entry by one
bf16 ulp of itself and a sum over it by less (measured up to 9.5e-4). The
dropout masks bit for bit (the same hash of the same positions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import jax_and_port_models, numpy_inputs

from fourierdiffusion_tpu.ops import flash_attention as jax_fa
from fourierdiffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from fourierdiffusion_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2.0**-5, rtol=0.0)}
GRAD_REL = 1e-5
BF16_GRAD_REL = 2.0**-8
RATE = 0.1
BF16 = torch.bfloat16


def _qkv(shape, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "dtype,shape",
    [("float32", (2, 4, 19, 6)), ("float32", (3, 12, 100, 6)),
     ("bfloat16", (2, 4, 19, 6)), ("bfloat16", (3, 12, 100, 6)),
     ("bfloat16", (2, 2, 19, 16))],
    ids=["fp32-L19", "fp32-flagship", "bf16-fast-L19", "bf16-fast-flagship",
         "bf16-exact-dh16"],
)
def test_flash_attention_matches_jax(dtype: str, shape) -> None:
    q, k, v = _qkv(shape)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v))).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = fa.launches
    ours = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert fa.launches == before  # a CPU tensor never reaches the kernel
    assert ours.dtype == tdt and ours.shape == q.shape
    np.testing.assert_allclose(ours.float().numpy(), ref, **TOL[dtype])


def test_fast_form_only_for_bf16_below_dh16() -> None:
    assert fa._fast(torch.zeros(1, 1, 2, 6, dtype=torch.bfloat16))
    assert not fa._fast(torch.zeros(1, 1, 2, 16, dtype=torch.bfloat16))
    assert not fa._fast(torch.zeros(1, 1, 2, 6))


def _f32(x) -> np.ndarray:
    """A port tensor or a JAX or numpy array, of any float dtype, as fp32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_grads_close(ours, ref, names=("dq", "dk", "dv"), rel: float = GRAD_REL) -> None:
    for name, got, want in zip(names, ours, ref):
        got, want = _f32(got), _f32(want)
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert err <= rel, (name, err)


def _bf16(a: np.ndarray) -> tuple[torch.Tensor, jax.Array]:
    """The same bf16 values for the port and for JAX."""
    return torch.from_numpy(a).to(BF16), jnp.asarray(a).astype(jnp.bfloat16)


def _port_vjp(fn, q, k, v, do):
    """The port's output and autograd gradients of ``fn`` on CPU tensors."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    return out, torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))


@pytest.mark.parametrize(
    "shape", [(2, 12, 100, 4), (2, 12, 365, 4), (1, 2, 775, 16)],
    ids=["L100", "L365", "L775-dh16"],
)
def test_flash_attention_backward_matches_jax(shape) -> None:
    """B5's plain version: the port's forward and autograd backward against
    ``jax.vjp`` of JAX's ``flash_attention`` (its ``_bwd_kernel``). L=775
    at dh 16 is a length JAX serves with one head per group; the CUDA
    kernels' cover of it is checked by ``test_torch_launch_plans.py`` and,
    on the card, by ``test_torch_cuda.py``."""
    q, k, v = _qkv(shape, seed=4)
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    out_ref, vjp = jax.vjp(jax_flash, *(jnp.asarray(a) for a in (q, k, v)))
    before = (fa.launches, fa.bwd_launches)
    out, grads = _port_vjp(fa.flash_attention, q, k, v, do)
    assert (fa.launches, fa.bwd_launches) == before  # CPU tensors never reach a kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **TOL["float32"])
    _assert_grads_close(grads, vjp(jnp.asarray(do)))


@pytest.mark.parametrize(
    "shape", [(2, 12, 100, 4), (2, 12, 365, 4), (1, 2, 775, 16)],
    ids=["L100", "L365", "L775-dh16"],
)
def test_bf16_flash_attention_backward_matches_jax(shape) -> None:
    """B5's plain version in bf16 (the forward's fast form below dh 16, the
    backward ``_bwd_core`` rounding P_used and dS to bf16): the output and
    dq, dk, dv (bf16) against ``jax.vjp`` of JAX's ``flash_attention`` in
    bf16 (``_fast_fwd_kernel`` or ``_fwd_kernel``, and ``_bwd_kernel``)."""
    do = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    q, k, v, do = (_bf16(a) for a in (*_qkv(shape, seed=4), do))
    out_ref, vjp = jax.vjp(jax_flash, q[1], k[1], v[1])
    qt, kt, vt = (a[0].requires_grad_(True) for a in (q, k, v))
    before = (fa.launches, fa.bwd_launches)
    out = fa.flash_attention(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), do[0])
    assert (fa.launches, fa.bwd_launches) == before
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    np.testing.assert_allclose(_f32(out), _f32(out_ref), **TOL["bfloat16"])
    _assert_grads_close(grads, vjp(do[1]), rel=BF16_GRAD_REL)


def _jax_bwd(q, k, v, do, seed: int | None):
    """JAX's ``_bwd_call`` (seed None) or ``_dropout_bwd_call`` at RATE."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    if seed is None:
        return jax_fa._bwd_call(*args, jnp.asarray(do))
    return jax_fa._dropout_bwd_call(*args, jnp.asarray(seed, jnp.int32), RATE, jnp.asarray(do))


@pytest.mark.parametrize("seed", [None, 2**31 - 2], ids=["B5", "B6-bwd"])
@pytest.mark.parametrize("l", [19, 100, 187, 365], ids=lambda l: f"L{l}")
def test_staged_backward_matches_jax(l: int, seed: int | None) -> None:
    """The plain staged version of B5/B6-bwd's two launches (statistics over
    key blocks of 64, D from the forward's output, dq, then dk and dv over
    blocks of query rows; no L here a multiple of 64) against the port's
    ``_bwd_core`` and JAX's ``_bwd_call`` / ``_dropout_bwd_call`` in
    interpret mode; its statistics against the softmax max, sum and dO . O
    taken whole."""
    q, k, v = _qkv((2, 3, l, 6), seed=l)
    do = np.random.default_rng(l + 1).normal(size=q.shape).astype(np.float32)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    if seed is None:
        keep, o = None, fa.flash_attention_reference(qt, kt, vt)
    else:
        keep = fa.attention_keep(2, 3, l, seed, RATE)
        o = fa.flash_attention_dropout_reference(qt, kt, vt, seed, RATE)
    *grads, stats = fa.attention_bwd_staged(qt, kt, vt, o, dot, keep)
    _assert_grads_close(grads, fa._bwd_core(qt, kt, vt, dot, keep))
    _assert_grads_close(grads, _jax_bwd(q, k, v, do, seed))
    s = (qt @ kt.transpose(-1, -2)) / 6**0.5
    m = s.amax(-1)
    want = torch.stack([m, torch.exp(s - m[..., None]).sum(-1), (dot * o).sum(-1)], dim=-1)
    assert stats.shape == (2, 3, l, fa.STAT_COLS)
    torch.testing.assert_close(stats, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [None, 2**31 - 2], ids=["B5", "B6-bwd"])
@pytest.mark.parametrize("l", [19, 100, 187, 365], ids=lambda l: f"L{l}")
def test_bf16_staged_backward_matches_jax(l: int, seed: int | None) -> None:
    """The plain staged version of the bf16 launches (statistics over key
    blocks, O = P_used v recomputed over them for D, dq; then dk and dv over
    blocks of query rows; P_used and dS rounded to bf16) against the port's
    ``_bwd_core`` and JAX's ``_bwd_call`` / ``_dropout_bwd_call`` in bf16
    (interpret mode); its statistics against the softmax max and sum taken
    whole (1e-5) and D against dO . (P_used v) taken in fp64, within
    ``bf16_d_err_over_bound``'s bound (P from the blocks' statistics and P
    from the whole row may round an entry of P_used the other way), which
    D from the saved bf16 output breaks."""
    q, k, v, do = _qkv((2, 3, l, 6), seed=l) + [
        np.random.default_rng(l + 1).normal(size=(2, 3, l, 6)).astype(np.float32)]
    qt, kt, vt, dot = (_bf16(a)[0] for a in (q, k, v, do))
    if seed is None:
        keep, o = None, fa.flash_attention_reference(qt, kt, vt)
        ref = jax_fa._bwd_call(*(_bf16(a)[1] for a in (q, k, v, do)))
    else:
        keep = fa.attention_keep(2, 3, l, seed, RATE)
        o = fa.flash_attention_dropout_reference(qt, kt, vt, seed, RATE)
        ref = jax_fa._dropout_bwd_call(*(_bf16(a)[1] for a in (q, k, v)),
                                       jnp.asarray(seed, jnp.int32), RATE, _bf16(do)[1])
    *grads, stats = fa.attention_bwd_staged(qt, kt, vt, o, dot, keep)
    assert all(g.dtype == BF16 for g in grads) and stats.dtype == torch.float32
    _assert_grads_close(grads, fa._bwd_core(qt, kt, vt, dot, keep), rel=BF16_GRAD_REL)
    _assert_grads_close(grads, ref, rel=BF16_GRAD_REL)
    s = (qt.float() @ kt.float().transpose(-1, -2)) / 6**0.5
    m = s.amax(-1)
    p = torch.softmax(s, dim=-1)
    p_used = (p if keep is None else p * keep).to(BF16).float()
    d = (dot.double() * (p_used.double() @ vt.double())).sum(-1).float()
    want = torch.stack([m, torch.exp(s - m[..., None]).sum(-1)], dim=-1)
    torch.testing.assert_close(stats[..., :2], want, rtol=1e-5, atol=1e-5)
    assert fa.bf16_d_err_over_bound(stats[..., 2], d, qt, kt, vt, dot, keep).max() <= 1.0
    saved = (dot.float() * o.float()).sum(-1)
    assert fa.bf16_d_err_over_bound(saved, d, qt, kt, vt, dot, keep).max() > 1.0


def test_flash_attention_backward_takes_noncontiguous_heads() -> None:
    """The module hands in heads transposed out of (B, L, H, dh)."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
               for a in _qkv((2, 19, 4, 6), seed=6))
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    qc, kc, vc = (t.detach().contiguous().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(fa.flash_attention_reference(qc, kc, vc).sum(), (qc, kc, vc))
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _jax_attention_masks(batch: int, n_head: int, max_len: int, seed: int) -> np.ndarray:
    """The masks JAX's dropout kernels draw: ``_keep_scale`` per head group
    inside an interpret-mode Pallas call with one program per chain, as
    ``(B, H, L, L)``."""
    lp = -(-max_len // 128) * 128
    group = jax_fa._bwd_group(n_head, lp)
    n_groups = n_head // group

    def kernel(seed_ref, out_ref):
        for gi in range(n_groups):
            out_ref[0, gi] = jax_fa._keep_scale((group, lp, lp), RATE, seed_ref[0], gi * group)

    shape = (n_groups, group, lp, lp)
    spec = pl.BlockSpec((1,) + shape, lambda b, s: (b, 0, 0, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(batch,), in_specs=[], out_specs=spec),
        out_shape=jax.ShapeDtypeStruct((batch,) + shape, jnp.float32),
        interpret=True,
    )(jnp.asarray([seed], jnp.int32))
    return np.asarray(out).reshape(batch, n_head, lp, lp)[:, :, :max_len, :max_len]


@pytest.mark.parametrize(
    "l,seed,groups",
    [(100, 1234567, 1), (100, 2**31 - 2, 1), (365, 77, 3), (365, 2**31 - 2, 3)],
    ids=["L100", "L100-tag-wraps", "L365-three-groups", "L365-tag-wraps"],
)
def test_dropout_masks_match_jax_bit_for_bit(l: int, seed: int, groups: int) -> None:
    """B6's mask: tag ``seed + b*131071 + g0`` (no site term), bits at the
    head's (g, i, j) inside its group, one group of 12 at L=100, three of 4
    at L=365."""
    n_head = 12
    lp = -(-l // 128) * 128
    assert fa.attention_group(n_head, l) == jax_fa._bwd_group(n_head, lp) == n_head // groups
    ours = fa.attention_keep(2, n_head, l, seed, RATE).numpy()
    np.testing.assert_array_equal(ours, _jax_attention_masks(2, n_head, l, seed))
    # Near 2**31 the second chain's tag passes the int32 range, where JAX's
    # int32 sum wraps; both sides take the tag mod 2**32.
    assert abs(float(np.mean(ours > 0)) - (1 - RATE)) < 0.01


@pytest.mark.parametrize("l,seed", [(100, 2**31 - 2), (365, 99)], ids=["L100", "L365"])
def test_flash_attention_dropout_matches_jax(l: int, seed: int) -> None:
    """B6's plain versions: forward and dq, dk, dv against JAX's
    ``flash_attention_dropout`` in interpret mode."""
    q, k, v = _qkv((2, 12, l, 4), seed=7)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    jseed = jnp.asarray(seed, jnp.int32)
    out_ref, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention_dropout(a, b, c, jseed, RATE),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    before = (fa.dropout_fwd_launches, fa.dropout_bwd_launches)
    out, grads = _port_vjp(
        lambda a, b, c: fa.flash_attention_dropout(a, b, c, seed, RATE), q, k, v, do)
    assert (fa.dropout_fwd_launches, fa.dropout_bwd_launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **TOL["float32"])
    _assert_grads_close(grads, vjp(jnp.asarray(do)))


@pytest.mark.parametrize("l,seed", [(100, 2**31 - 2), (365, 99)], ids=["L100", "L365"])
def test_bf16_flash_attention_dropout_matches_jax(l: int, seed: int) -> None:
    """B6's plain versions in bf16 (the exact forward with P keep rounded
    to bf16, the backward ``_bwd_core`` with keep): the output and dq, dk,
    dv against JAX's ``flash_attention_dropout`` in bf16, interpret mode."""
    shape = (2, 12, l, 4)
    do = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    q, k, v, do = (_bf16(a) for a in (*_qkv(shape, seed=7), do))
    jseed = jnp.asarray(seed, jnp.int32)
    out_ref, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention_dropout(a, b, c, jseed, RATE),
                           q[1], k[1], v[1])
    qt, kt, vt = (a[0].requires_grad_(True) for a in (q, k, v))
    before = (fa.dropout_fwd_launches, fa.dropout_bwd_launches)
    out = fa.flash_attention_dropout(qt, kt, vt, seed, RATE)
    grads = torch.autograd.grad(out, (qt, kt, vt), do[0])
    assert (fa.dropout_fwd_launches, fa.dropout_bwd_launches) == before
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    np.testing.assert_allclose(_f32(out), _f32(out_ref), **TOL["bfloat16"])
    _assert_grads_close(grads, vjp(do[1]), rel=BF16_GRAD_REL)


def test_dropout_seed_may_be_a_tensor() -> None:
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 4, 19, 6), seed=9))
    a = fa.flash_attention_dropout(q, k, v, 2**31 - 7, RATE)
    b = fa.flash_attention_dropout(q, k, v, torch.tensor([2**31 - 7]), RATE)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rate"):
        fa.flash_attention_dropout(q, k, v, 1, 1.0)


def test_flash_attention_checks_inputs() -> None:
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 5, 6)))
    with pytest.raises(ValueError, match="B, H, L, dh"):
        fa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="k is"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())


def test_module_eval_mode_draws_nothing() -> None:
    """In eval mode the module draws no dropout, whatever its rate: the
    generator it is handed stays where it was, and the output is the JAX
    module's deterministic forward."""
    jmodel, variables, model = jax_and_port_models(19, 1, dropout_rate=0.5)
    x, t = (torch.from_numpy(a) for a in numpy_inputs(2, 19, 1))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x.numpy()), jnp.asarray(t.numpy())))
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    with torch.no_grad():
        a = model(x, t, g)
        b = model(x, t)
    assert torch.equal(g.get_state(), state)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(a.numpy(), ref, **TOL["float32"])


def test_module_training_mode_draws_from_the_generator() -> None:
    _, _, model = jax_and_port_models(19, 1, dropout_rate=0.3)
    model.train()
    x, t = (torch.from_numpy(a) for a in numpy_inputs(2, 19, 1))
    with torch.no_grad():
        a = model(x, t, torch.Generator().manual_seed(1))
        b = model(x, t, torch.Generator().manual_seed(1))
        c = model(x, t, torch.Generator().manual_seed(2))
        model.eval()
        d = model(x, t)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, d)
