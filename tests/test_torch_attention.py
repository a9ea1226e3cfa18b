"""Port parity of the attention forward (``ops/flash_attention.py``) against
the JAX package's ``flash_attention``, on the CPU.

The JAX side runs its Pallas forward kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port's wrapper, given CPU
tensors, runs its plain PyTorch version. The kernel itself runs only on a
CUDA card (``tests/test_torch_cuda.py``).

Tolerances: fp32 1e-5 absolute and relative (the same arithmetic, summed
in other orders). bf16 2**-5 absolute on outputs of size up to ~2: both
round q, P and O to bf16 at the same points, and a different fp32 sum
order can flip one rounding, which moves an output by one bf16 ulp
(2**-7 to 2**-6 at these sizes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models, numpy_inputs

from fourierdiffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from fourierdiffusion_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2.0**-5, rtol=0.0)}


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


def test_flash_attention_refuses_gradients() -> None:
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv((1, 2, 5, 6)))
    with pytest.raises(RuntimeError, match="B5"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == q.shape


def test_flash_attention_checks_inputs() -> None:
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 5, 6)))
    with pytest.raises(ValueError, match="B, H, L, dh"):
        fa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="k is"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())


def test_module_forward_draws_no_dropout() -> None:
    """The unfused module never draws dropout, whatever its rate: it matches
    the JAX module's deterministic forward, and two calls agree exactly."""
    jmodel, variables, model = jax_and_port_models(19, 1, dropout_rate=0.5)
    x, t = numpy_inputs(2, 19, 1)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(t))
        b = model(torch.from_numpy(x), torch.from_numpy(t))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(a.numpy(), ref, **TOL["float32"])
