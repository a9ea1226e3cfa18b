"""The port's CUDA kernel on the card: every test here is marked ``cuda``
and skips where no CUDA device is present (the kernel has no CPU mode).

This file imports only ``torch`` and the port, so it runs on a machine
without JAX. There, from the repository root::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)

Tolerances, as in ``chip_smoke.py``: the kernel against its plain version,
1e-4 in fp32 (fp32 sums in other orders) and 2**-4 in bf16 (one flipped
rounding of an intermediate moves an output by about one bf16 ulp).
"""

from __future__ import annotations

import pytest
import torch

from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-4}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(d: int, n_head: int, d_ff: int, dtype: torch.dtype, device) -> dict:
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, d_ff)
    return {k: v.to(device) for k, v in fe.pack_encoder_layer(layer, n_head, dtype).items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize(
    "b,l,d,n_head,d_ff",
    [(5, 19, 24, 4, 64), (3, 100, 72, 12, 2048), (2, 187, 72, 12, 2048), (4, 33, 48, 4, 300)],
)
def test_kernel_matches_plain(cuda, dtype, b, l, d, n_head, d_ff) -> None:
    packed = _layer(d, n_head, d_ff, dtype, cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, l, d, generator=g).to(cuda, dtype)
    before = fe.launches
    out = fe.fused_encoder_layer(x, packed, n_head=n_head)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    ref = fe.fused_encoder_layer_reference(x, packed, n_head)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_noncontiguous_input(cuda) -> None:
    packed = _layer(24, 4, 64, torch.float32, cuda)
    x = torch.randn(19, 5, 24, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_encoder_layer(x, packed, n_head=4)


def test_fused_forward_matches_unfused_module(cuda) -> None:
    torch.manual_seed(2)
    model = ScoreModelConfig(
        d_model=24, n_head=4, num_layers=2, dim_feedforward=64
    ).build(3, 19).to(cuda).eval()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 19, 3, generator=g).to(cuda)
    t = torch.rand(4, generator=g).to(cuda)
    with torch.no_grad():
        fused = fused_score_forward(model, pack_score_transformer(model), x, t)
        plain = model(x, t)
    assert (fused - plain).abs().max().item() <= 1e-4
