"""The port's CUDA kernels on the card: every test here is marked ``cuda``
and skips where no CUDA device is present (the kernels have no CPU mode).

This file imports only ``torch`` and the port, so it runs on a machine
without JAX. There, from the repository root::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)

Tolerances, as in ``chip_smoke.py``: a kernel's output against its plain
version, 1e-4 in fp32 (fp32 sums in other orders) and 2**-4 in bf16 (one
flipped rounding of an intermediate moves an output by about one bf16 ulp);
the backward kernels' gradients 1e-3 of each tensor's largest gradient
(sums over up to 64 x 365 positions, in other orders); the dropout masks
bit for bit.

The int8 kernels B7 and B8 are held to their plain versions run with the
kernel's own int8 codes put in (``fused_encoder.locate_code_flips``), with
B1's tolerances. Every code where the two versions part is located: in fp32
each lies within 1e-3 of a rounding boundary (k + 1/2) in code units (the
two versions' fp32 inputs to a quantization differ by sums in other orders,
~1e-6 relative, so ~1e-4 codes) and moves by one; in bf16 at most 1 % of a
site's codes flip (an upstream bf16 rounding that flipped, as B1 has, moves
a quantizer's input by up to about a code). The sites whose inputs the two
versions compute alike (x, and V from exact integer sums) flip nowhere.

B1, B2, B3, B4 and B5/B6-bwd run on the tensor cores
(``csrc/mma_tile.cuh``). B2 is checked at L 24 to 365 and dh 6 to 64, fp32
and bf16, and up to L 3616 (in bf16 to 4 ulps of its largest output,
``B2_BF16_ULPS``); B5 and B6-bwd up to L 3616 and at dh 16 and 64, and two
calls bit for bit; B6-fwd (B2's kernel with the keep factors) up to L
3616 and at L 2048, dh 16; B5, B6-fwd and B6-bwd in bf16 at the same
shapes against their plain bf16 versions (outputs to B2_BF16_ULPS ulps of
the largest, gradients to BF16_ATTN_GRAD_TOL of each tensor's largest,
launch 1's statistics against the bf16 staged plain backward), and the
unfused trainer in bf16 through them; the forward's forms (streamed through
the ring, the head resident, S kept in registers) bit for bit against each
other for B2, B6-fwd and B3's attention launch, at the edges of each; B3 at rate 0 and 0.1
at every shape B4 is checked at, and a repeated B3 call bit for bit. B1 is checked
where a row tile holds one row, one chain or straddles chains, B4's stages
against the staged plain backward (``train_backward_staged``, flipped ReLU
gates located within 1e-5 of the sum of |terms| of 0 and matched), a
repeated B4 call bit for bit (bf16 too), and both at layers wider than
the tail's register tiles (d_model 264 to 384; B1 at head widths up to
384, B3 and B4 up to 64, the widest their attention stages take). B3's and
B4's attention stages are ``csrc/attention_mma.cuh``'s kernels on
``mma.sync`` (``torch.profiler``'s kernel names of one call, fp32 and bf16).

The long sequences of the real datasets (NASA L=251, NASDAQ 252,
USDroughts 365 at d_model 72) and the d_model 128 shapes at ECG's L=187
(``configs/score_model/fast.yaml`` F 2048, ``fast512.yaml`` F 512) take the
layer kernels' device-memory workspaces.
"""

from __future__ import annotations

import math

import pytest
import torch

from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-4}
# (b, l, d, n_head, d_ff) of the long sequences and the wide layers.
LONG_SHAPES = [(2, 251, 72, 12, 2048), (2, 252, 72, 12, 2048), (2, 365, 72, 12, 2048),
               (2, 187, 128, 8, 2048), (2, 187, 128, 8, 512)]
LONG_IDS = ["L251", "L252", "L365", "D128-F2048", "D128-F512"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(d: int, n_head: int, d_ff: int, dtype: torch.dtype, device, level: int = 0) -> dict:
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, d_ff)
    packed = fe.pack_encoder_layer(layer, n_head, dtype, int8_ffn=level >= 1,
                                   int8_attn=level >= 2)
    return {k: v.to(device) for k, v in packed.items()}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", LONG_SHAPES, ids=LONG_IDS)
def test_kernel_matches_plain_on_long_sequences(cuda, dtype, b, l, d, n_head, d_ff) -> None:
    test_kernel_matches_plain(cuda, dtype, b, l, d, n_head, d_ff)


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


SHAPES = [(5, 19, 24, 4, 64), (4, 100, 72, 12, 2048), (2, 187, 72, 12, 2048)]
SHAPE_IDS = ["L19", "L100", "L187"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", SHAPES, ids=SHAPE_IDS)
def test_attention_kernel_matches_plain(cuda, dtype, b, l, d, n_head, d_ff) -> None:
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(b, n_head, l, d // n_head, generator=g).to(cuda, dtype)
               for _ in range(3))
    before = fa.launches
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _train_layer(d, n_head, d_ff, device):
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, d_ff).to(device)
    return {k: t.detach().requires_grad_(True)
            for k, t in fet.pack_encoder_layer_train(layer, n_head).items()}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l,d,n_head,d_ff", SHAPES, ids=SHAPE_IDS)
def test_training_kernels_match_plain(cuda, rate, b, l, d, n_head, d_ff) -> None:
    packed = _train_layer(d, n_head, d_ff, cuda)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, l, d, generator=g).to(cuda).requires_grad_(True)
    dy = torch.randn(b, l, d, generator=g).to(cuda)
    seed = 2**31 - 5
    before = (fet.fwd_launches, fet.bwd_launches)
    out = fet.fused_encoder_layer_train(x, packed, seed, n_head=n_head, rate=rate)
    grads = torch.autograd.grad(out, [x, *packed.values()], dy)
    torch.cuda.synchronize()
    assert (fet.fwd_launches, fet.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = fet.fused_encoder_layer_train_reference(x, packed, seed, n_head=n_head, rate=rate)
    ref_grads = torch.autograd.grad(ref, [x, *packed.values()], dy)
    assert (out - ref).abs().max().item() <= 1e-4
    for name, got, want in zip(["x", *packed], grads, ref_grads):
        rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)
        assert rel <= 1e-3, (name, rel)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l,d,n_head,d_ff", LONG_SHAPES, ids=LONG_IDS)
def test_training_kernels_match_plain_on_long_sequences(cuda, rate, b, l, d, n_head,
                                                        d_ff) -> None:
    test_training_kernels_match_plain(cuda, rate, b, l, d, n_head, d_ff)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_layer_results_do_not_depend_on_the_batch(cuda, dtype) -> None:
    """The tail groups a row's FFN sums by the d_ff chunk alone: chains 0-15
    of one B1 call at 32 chains are bit for bit the same chains called
    alone, and chains 0-31 of one B3 call at 64 chains, and the ReLU gates
    B4's recompute takes there, those of a call at 32."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(72, 12, 2048).to(cuda)
    g = torch.Generator().manual_seed(12)
    h = torch.randn(32, 100, 72, generator=g).to(cuda, dtype)
    packed = fe.pack_encoder_layer(layer, 12, dtype)
    with torch.no_grad():
        whole = fe.fused_encoder_layer(h, packed, n_head=12)[:16]
        alone = fe.fused_encoder_layer(h[:16].contiguous(), packed, n_head=12)
    assert torch.equal(whole, alone)
    lay = {k: t.detach() for k, t in fet.pack_encoder_layer_train(layer, 12, dtype).items()}
    x = torch.randn(64, 100, 72, generator=g).to(cuda, dtype)
    dy = torch.randn(64, 100, 72, generator=g).to(cuda, dtype)
    assert torch.equal(fet._launch_fwd(x, lay, 7, 12, 0.1)[:32],
                       fet._launch_fwd(x[:32].contiguous(), lay, 7, 12, 0.1))
    gates = fet._launch_bwd(x, dy, lay, 7, 12, 0.1, stages=True)[2]["gates"][:32]
    assert torch.equal(gates, fet._launch_bwd(x[:32].contiguous(), dy[:32].contiguous(), lay,
                                              7, 12, 0.1, stages=True)[2]["gates"])


@pytest.mark.parametrize("b,l,d,n_head,d_ff", SHAPES + LONG_SHAPES[2:], ids=SHAPE_IDS +
                         LONG_IDS[2:])
def test_bf16_training_kernels_match_plain(cuda, b, l, d, n_head, d_ff) -> None:
    """B3 and B4 in bf16 against their plain bf16 versions: the output to
    2**-4; B4's dx and gradients to 2**-5 of each tensor's largest against
    the staged plain backward with the kernel's ReLU gates (``chip_smoke.py``
    phase 20 says why); the gradients the wrapper returns for the weight
    matrices bf16, for the vectors fp32."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, d_ff).to(cuda)
    packed = {k: t.detach().requires_grad_(True) for k, t in
              fet.pack_encoder_layer_train(layer, n_head, torch.bfloat16).items()}
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, l, d, generator=g).to(cuda, torch.bfloat16).requires_grad_(True)
    dy = torch.randn(b, l, d, generator=g).to(cuda, torch.bfloat16)
    seed = 2**31 - 5
    out = fet.fused_encoder_layer_train(x, packed, seed, n_head=n_head, rate=0.1)
    grads = torch.autograd.grad(out, [x, *packed.values()], dy)
    ref = fet.fused_encoder_layer_train_reference(x, packed, seed, n_head=n_head, rate=0.1)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    lay = {k: t.detach() for k, t in packed.items()}
    xd = x.detach()
    _, _, ws = fet._launch_bwd(xd, dy, lay, seed, n_head, 0.1, stages=True)
    _, _, plain = fet.train_backward_staged(xd, dy, lay, seed, n_head=n_head, rate=0.1)
    kept = fet.dropout_masks(b, l, d, d_ff, n_head, seed, 0.1, cuda)["ff"] > 0
    gates = ws["gates"] | (~kept & plain["gates"])
    ref_dx, ref_grads, _ = fet.train_backward_staged(xd, dy, lay, seed, n_head=n_head,
                                                     rate=0.1, gates=gates)
    for name, got, want in zip(["x", *packed], grads, [ref_dx, *ref_grads]):
        assert got.dtype == (torch.bfloat16 if name in ("x", "w_qkv", "w_out", "w1", "w2")
                             else torch.float32), name
        rel = (got.float() - want.float()).abs().max().item() / max(
            want.float().abs().max().item(), 1e-6)
        assert rel <= 2.0**-5, (name, rel)


def test_training_forward_is_bit_identical_across_calls(cuda) -> None:
    """B3 sums every product and the tail's partials in one fixed order."""
    lay = {k: t.detach() for k, t in _train_layer(72, 12, 2048, cuda).items()}
    x = torch.randn(64, 100, 72, generator=torch.Generator().manual_seed(10)).to(cuda)
    before = fet.fwd_launches
    first = fet._launch_fwd(x, lay, 7, 12, 0.1)
    second = fet._launch_fwd(x, lay, 7, 12, 0.1)
    torch.cuda.synchronize()
    assert fet.fwd_launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,l,d,n_head,d_ff", SHAPES + LONG_SHAPES[2:3], ids=SHAPE_IDS + ["L365"])
def test_kernel_masks_are_bit_identical(cuda, b, l, d, n_head, d_ff) -> None:
    args = (b, l, d, d_ff, n_head, 2**31 - 2, 0.1)
    ours = fet.dropout_masks_cuda(*args, device=cuda)
    ref = fet.dropout_masks(*args, device=cuda)
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key


# ---- the tensor-core redesigns of B1 and B4 --------------------------------------------

SMALL = [(b, l) for b in (1, 3) for l in (1, 17)] + [(32, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l", SMALL, ids=[f"B{b}-L{l}" for b, l in SMALL])
def test_tensor_core_layer_matches_plain_at_small_shapes(cuda, dtype, b, l) -> None:
    """B1 where a row tile holds one chain, straddles chains, or is one row."""
    test_kernel_matches_plain(cuda, dtype, b, l, 72, 12, 2048)


@pytest.mark.parametrize("b,l", SMALL, ids=[f"B{b}-L{l}" for b, l in SMALL])
def test_tensor_core_backward_matches_plain_at_small_shapes(cuda, b, l) -> None:
    test_training_kernels_match_plain(cuda, 0.1, b, l, 72, 12, 2048)


@pytest.mark.parametrize("b,l,d,n_head,d_ff", [(3, 17, 24, 4, 300), (64, 100, 72, 12, 2048),
                                               (2, 17, 384, 6, 512)],
                         ids=["L17-F300", "flagship", "wide"])
def test_backward_stages_match_the_staged_plain_version(cuda, b, l, d, n_head, d_ff) -> None:
    """B4's workspace after each stage (dF2, dx1, da, dqkv), dx and the
    gradients against ``train_backward_staged``, each to 1e-3 of its largest.
    A ReLU gate of the FFN whose input lies within rounding of 0 may open in
    one and stay shut in the other (see ``chip_smoke.py``, GATE_BAND): each
    such flip is located, must lie within 1e-5 of the sum of |terms| of 0,
    and the staged version then takes the kernel's gates."""
    lay = {k: t.detach() for k, t in _train_layer(d, n_head, d_ff, cuda).items()}
    g = torch.Generator().manual_seed(8)
    x, dy = (torch.randn(b, l, d, generator=g).to(cuda) for _ in range(2))
    dx, grads, stages = fet._launch_bwd(x, dy, lay, 99, n_head, 0.1, stages=True)
    torch.cuda.synchronize()
    _, _, plain = fet.train_backward_staged(x, dy, lay, 99, n_head=n_head, rate=0.1)
    kept = fet.dropout_masks(b, l, d, d_ff, n_head, 99, 0.1, cuda)["ff"] > 0
    flips = (stages["gates"] != plain["gates"]) & kept
    if flips.any():
        x1 = fet.attention_sublayer(x.double(), {k: t.double() for k, t in lay.items()},
                                    fet.dropout_masks(b, l, d, d_ff, n_head, 99, 0.1, cuda),
                                    n_head)
        pre = x1 @ lay["w1"].double() + lay["b1"].double()
        terms = x1.abs() @ lay["w1"].double().abs() + lay["b1"].double().abs()
        assert (pre.abs() <= 1e-5 * terms)[flips].all()
        assert int(flips.sum()) <= 16
    ref_dx, ref_grads, ref_stages = fet.train_backward_staged(
        x, dy, lay, 99, n_head=n_head, rate=0.1, gates=stages["gates"] | (~kept & plain["gates"]))
    for name in ("df2", "dx1", "da", "dqkv"):
        assert _rel(stages[name], ref_stages[name]) <= 1e-3, name
    for name, got, want in zip(["x", *fet.LAYER_KEYS], [dx, *grads], [ref_dx, *ref_grads]):
        assert _rel(got, want) <= 1e-3, name


def test_backward_is_bit_identical_across_calls(cuda) -> None:
    lay = {k: t.detach() for k, t in _train_layer(72, 12, 2048, cuda).items()}
    g = torch.Generator().manual_seed(9)
    x, dy = (torch.randn(64, 100, 72, generator=g).to(cuda) for _ in range(2))
    first = fet._launch_bwd(x, dy, lay, 5, 12, 0.1)
    second = fet._launch_bwd(x, dy, lay, 5, 12, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for a, b_ in zip(first[1], second[1]):
        assert torch.equal(a, b_)


def test_backward_events_match_the_kernels_stages(cuda) -> None:
    assert fet._library().fdiff_train_bwd_stages() == len(fet.BWD_STAGES)


# ---- the training layer's attention stages on mma.sync ----------------------------------

MMA_ATTENTION = ("attention_fwd_mma_kernel", "attention_bwd_dq_mma_kernel",
                 "attention_bwd_dkv_mma_kernel")
CUDA_CORE_ATTENTION = ("attention_fwd_kernel<", "attention_bwd_dq_kernel<",
                       "attention_bwd_dkv_kernel<")


def _kernel_names(fn) -> list[str]:
    """The CUDA kernels one call of ``fn`` runs, from ``torch.profiler``; the
    trace opens with spin kernels, which a trace may lose (``chip_smoke.py``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0 and "spin_kernel" not in e.key]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_training_attention_runs_on_mma_kernels(cuda, dtype) -> None:
    """B3's attention stage is ``csrc/attention_mma.cuh``'s forward and B4's
    its forward (the recompute) and both backward launches: no thread per
    query row or key, on the flagship's shape in both dtypes."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(72, 12, 2048).to(cuda)
    lay = {k: t.detach() for k, t in fet.pack_encoder_layer_train(layer, 12, dtype).items()}
    g = torch.Generator().manual_seed(14)
    x, dy = (torch.randn(64, 100, 72, generator=g).to(cuda, dtype) for _ in range(2))
    b3 = _kernel_names(lambda: fet._launch_fwd(x, lay, 7, 12, 0.1))
    b4 = _kernel_names(lambda: fet._launch_bwd(x, dy, lay, 7, 12, 0.1))
    assert any(MMA_ATTENTION[0] in k for k in b3), b3
    for f in MMA_ATTENTION:
        assert any(f in k for k in b4), (f, b4)
    assert not [k for k in b3 + b4 if any(f in k for f in CUDA_CORE_ATTENTION)]


@pytest.mark.parametrize("b,l,d,n_head,d_ff", [(64, 100, 72, 12, 2048), (2, 187, 128, 8, 2048)],
                         ids=["L100", "D128"])
def test_bf16_training_kernels_repeat_bit_for_bit(cuda, b, l, d, n_head, d_ff) -> None:
    """B3 and B4 in bf16 sum every product, the attention stages' rows
    included, in one fixed order with no atomics."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, d_ff).to(cuda)
    lay = {k: t.detach() for k, t in
           fet.pack_encoder_layer_train(layer, n_head, torch.bfloat16).items()}
    g = torch.Generator().manual_seed(15)
    x, dy = (torch.randn(b, l, d, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    assert torch.equal(fet._launch_fwd(x, lay, 9, n_head, 0.1),
                       fet._launch_fwd(x, lay, 9, n_head, 0.1))
    first = fet._launch_bwd(x, dy, lay, 9, n_head, 0.1)
    second = fet._launch_bwd(x, dy, lay, 9, n_head, 0.1)
    torch.cuda.synchronize()
    for a, b_ in zip([first[0], *first[1]], [second[0], *second[1]]):
        assert torch.equal(a, b_)


# Layers wider than the tail's 256 register columns (the wide tail, five
# launches through device memory), with head widths of 22, 95 and 384.
WIDE_SHAPES = [(3, 17, 264, 12, 1024), (2, 17, 380, 4, 512), (2, 9, 384, 1, 512)]
WIDE_IDS = ["D264", "D380", "D384-H1"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", WIDE_SHAPES, ids=WIDE_IDS)
def test_wide_layer_matches_plain(cuda, dtype, b, l, d, n_head, d_ff) -> None:
    test_kernel_matches_plain(cuda, dtype, b, l, d, n_head, d_ff)


# The same widths for the training layer, whose attention stages
# (csrc/attention_mma.cuh, B2's and B5's instances) take head widths up to
# 64 and refuse wider ones (tests/test_torch_launch_plans.py): 22, 38, 64.
WIDE_TRAIN_SHAPES = [(3, 17, 264, 12, 1024), (2, 17, 380, 10, 512), (2, 9, 384, 6, 512)]
WIDE_TRAIN_IDS = ["D264", "D380-H10", "D384-H6"]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l,d,n_head,d_ff", WIDE_TRAIN_SHAPES, ids=WIDE_TRAIN_IDS)
def test_wide_training_layer_matches_plain(cuda, rate, b, l, d, n_head, d_ff) -> None:
    """B3 and B4 run their wide tails (7 and 20 launches)."""
    assert fet.train_fwd_plan(b, l, d, n_head, d_ff)["launches"] == 7
    test_training_kernels_match_plain(cuda, rate, b, l, d, n_head, d_ff)


# B2 at the lengths of the datasets (MIMIC 24, the synthetic runs 100, ECG
# 187, USDroughts 365) and the head widths of the shipped configurations (6,
# 12, 16) and the widest the kernel takes (64): fp32, and bf16 in its fast
# (dh < 16) and exact forms.
B2_LENGTHS = (24, 100, 187, 365)
B2_WIDTHS = (6, 12, 16, 64)
# ... and at the longest L that fits a head's K and V in fp32 plus four rows
# of scores in 232,448 bytes of shared memory, (58,112 - 256) / (2 dh + 4):
# the lengths a forward that stages the whole head serves. B2 streams its
# key blocks, so shared memory bounds no length.
B2_LONG = {6: 3616, 12: 2066, 16: 1607, 64: 438}
# B2 in bf16 against its plain version: both round P and O at the same
# points, and a rounding that flips between their fp32 sum orders moves an
# output by about one bf16 ulp of |o| (the card's largest: 2**-9, at L 187
# and dh 6). Attention outputs on random heads are far below LayerNorm's
# |y| < 8, where TOL's 2**-4 could hide a lost key block, so the tolerance
# is B2_BF16_ULPS ulps of the largest |o| of the plain version.
B2_BF16_ULPS = 4


def b2_tol(dtype: torch.dtype, ref: torch.Tensor) -> float:
    if dtype == torch.float32:
        return TOL[dtype]
    top = ref.float().abs().max().item()
    return B2_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def _attention_forward_matches_plain(cuda, dtype, b, h, l, dh) -> None:
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).to(cuda, dtype) for _ in range(3))
    before = fa.launches
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out.float()).all()
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= b2_tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", B2_WIDTHS, ids=[f"dh{d}" for d in B2_WIDTHS])
@pytest.mark.parametrize("l", B2_LENGTHS, ids=[f"L{l}" for l in B2_LENGTHS])
def test_attention_forward_matches_plain_at_every_shape(cuda, dtype, dh, l) -> None:
    _attention_forward_matches_plain(cuda, dtype, 3, 2, l, dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", sorted(B2_LONG), ids=[f"dh{d}" for d in sorted(B2_LONG)])
def test_attention_forward_matches_plain_at_long_lengths(cuda, dtype, dh) -> None:
    _attention_forward_matches_plain(cuda, dtype, 1, 2, B2_LONG[dh], dh)


def _attention_grads(fn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    return out, torch.autograd.grad(out, (q, k, v), do)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)


# B5/B6-bwd's shapes, (B, H, L, dh): the flagship's, USDroughts' L, a short
# L; L=896 at dh 16 (the longest L JAX's _bwd_kernel serves there, which the
# port's previous backward, staging the whole head, refused from L=775),
# and the long heads B2 is checked at.
BWD_SHAPES = [(64, 12, 100, 6), (8, 12, 365, 6), (3, 12, 19, 6), (1, 8, 896, 16),
              (1, 12, 3616, 6), (1, 2, 438, 64)]
BWD_IDS = ["L100", "L365", "L19", "L896-dh16", "L3616", "L438-dh64"]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,l,dh", BWD_SHAPES, ids=BWD_IDS)
def test_attention_backward_kernels_match_plain(cuda, rate, b, h, l, dh) -> None:
    """B5 (rate 0) and B6 (rate 0.1), forward and backward, against their
    plain versions, on heads transposed out of (B, L, H, dh) as the module
    hands them in."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(b, l, h, dh, generator=g).to(cuda).transpose(1, 2)
               for _ in range(3))
    do = torch.randn(b, h, l, dh, generator=g).to(cuda)
    seed = 2**31 - 3
    if rate:
        kernel = lambda *t: fa.flash_attention_dropout(*t, seed, rate)  # noqa: E731
        plain = lambda *t: fa.flash_attention_dropout_reference(*t, seed, rate)  # noqa: E731
        counts = ("dropout_fwd_launches", "dropout_bwd_launches")
    else:
        kernel, plain = fa.flash_attention, fa.flash_attention_reference
        counts = ("launches", "bwd_launches")
    before = [getattr(fa, c) for c in counts]
    out, grads = _attention_grads(kernel, q, k, v, do)
    torch.cuda.synchronize()
    assert [getattr(fa, c) for c in counts] == [n + 1 for n in before]
    ref, ref_grads = _attention_grads(plain, q, k, v, do)
    assert (out - ref).abs().max().item() <= 1e-4
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert _rel(got, want) <= 1e-3, name
    if rate:
        ref_bwd = fa.flash_attention_dropout_bwd_reference(q, k, v, do, seed, rate)
        assert fa.dropout_bwd_launches == before[1] + 1
    else:
        ref_bwd = fa.flash_attention_bwd_reference(q, k, v, do)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_bwd):
        assert _rel(got, want) <= 1e-3, name


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["B5", "B6-bwd"])
@pytest.mark.parametrize("b,h,l,dh", [(8, 12, 100, 6), (2, 8, 187, 16)], ids=["L100", "L187"])
def test_attention_backward_repeats_bit_for_bit(cuda, rate, b, h, l, dh) -> None:
    """Two calls of B5 (and of B6-bwd) on the same inputs give the same bits
    (every sum in one fixed order, no atomics), each call counts one launch
    of its wrapper, and launch 1's row statistics (max, sum, D = dO . O)
    agree with the staged plain version to 1e-4 of each one's largest."""
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(b, h, l, dh, generator=g).to(cuda) for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda) if rate else None
    keep = fa.attention_keep(b, h, l, seed, rate, cuda) if rate else None
    o = (fa.flash_attention_dropout_reference(q, k, v, seed, rate) if rate
         else fa.flash_attention_reference(q, k, v))
    count = "dropout_bwd_launches" if rate else "bwd_launches"
    before = getattr(fa, count)
    first = fa._launch_bwd(q, k, v, o, do, seed, rate)
    second = fa._launch_bwd(q, k, v, o, do, seed, rate)
    torch.cuda.synchronize()
    assert getattr(fa, count) == before + 2
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    staged = fa.attention_bwd_staged(q, k, v, o, do, keep)
    for i in range(fa.STAT_COLS):
        assert _rel(first[3][..., i], staged[3][..., i]) <= 1e-4, i
    for name, got, want in zip(("dq", "dk", "dv"), first, staged):
        assert _rel(got, want) <= 1e-3, name


# B6-fwd, B2's kernel with the keep factors, at the flagship's heads,
# USDroughts' L, L=2048 at dh 16 (its earlier body staged the whole head and
# refused L > 1607 there) and the longest L B2 is checked at.
DROPOUT_FWD_SHAPES = [(64, 12, 100, 6), (8, 12, 365, 6), (1, 8, 2048, 16), (1, 12, 3616, 6)]
DROPOUT_FWD_IDS = ["L100", "L365", "L2048-dh16", "L3616"]


@pytest.mark.parametrize("b,h,l,dh", DROPOUT_FWD_SHAPES, ids=DROPOUT_FWD_IDS)
def test_dropout_forward_matches_plain_at_every_length(cuda, b, h, l, dh) -> None:
    """B6-fwd against ``flash_attention_dropout_reference`` (fp32, 1e-4),
    one launch per call, and its masks bit for bit those of the plain
    version."""
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).to(cuda) for _ in range(3))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda)
    before = fa.dropout_fwd_launches
    with torch.no_grad():
        out = fa.flash_attention_dropout(q, k, v, seed, 0.1)
    torch.cuda.synchronize()
    assert fa.dropout_fwd_launches == before + 1
    ref = fa.flash_attention_dropout_reference(q, k, v, seed, 0.1)
    assert torch.isfinite(out).all() and (out - ref).abs().max().item() <= TOL[torch.float32]
    assert torch.equal(fa.attention_keep_cuda(b, h, l, seed, 0.1, device=cuda),
                       fa.attention_keep(b, h, l, seed, 0.1, device=cuda))


# B5, B6-fwd and B6-bwd in bf16 against their plain bf16 versions (which
# round P keep, P_used and dS to bf16 where the kernels and JAX's kernels
# do): dq, dk, dv to BF16_ATTN_GRAD_TOL of each tensor's largest (a rounding
# that flips between their fp32 sum orders moves an entry by one bf16 ulp
# of itself: four ulps of the largest, as B2_BF16_ULPS for outputs).
BF16_ATTN_GRAD_TOL = 2.0**-6


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["B5", "B6"])
@pytest.mark.parametrize("b,h,l,dh", BWD_SHAPES, ids=BWD_IDS)
def test_bf16_attention_kernels_match_plain(cuda, rate, b, h, l, dh) -> None:
    """B2 (fast form at dh < 16) and B5 at rate 0, B6-fwd and B6-bwd at 0.1,
    in bf16 on heads transposed out of (B, L, H, dh): the output and dq, dk,
    dv (bf16) against the plain versions, one launch of each wrapper."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(b, l, h, dh, generator=g).to(cuda, torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    do = torch.randn(b, h, l, dh, generator=g).to(cuda, torch.bfloat16)
    seed = 2**31 - 3
    if rate:
        kernel = lambda *t: fa.flash_attention_dropout(*t, seed, rate)  # noqa: E731
        plain = lambda *t: fa.PlainAttentionDropout.apply(*t, seed, rate)  # noqa: E731
        counts = ("dropout_fwd_launches", "dropout_bwd_launches")
    else:
        kernel, plain = fa.flash_attention, fa.PlainAttention.apply
        counts = ("launches", "bwd_launches")
    before = [getattr(fa, c) for c in counts]
    out, grads = _attention_grads(kernel, q, k, v, do)
    torch.cuda.synchronize()
    assert [getattr(fa, c) for c in counts] == [n + 1 for n in before]
    ref, ref_grads = _attention_grads(plain, q, k, v, do)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in grads)
    assert (out.float() - ref.float()).abs().max().item() <= b2_tol(torch.bfloat16, ref)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got.float(), want.float()) <= BF16_ATTN_GRAD_TOL, name


# bf16 B5 and B6-bwd where launch 1 keeps S in registers (L=100), holds the
# head resident (L=187; L=896, the longest JAX's backward serves at dh 16)
# and streams it through the ring (L=1280, past the resident limit of 1152
# at dh 16).
BF16_BWD_FORM_SHAPES = [(8, 12, 100, 6), (2, 8, 187, 16), (1, 8, 896, 16), (1, 8, 1280, 16)]
BF16_BWD_FORM_IDS = ["L100-kept", "L187", "L896-resident", "L1280-ring"]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["B5", "B6-bwd"])
@pytest.mark.parametrize("b,h,l,dh", BF16_BWD_FORM_SHAPES, ids=BF16_BWD_FORM_IDS)
def test_bf16_attention_backward_repeats_bit_for_bit(cuda, rate, b, h, l, dh) -> None:
    """Two calls of the bf16 B5 (and B6-bwd) give the same bits; launch 1's
    row statistics against the bf16 staged plain backward (m and l to 1e-4
    of the largest; D, from O = P_used v recomputed, within
    ``bf16_d_err_over_bound``'s bound of it, which D from the output the
    backward is given breaks); dq, dk, dv against it and against the plain
    version to BF16_ATTN_GRAD_TOL."""
    plan = fa.attention_bwd_plan(l, dh, torch.bfloat16)
    assert (plan["kept"], plan["resident"]) == {100: (1, 1), 1280: (0, 0)}.get(l, (0, 1))
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(b, h, l, dh, generator=g).to(cuda, torch.bfloat16)
                   for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda) if rate else None
    keep = fa.attention_keep(b, h, l, seed, rate, cuda) if rate else None
    o = (fa.flash_attention_dropout_reference(q, k, v, seed, rate) if rate
         else fa.flash_attention_reference(q, k, v))
    first = fa._launch_bwd(q, k, v, o, do, seed, rate)
    second = fa._launch_bwd(q, k, v, o, do, seed, rate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    staged = fa.attention_bwd_staged(q, k, v, o, do, keep)
    for i in range(2):
        assert _rel(first[3][..., i], staged[3][..., i]) <= 1e-4, i
    d = staged[3][..., 2]
    assert fa.bf16_d_err_over_bound(first[3][..., 2], d, q, k, v, do, keep).max() <= 1.0
    saved = (do.float() * o.float()).sum(-1)
    assert fa.bf16_d_err_over_bound(saved, d, q, k, v, do, keep).max() > 1.0
    for name, got, want in zip(("dq", "dk", "dv"), first, staged):
        assert _rel(got.float(), want.float()) <= BF16_ATTN_GRAD_TOL, name
    plain = (fa.flash_attention_dropout_bwd_reference(q, k, v, do, seed, rate) if rate
             else fa.flash_attention_bwd_reference(q, k, v, do))
    for name, got, want in zip(("dq", "dk", "dv"), first, plain):
        assert _rel(got.float(), want.float()) <= BF16_ATTN_GRAD_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["B5", "B6-bwd"])
@pytest.mark.parametrize("b,h,l,dh", BF16_BWD_FORM_SHAPES[:3] + [(1, 2, 438, 64)],
                         ids=BF16_BWD_FORM_IDS[:3] + ["L438-dh64"])
def test_attention_backward_forms_agree_bit_for_bit(cuda, dtype, rate, b, h, l, dh,
                                                    monkeypatch) -> None:
    """Launch 1's forms sum every row in one order: the plan's form (S kept
    in registers, or the head resident) gives the same dq, dk, dv and
    statistics, bit for bit, as the ring."""
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(b, h, l, dh, generator=g).to(cuda, dtype) for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda) if rate else None
    o = (fa.flash_attention_dropout_reference(q, k, v, seed, rate) if rate
         else fa.flash_attention_reference(q, k, v))
    chosen = fa.attention_bwd_plan(l, dh, dtype)
    fields = {n: chosen[n] for n, _ in fa.AttnBwdPlan._fields_}
    fields.update(resident=0, kept=0, dq_bytes=chosen["bytes"])
    ring = {**fields, "struct": fa.AttnBwdPlan(**fields)}
    first = fa._launch_bwd(q, k, v, o, do, seed, rate)
    monkeypatch.setattr(fa, "attention_bwd_plan", lambda *_: ring)
    second = fa._launch_bwd(q, k, v, o, do, seed, rate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


# The bf16 exact forward where it keeps S in registers (the flagship's heads;
# L=128 at dh 16, the last two key blocks), holds the head resident (L=129,
# and the plan's last resident length at dh 16) and streams it through the
# ring (one past that).
_LAST_RESIDENT = max(l for l in range(1, 2049)
                     if fa.attention_fwd_plan(l, 16, torch.bfloat16)["resident"])
BF16_FWD_FORM_SHAPES = [(8, 12, 100, 6), (2, 8, 128, 16), (2, 8, 129, 16),
                        (1, 8, _LAST_RESIDENT, 16), (1, 8, _LAST_RESIDENT + 1, 16)]
BF16_FWD_FORM_IDS = ["L100-kept", "L128-kept", "L129-resident", "last-resident", "ring"]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["B2", "B6-fwd"])
@pytest.mark.parametrize("b,h,l,dh", BF16_FWD_FORM_SHAPES, ids=BF16_FWD_FORM_IDS)
def test_bf16_attention_forward_forms_agree_bit_for_bit(cuda, rate, b, h, l, dh) -> None:
    """The bf16 exact forward (B6-fwd; B2 at dh 16, its exact form) sums
    every row in one order with the same expressions in every form: the
    plan's form (S kept, or the head resident) gives the same bits as the
    ring and as the resident form, and the plan takes the form its rules
    say."""
    plan = fa.attention_fwd_plan(l, dh, torch.bfloat16)
    want = "kept" if l <= 128 else "resident" if l <= _LAST_RESIDENT else "ring"
    assert ("kept" if plan["kept"] else "resident" if plan["resident"] else "ring") == want
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    if rate:
        seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda)
        call = lambda **kw: fa._launch_fwd(q, k, v, seed, rate, **kw)  # noqa: E731
    else:
        q, k, v = (t.repeat_interleave(-(-16 // dh), -1)[..., :16] for t in (q, k, v))
        call = lambda **kw: fa._launch_fwd(q, k, v, **kw)  # noqa: E731
    width = q.shape[-1]
    first = call()
    forms = {f: fa.attention_fwd_form(l, width, torch.bfloat16, f) for f in ("ring", "resident")}
    others = {f: call(plan=p) for f, p in forms.items() if p is not None}
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all()
    assert ("resident" in others) == (l <= _LAST_RESIDENT)
    for form, out in others.items():
        assert torch.equal(first, out), form


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head", [(8, 100, 72, 12), (2, 128, 128, 8), (2, 129, 128, 8),
                                          (1, _LAST_RESIDENT, 128, 8),
                                          (1, _LAST_RESIDENT + 1, 128, 8)],
                         ids=["L100-kept", "L128-kept", "L129-resident", "last-resident", "ring"])
def test_training_attention_forms_agree_bit_for_bit(cuda, dtype, b, l, d, n_head) -> None:
    """B3, whose attention launch takes the forward's plan at the head width
    over the packed qkv, gives the same bits in every form of that launch:
    the plan's, the ring and the resident form (in bf16 at the edges of its
    kept and resident forms; fp32 is resident to L=704 at dh 16 and keeps no
    S)."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(d, n_head, 256, 0.1)
    lay = {k: t.to(cuda) for k, t in fet.pack_encoder_layer_train(
        layer, n_head, dtype).items()}
    g = torch.Generator().manual_seed(10)
    x = torch.randn(b, l, d, generator=g).to(cuda, dtype)
    dh, chosen = d // n_head, fa.attention_fwd_plan
    first = fet._launch_fwd(x, lay, 17, n_head, 0.1)
    outs = {}
    try:
        for form in ("ring", "resident"):
            plan = fa.attention_fwd_form(l, dh, dtype, form)
            if plan is None:
                continue
            fa.attention_fwd_plan = lambda *_a, _p=plan, **_k: _p
            fet.train_fwd_plan.cache_clear()
            outs[form] = fet._launch_fwd(x, lay, 17, n_head, 0.1)
    finally:
        fa.attention_fwd_plan = chosen
        fet.train_fwd_plan.cache_clear()
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all() and "ring" in outs
    for form, out in outs.items():
        assert torch.equal(first, out), form


# fp32 and bf16's fast form (B2 at dh < 16) hold the head resident up to the
# same L=1152 at dh 6, and keep no S.
FWD_FORM_SHAPES = [(8, 12, 100, 6), (2, 12, 365, 6), (1, 4, 1152, 6), (1, 4, 1153, 6)]
FWD_FORM_IDS = ["L100", "L365", "last-resident", "ring"]


@pytest.mark.parametrize("kind", ["fp32-B2", "fp32-B6-fwd", "bf16-fast-B2"])
@pytest.mark.parametrize("b,h,l,dh", FWD_FORM_SHAPES, ids=FWD_FORM_IDS)
def test_attention_forward_forms_agree_bit_for_bit(cuda, kind, b, h, l, dh) -> None:
    """B2 and B6-fwd in fp32, and B2's bf16 fast form, give the same bits in
    the plan's form (resident to L=1152 at dh 6, S never kept) as in the
    ring and the resident form."""
    dtype = torch.bfloat16 if kind.startswith("bf16") else torch.float32
    fast = kind == "bf16-fast-B2"
    plan = fa.attention_fwd_plan(l, dh, dtype, fast)
    assert (plan["resident"], plan["kept"]) == (int(l <= 1152), 0)
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).to(cuda, dtype) for _ in range(3))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda)
    args = (seed, 0.1) if kind.endswith("B6-fwd") else ()
    first = fa._launch_fwd(q, k, v, *args)
    others = {f: fa._launch_fwd(q, k, v, *args, plan=p) for f in ("ring", "resident")
              if (p := fa.attention_fwd_form(l, dh, dtype, f, fast)) is not None}
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all() and "ring" in others
    for form, out in others.items():
        assert torch.equal(first, out), form


@pytest.mark.parametrize("b,h,l,dh", DROPOUT_FWD_SHAPES, ids=DROPOUT_FWD_IDS)
def test_bf16_dropout_forward_matches_plain_at_every_length(cuda, b, h, l, dh) -> None:
    """B6-fwd in bf16 (the exact form, P keep rounded to bf16) against
    ``flash_attention_dropout_reference`` to B2_BF16_ULPS ulps of the
    largest output, one launch per call."""
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device=cuda)
    before = fa.dropout_fwd_launches
    with torch.no_grad():
        out = fa.flash_attention_dropout(q, k, v, seed, 0.1)
    torch.cuda.synchronize()
    assert fa.dropout_fwd_launches == before + 1
    ref = fa.flash_attention_dropout_reference(q, k, v, seed, 0.1)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= b2_tol(torch.bfloat16, ref)


@pytest.mark.parametrize("l,seed", [(100, 2**31 - 2), (365, 5)], ids=["L100", "L365"])
def test_attention_masks_are_bit_identical(cuda, l, seed) -> None:
    ours = fa.attention_keep_cuda(3, 12, l, seed, 0.1, device=cuda)
    assert torch.equal(ours, fa.attention_keep(3, 12, l, seed, 0.1, device=cuda))


def test_kernel_wrappers_raise_on_wrong_dtype(cuda) -> None:
    """fp16 is refused; bf16 runs every attention kernel (B2, B5, B6-fwd,
    B6-bwd), each counting one launch of its wrapper."""
    packed = _train_layer(24, 4, 64, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fet.fused_encoder_layer_train(
            torch.zeros(2, 19, 24, device=cuda, dtype=torch.float16), packed, 1,
            n_head=4, rate=0.1,
        )
    q = torch.zeros(1, 2, 5, 6, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 5, 6, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    counts = ("launches", "bwd_launches", "dropout_fwd_launches", "dropout_bwd_launches")
    before = [getattr(fa, c) for c in counts]
    fa.flash_attention(q, q, q).sum().backward()
    fa.flash_attention_dropout(q, q, q, 1, 0.1).sum().backward()
    torch.cuda.synchronize()
    assert [getattr(fa, c) for c in counts] == [n + 1 for n in before]
    assert q.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_unfused_trainer_runs_every_layer_through_the_kernels(cuda, rate, monkeypatch) -> None:
    from fourierdiffusion_tpu_torch.data import DummyDatamodule
    from fourierdiffusion_tpu_torch.schedulers import VPScheduler
    from fourierdiffusion_tpu_torch.training import Trainer

    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "0")
    torch.manual_seed(3)
    model = ScoreModelConfig(
        d_model=24, n_head=4, num_layers=2, dim_feedforward=64, dropout_rate=rate
    ).build(2, 19)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=19, standardize=True)
    dm.prepare_data()
    dm.setup()
    trainer = Trainer(model, VPScheduler(), max_epochs=1, val_noise_draws=2, device=cuda)
    fet.fwd_launches = fet.bwd_launches = fa.launches = fa.bwd_launches = 0
    fa.dropout_fwd_launches = fa.dropout_bwd_launches = 0
    history = trainer.fit(dm)
    steps = dm.steps_per_epoch
    train = steps * 2  # steps x layers
    assert (fet.fwd_launches, fet.bwd_launches) == (0, 0)
    if rate:
        assert (fa.dropout_fwd_launches, fa.dropout_bwd_launches, fa.bwd_launches) == (
            train, train, 0)
        assert fa.launches == 2 * steps * 2  # validation only
    else:
        assert (fa.dropout_fwd_launches, fa.bwd_launches) == (0, train)
        assert fa.launches == train + 2 * steps * 2
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert len(history) == 1 and history[0]["step"] == steps


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_unfused_trainer_runs_every_layer_through_the_kernels(cuda, rate,
                                                                    monkeypatch) -> None:
    """A bf16 model (fp32 parameters) on the unfused path: every layer of
    every step through B6 in bf16, or B2's fast form and B5 at rate 0, and
    validation through B2's fast form; the parameters stay finite fp32."""
    from fourierdiffusion_tpu_torch.data import DummyDatamodule
    from fourierdiffusion_tpu_torch.schedulers import VPScheduler
    from fourierdiffusion_tpu_torch.training import Trainer

    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "0")
    torch.manual_seed(3)
    model = ScoreModelConfig(
        d_model=24, n_head=4, num_layers=2, dim_feedforward=64, dropout_rate=rate,
        dtype="bfloat16",
    ).build(2, 19)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=19, standardize=True)
    dm.prepare_data()
    dm.setup()
    trainer = Trainer(model, VPScheduler(), max_epochs=1, val_noise_draws=2, device=cuda)
    fet.fwd_launches = fet.bwd_launches = fa.launches = fa.bwd_launches = 0
    fa.dropout_fwd_launches = fa.dropout_bwd_launches = fa.fast_launches = 0
    history = trainer.fit(dm)
    steps = dm.steps_per_epoch
    train, val = steps * 2, 2 * steps * 2  # steps x layers; draws x batches x layers
    assert (fet.fwd_launches, fet.bwd_launches) == (0, 0)
    if rate:
        assert (fa.dropout_fwd_launches, fa.dropout_bwd_launches, fa.bwd_launches,
                fa.launches) == (train, train, 0, val)
    else:
        assert (fa.dropout_fwd_launches, fa.bwd_launches, fa.launches) == (0, train, train + val)
    assert fa.fast_launches == fa.launches
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in model.parameters())
    assert len(history) == 1 and history[0]["step"] == steps


def test_trainer_runs_every_layer_through_the_kernels(cuda) -> None:
    from fourierdiffusion_tpu_torch.data import DummyDatamodule
    from fourierdiffusion_tpu_torch.schedulers import VPScheduler
    from fourierdiffusion_tpu_torch.training import Trainer

    torch.manual_seed(3)
    model = ScoreModelConfig(
        d_model=24, n_head=4, num_layers=2, dim_feedforward=64, dropout_rate=0.1
    ).build(2, 19)
    dm = DummyDatamodule(batch_size=8, n_channels=2, max_len=19, standardize=True)
    dm.prepare_data()
    dm.setup()
    trainer = Trainer(model, VPScheduler(), max_epochs=1, ema_decay=0.999, val_noise_draws=2,
                      device=cuda)
    fet.fwd_launches = fet.bwd_launches = fa.launches = 0
    history = trainer.fit(dm)
    steps = dm.steps_per_epoch
    assert (fet.fwd_launches, fet.bwd_launches) == (steps * 2, steps * 2)
    assert fa.launches == 2 * steps * 2  # draws x validation batches x layers
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert len(history) == 1 and history[0]["step"] == steps


def test_sampler_and_fused_trainer_run_at_L365(cuda) -> None:
    """The sampler's fused route (B1) and the fused trainer (B3, B4) at
    USDroughts' length, where the layer kernels use their workspaces."""
    from fourierdiffusion_tpu_torch.data import DummyDatamodule
    from fourierdiffusion_tpu_torch.sampling import DiffusionSampler
    from fourierdiffusion_tpu_torch.schedulers import VPScheduler
    from fourierdiffusion_tpu_torch.training import Trainer

    torch.manual_seed(4)
    model = ScoreModelConfig(d_model=72, n_head=12, num_layers=1).build(1, 365)
    sampler = DiffusionSampler(model, VPScheduler(fourier_noise_scaling=True), max_len=365,
                               n_channels=1, sample_batch_size=4, device=cuda)
    fe.launches = 0
    out = sampler.sample(4, num_diffusion_steps=3,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    assert fe.launches == 3 and out.shape == (4, 365, 1) and torch.isfinite(out).all()
    dm = DummyDatamodule(batch_size=4, n_channels=1, max_len=365, standardize=True)
    dm.prepare_data()
    dm.setup()
    trainer = Trainer(model, VPScheduler(), max_epochs=1, val_noise_draws=1, device=cuda)
    fet.fwd_launches = fet.bwd_launches = 0
    history = trainer.fit(dm)
    assert (fet.fwd_launches, fet.bwd_launches) == (dm.steps_per_epoch,) * 2
    assert math.isfinite(history[0]["train/loss"]) and math.isfinite(history[0]["val/loss"])


INT8_SHAPES = [(3, 19, 24, 4, 1040), (4, 100, 72, 12, 2048), (2, 187, 72, 12, 2048),
               (2, 365, 72, 12, 2048), (2, 187, 128, 8, 2048), (2, 187, 128, 8, 512)]
INT8_IDS = ["L19-F1040", "L100", "L187", "L365", "D128-F2048", "D128-F512"]
FLIP_BAND = 1e-3  # fp32: distance of a flipped code's input from k + 1/2
BF16_FLIP_SHARE = 1e-2
EXACT_SITES = ("x", "v")


def check_int8_flips(flips: dict, dtype: torch.dtype) -> None:
    """The flips that ``fe.locate_code_flips`` located, against the bounds
    in this file's docstring."""
    for site, f in flips.items():
        if site in EXACT_SITES:
            assert f["flipped"] == 0, (site, f)
        elif dtype == torch.float32:
            assert f["max_step"] <= 1 and f["max_dist"] <= FLIP_BAND, (site, f)
        else:
            assert f["flipped"] <= BF16_FLIP_SHARE * f["codes"], (site, f)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", INT8_SHAPES, ids=INT8_IDS)
def test_int8_kernel_matches_plain(cuda, level, dtype, b, l, d, n_head, d_ff) -> None:
    packed = _layer(d, n_head, d_ff, dtype, cuda, level)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, l, d, generator=g).to(cuda, dtype)
    counts = (fe.launches, fe.int8_launches, fe.int8_attn_launches)
    out = fe.fused_encoder_layer(x, packed, n_head=n_head)
    codes = fe.int8_codes_buffers(x, packed, n_head)
    probed = fe.launch_int8(x, packed, n_head, probe=codes)
    torch.cuda.synchronize()
    after = (counts[0], counts[1] + 2 * (level == 1), counts[2] + 2 * (level == 2))
    assert (fe.launches, fe.int8_launches, fe.int8_attn_launches) == after
    assert out.dtype == dtype and out.shape == x.shape and torch.isfinite(out.float()).all()
    assert torch.equal(out, probed)  # the probe does not change the result
    ref, flips = fe.locate_code_flips(x, packed, n_head, codes)
    assert set(flips) == set(codes)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    check_int8_flips(flips, dtype)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", [INT8_SHAPES[1], INT8_SHAPES[4]],
                         ids=[INT8_IDS[1], INT8_IDS[4]])
def test_int8_call_makes_the_plans_launches(cuda, level, dtype, b, l, d, n_head, d_ff) -> None:
    """Each B7/B8 call makes exactly ``int8_plan``'s CUDA launches, of its
    kernels and no other (``chip_smoke.device_us_by_kernel``: the kernels
    the device ran, by ``torch.profiler``)."""
    import chip_smoke

    packed = _layer(d, n_head, d_ff, dtype, cuda, level)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    plan = fe.int8_plan(b, l, d, n_head, d_ff, dtype, level)
    prof = chip_smoke.device_us_by_kernel(
        lambda: fe.fused_encoder_layer(x, packed, n_head=n_head), calls=3,
        launches=plan["launches"])
    kernels = prof.us_by_kernel
    assert prof.launches == prof.host_launches == plan["launches"], prof
    assert len(kernels) == plan["launches"], kernels
    for name, _, _ in plan["kernels"]:
        assert any(name in k for k in kernels), (name, kernels)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_kernel_is_bit_identical_across_calls(cuda, level, dtype) -> None:
    """Two B7/B8 calls on the same inputs give the same bits and the same
    codes (every sum in one fixed order: exact int32 products, partials
    added in chunk order, no atomics)."""
    b, l, d, n_head, d_ff = INT8_SHAPES[0]
    packed = _layer(d, n_head, d_ff, dtype, cuda, level)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(8)).to(cuda, dtype)
    codes = [fe.int8_codes_buffers(x, packed, n_head) for _ in range(2)]
    first, second = (fe.launch_int8(x, packed, n_head, probe=c) for c in codes)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(codes[0][k], codes[1][k]) for k in codes[0])


@pytest.mark.parametrize("level", [1, 2])
def test_int8_sampler_runs_every_layer_through_the_kernel(cuda, level, monkeypatch) -> None:
    from fourierdiffusion_tpu_torch.sampling import DiffusionSampler
    from fourierdiffusion_tpu_torch.schedulers import VEScheduler

    monkeypatch.setenv("FDIFF_FUSED_INT8", str(level))
    torch.manual_seed(4)
    model = ScoreModelConfig(d_model=24, n_head=4, num_layers=2, dim_feedforward=64,
                             dtype="bfloat16").build(1, 19)
    sampler = DiffusionSampler(model, VEScheduler(fourier_noise_scaling=True), max_len=19,
                               n_channels=1, sample_batch_size=4, method="pc", device=cuda)
    fe.launches = fe.int8_launches = fe.int8_attn_launches = 0
    out = sampler.sample(4, num_diffusion_steps=3,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    launches = 3 * 2 * 2  # steps x (predictor + corrector) x layers
    assert (fe.launches, fe.int8_launches, fe.int8_attn_launches) == (
        0, launches * (level == 1), launches * (level == 2))
    assert out.shape == (4, 19, 1) and torch.isfinite(out).all()


def test_int8_kernel_rejects_misaligned_widths(cuda) -> None:
    packed = _layer(20, 4, 64, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="divisible by 8"):
        fe.fused_encoder_layer(torch.zeros(2, 19, 20, device=cuda), packed, n_head=4)
