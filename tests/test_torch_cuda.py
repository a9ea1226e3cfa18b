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

B1, B2, B3 and B4 run on the tensor cores (``csrc/mma_tile.cuh``). B2 is
checked at L 24 to 365 and dh 6 to 64, fp32 and bf16, and up to L 3616 (in
bf16 to 4 ulps of its largest output, ``B2_BF16_ULPS``), B3 at rate 0 and 0.1
at every shape B4 is checked at, and a repeated B3 call bit for bit. B1 is checked
where a row tile holds one row, one chain or straddles chains, B4's stages
against the staged plain backward (``train_backward_staged``, flipped ReLU
gates located within 1e-5 of the sum of |terms| of 0 and matched), a
repeated B4 call bit for bit, and both at layers wider than the tail's
register tiles (d_model 264 to 384, head widths up to 384).

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


# Layers wider than the tail's 256 register columns (the wide tail, five
# launches through device memory), with head widths of 22, 95 and 384.
WIDE_SHAPES = [(3, 17, 264, 12, 1024), (2, 17, 380, 4, 512), (2, 9, 384, 1, 512)]
WIDE_IDS = ["D264", "D380", "D384-H1"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,n_head,d_ff", WIDE_SHAPES, ids=WIDE_IDS)
def test_wide_layer_matches_plain(cuda, dtype, b, l, d, n_head, d_ff) -> None:
    test_kernel_matches_plain(cuda, dtype, b, l, d, n_head, d_ff)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l,d,n_head,d_ff", WIDE_SHAPES, ids=WIDE_IDS)
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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l", [(64, 100), (8, 365), (3, 19)], ids=["L100", "L365", "L19"])
def test_attention_backward_kernels_match_plain(cuda, rate, b, l) -> None:
    """B5 (rate 0) and B6 (rate 0.1), forward and backward, against their
    plain versions, on heads transposed out of (B, L, H, dh) as the module
    hands them in."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(b, l, 12, 6, generator=g).to(cuda).transpose(1, 2)
               for _ in range(3))
    do = torch.randn(b, 12, l, 6, generator=g).to(cuda)
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


@pytest.mark.parametrize("l,seed", [(100, 2**31 - 2), (365, 5)], ids=["L100", "L365"])
def test_attention_masks_are_bit_identical(cuda, l, seed) -> None:
    ours = fa.attention_keep_cuda(3, 12, l, seed, 0.1, device=cuda)
    assert torch.equal(ours, fa.attention_keep(3, 12, l, seed, 0.1, device=cuda))


def test_kernel_wrappers_raise_on_wrong_dtype(cuda) -> None:
    packed = _train_layer(24, 4, 64, cuda)
    with pytest.raises(ValueError, match="fp32 only"):
        fet.fused_encoder_layer_train(
            torch.zeros(2, 19, 24, device=cuda, dtype=torch.bfloat16), packed, 1,
            n_head=4, rate=0.1,
        )
    q = torch.zeros(1, 2, 5, 6, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 5, 6, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="fp32 only"):
        fa.flash_attention(q, q, q).sum().backward()
    with pytest.raises(ValueError, match="fp32 only"):
        fa.flash_attention_dropout(q, q, q, 1, 0.1)


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
