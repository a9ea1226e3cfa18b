"""The launch plans of the tensor-core kernels B1 (``ops/fused_encoder.py``:
``sample_plan``, ``tail_plan``), B3 and B4 (``ops/fused_encoder_train.py``:
``train_fwd_plan``, ``train_bwd_plan``) and B2 (``ops/flash_attention.py``:
``attention_fwd_plan``), and the fp32 product form they use, on the CPU.

The wrappers compute every plan and pass it to the kernels, so these
checks hold what the kernels are given: at every (L, D, H, F) that
``chip_smoke.py``'s phase 9 and the flagship run, and at B in {1, 3, 32,
64} and L in {1, 17, 100, 187, 251, 365}, each plan stays within the
232,448 bytes of shared memory a block can opt into on an H100, its row
tiles and row slices cover every row exactly once, and the tail's
persistent schedule covers every (row tile, d_ff chunk) exactly once.

The fp32 products run as 3xTF32 (``csrc/mma_tile.cuh``: hi rounded to
nearest as ``cvt.rna.tf32``, lo = x - hi truncated to tf32 by the tensor
core). A plain-torch emulation of both roundings shows why: at the
flagship's FFN shape (100 x 72 times 72 x 2048) three TF32 products stay
within 1e-6 of the largest |value| of the fp64 product, as fp32 does, while
one TF32 pass leaves about 3e-4, which the fp32 gates (1e-4) do not admit.

B3 runs B4's forward stage: the same tail plan, schedule and CTAs, so the
two sum alike. B2's order of operations (two passes over key blocks of 64:
the running max and rescaled sum, then P rounded to the input type before
P V, the products as 3xTF32 in fp32) is emulated in plain torch and held
against the JAX package's ``_fwd_kernel`` and ``_fast_fwd_kernel`` in
interpret mode, with ``tests/test_torch_attention.py``'s tolerances: fp32
1e-5 absolute and relative (the same arithmetic in other sum orders; 3xTF32
is within ~1e-6 of fp32, above), bf16 2**-5 absolute (one flipped bf16
rounding of P or O moves an output by one bf16 ulp).
"""

from __future__ import annotations

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet

WIDTHS = [(72, 12, 2048), (128, 8, 2048), (128, 8, 512), (24, 4, 64)]
BATCHES = (1, 3, 32, 64)
LENGTHS = (1, 17, 100, 187, 251, 365)
CASES = list(itertools.product(WIDTHS, BATCHES, LENGTHS))
IDS = [f"D{d}-F{f}-B{b}-L{l}" for (d, _, f), b, l in CASES]


def covers_once(tiles: list[tuple[int, int]], n_rows: int) -> bool:
    seen = torch.zeros(n_rows, dtype=torch.int64)
    for start, stop in tiles:
        seen[start:stop] += 1
    return bool((seen == 1).all())


def check_tail(plan: dict[str, int], n_rows: int, d_model: int, size: int) -> None:
    assert plan["wide"] == 0 and plan["bytes"] <= fe.SMEM_LIMIT
    assert plan["tm"] == (32 if d_model <= 128 else 16)
    regions = [("off_a", plan["tm"] * plan["sa"] * size),
               ("off_h", plan["tm"] * plan["sh"] * size),
               ("off_ring", max(plan["slots"] * plan["slot"] * size,
                                2 * plan["tm"] * plan["dn"] * 4)),
               ("off_pre", plan["tm"] * d_model * 4)]
    end = 0
    for name, nbytes in regions:  # in order, aligned, not overlapping
        assert plan[name] >= end and plan[name] % 16 == 0, name
        end = plan[name] + nbytes
    assert end <= plan["bytes"]
    assert plan["sa"] >= plan["kd"] >= d_model and plan["swo"] >= plan["dn"] >= d_model
    assert plan["kt"] <= fe.TAIL_MAX_KT and plan["fc"] <= fe.TAIL_MAX_FC and plan["fc"] % 64 == 0
    assert plan["kd"] <= plan["kt"] or plan["kt"] == 64
    assert plan["slots"] in (2, 3)
    assert plan["slot"] >= max(plan["kt"] * plan["swo"], plan["kt"] * plan["sw1"],
                               plan["fc"] * plan["swo"])
    assert covers_once(fe.row_tiles(n_rows, plan["tm"]), n_rows)


def check_schedule(sched: dict[str, int], n_rows: int, d_ff: int, tm: int, fc: int) -> None:
    """The tail's persistent schedule: every (row tile, chunk) unit in
    exactly one segment of one CTA, no CTA without work, each CTA within
    one unit of the even share, partial slots unique and within ``parts``,
    and each row tile's segments in CTA order, as the finish adds them."""
    assert sched["tiles"] == len(fe.row_tiles(n_rows, tm))
    assert sched["chunks"] == len(fe.row_tiles(d_ff, fc))
    assert 1 <= sched["ctas"] <= min(2 * fe.SMS, sched["units"])
    seen = torch.zeros(sched["tiles"], sched["chunks"], dtype=torch.int64)
    work = torch.zeros(sched["ctas"], dtype=torch.int64)
    slots, by_tile = set(), {}
    for k, tile, c_lo, c_hi, slot in fe.tail_segments(sched):
        assert 0 <= c_lo < c_hi <= sched["chunks"]
        seen[tile, c_lo:c_hi] += 1
        work[k] += c_hi - c_lo
        assert slot == tile + k and slot not in slots and slot < sched["parts"]
        slots.add(slot)
        by_tile.setdefault(tile, []).append(k)
    assert bool((seen == 1).all())
    assert int(work.min()) >= sched["units"] // sched["ctas"]
    assert int(work.max()) <= -(-sched["units"] // sched["ctas"])
    for tile, ks in by_tile.items():  # the CTAs the finish reads, in order
        assert ks == list(range(ks[0], ks[-1] + 1)), tile
        u0, u1 = tile * sched["chunks"], (tile + 1) * sched["chunks"] - 1
        assert ks[0] == ((u0 + 1) * sched["ctas"] - 1) // sched["units"]
        assert ks[-1] == ((u1 + 1) * sched["ctas"] - 1) // sched["units"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("widths,b,l", CASES, ids=IDS)
def test_sampling_plan_fits_and_covers_every_row(dtype, widths, b, l) -> None:
    d, h, f = widths
    plan = fe.sample_plan(b, l, d, h, f, dtype)
    size = torch.finfo(dtype).bits // 8
    check_tail(plan["tail"], b * l, d, size)
    check_schedule(plan["tail_schedule"], b * l, f, plan["tail"]["tm"], plan["tail"]["fc"])
    assert plan["qkv_smem_bytes"] <= fe.SMEM_LIMIT
    m_tiles, n_tiles = plan["qkv_grid"]
    assert covers_once(fe.row_tiles(b * l, fe.GEMM_BM), b * l) and m_tiles * fe.GEMM_BM >= b * l
    assert n_tiles * fe.GEMM_BN >= 3 * d
    q_tiles, heads, chains = plan["attention_grid"]
    assert (heads, chains) == (h, b) and covers_once(fe.row_tiles(l, 128), l)
    assert len(fe.row_tiles(l, 128)) == q_tiles


@pytest.mark.parametrize("widths,b,l", CASES, ids=IDS)
def test_backward_plan_fits_and_covers_every_row(widths, b, l) -> None:
    d, h, f = widths
    plan = fet.train_bwd_plan(b, l, d, h, f)
    n = b * l
    check_tail(plan["tail"], n, d, 4)
    check_schedule(plan["tail_schedule"], n, f, plan["tail"]["tm"], plan["tail"]["fc"])
    assert plan["tail_part"] + plan["tail_schedule"]["parts"] * plan["tail"]["tm"] * d \
        <= plan["part"]
    assert fe.gemm_smem_bytes(4) <= fe.SMEM_LIMIT
    for key, (per, slices) in plan["slices"].items():
        assert per % fe.GEMM_BK == 0, key
        tiles = fe.row_tiles(n, per)
        assert len(tiles) == slices and covers_once(tiles, n), key
    tiles = fe.row_tiles(n, plan["cs_rows"])
    assert len(tiles) == plan["cs_slices"] and covers_once(tiles, n)
    per, slices = plan["dx1_slices"]  # d_ff slices of dh W1^T
    assert per % fe.GEMM_BK == 0 and len(fe.row_tiles(f, per)) == slices
    assert covers_once(fe.row_tiles(f, per), f)
    # workspace regions in order and 16-byte aligned, partials inside
    offsets = [plan[k] for k in fet.WS_FIELDS] + [plan["part"]]
    assert offsets == sorted(offsets) and all(o % 4 == 0 for o in offsets)
    assert plan["stats"] + 3 * n * h <= plan["dx1p"]
    assert plan["dx1p"] + slices * n * d <= plan["tail_part"]
    numel = {"w_qkv": 3 * d * d, "b_qkv": 3 * d, "w_out": d * d, "w1": d * f, "b1": f,
             "w2": f * d}
    for k, off, count in zip(fet.LAYER_KEYS, plan["p_off"], plan["p_n"]):
        assert plan["part"] + off + count * numel.get(k, d) <= plan["workspace_floats"], k
    assert plan["launches"] == 17
    struct = plan["struct"]  # what the kernels are given
    assert struct.tail_ctas == plan["tail_schedule"]["ctas"]
    assert [getattr(struct.tail, k) for k in plan["tail"]] == list(plan["tail"].values())
    assert [getattr(struct, k) for k in fet.WS_FIELDS] == [plan[k] for k in fet.WS_FIELDS]
    assert [(getattr(struct, f"ks_{k}"), getattr(struct, f"sp_{k}")) for k in plan["slices"]] \
        == list(plan["slices"].values())
    assert (struct.ks_dx1, struct.sp_dx1) == plan["dx1_slices"]
    assert list(struct.p_off) == plan["p_off"] and list(struct.p_n) == plan["p_n"]


@pytest.mark.parametrize("widths,b,l", CASES, ids=IDS)
def test_forward_plan_fits_and_covers_every_row(widths, b, l) -> None:
    """B3's plan: the tail's plan and schedule as in B1 and B4, the
    workspace regions in order, 16-byte aligned and not overlapping, and 4
    launches per call."""
    d, h, f = widths
    plan = fet.train_fwd_plan(b, l, d, h, f)
    n = b * l
    check_tail(plan["tail"], n, d, 4)
    check_schedule(plan["tail_schedule"], n, f, plan["tail"]["tm"], plan["tail"]["fc"])
    sizes = {"qkv": 3 * n * d, "attn": n * d, "x1": n * d, "pre": 0, "h": 0,
             "tail_part": plan["tail_schedule"]["parts"] * plan["tail"]["tm"] * d}
    end = 0
    for k in fet.FWD_WS_FIELDS:
        assert plan[k] >= end and plan[k] % 4 == 0, k
        end = plan[k] + sizes[k]
    assert end <= plan["workspace_floats"]
    assert plan["launches"] == 4
    struct = plan["struct"]
    assert struct.tail_ctas == plan["tail_schedule"]["ctas"]
    assert [getattr(struct.tail, k) for k in plan["tail"]] == list(plan["tail"].values())
    assert [getattr(struct, k) for k in fet.FWD_WS_FIELDS] == [plan[k] for k in
                                                               fet.FWD_WS_FIELDS]


@pytest.mark.parametrize("d_model,l", [(264, 17), (384, 17), (264, 365), (384, 365)])
def test_wide_forward_plan_has_its_workspace(d_model, l) -> None:
    """Past 256 columns B3 runs the wide tail (7 launches) with pre (N x D)
    and h (N x F) in its workspace, and no f2 partials."""
    b, f = 3, 512
    n = b * l
    plan = fet.train_fwd_plan(b, l, d_model, 6, f)
    assert plan["tail"]["wide"] == 1 and plan["tail_schedule"] is None
    assert plan["launches"] == 7 and plan["struct"].tail.wide == 1
    assert plan["struct"].tail_ctas == 0
    assert plan["x1"] + n * d_model <= plan["pre"] and plan["pre"] + n * d_model <= plan["h"]
    assert plan["h"] + n * f <= plan["tail_part"] == plan["workspace_floats"]


@pytest.mark.parametrize("widths,b,l", CASES + [((264, 6, 512), 3, 17), ((384, 6, 512), 2, 365)],
                         ids=IDS + ["D264-wide", "D384-L365-wide"])
def test_forward_plan_is_the_backward_forward_stage(widths, b, l) -> None:
    """B3 and B4's recompute run the same launches on the same plan: the
    tail's plan, schedule and CTAs are equal, so every sum of the forward
    is taken in the same order in both."""
    d, h, f = widths
    for sms in (fe.SMS, 114):
        fwd, bwd = fet.train_fwd_plan(b, l, d, h, f, sms), fet.train_bwd_plan(b, l, d, h, f, sms)
        assert fwd["tail"] == bwd["tail"] and fwd["tail_schedule"] == bwd["tail_schedule"]
        assert fwd["struct"].tail_ctas == bwd["struct"].tail_ctas
        assert bytes(fwd["struct"].tail) == bytes(bwd["struct"].tail)
        assert bwd["launches"] - fwd["launches"] == 13


def test_flagship_plans_fill_the_card() -> None:
    """The grids of B4's product stages fill the 132 SMs at the training
    shape, B=64, L=100, and so do B1's QKV product and attention at B=32,
    L=100 (200 and 384 CTAs). The tail, whose 100 row tiles of 32 rows
    would leave 32 SMs idle there, runs two CTAs per SM (their shared
    memory fits twice) over the 3200 (row tile, d_ff chunk) units, 12 or 13
    each; at B=64 (B4's training tail) 6400 units over the same 264 CTAs,
    24 or 25 each."""
    sample = fe.sample_plan(32, 100, 72, 12, 2048, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        assert fe.tail_ctas_per_sm(fe.tail_plan(72, dtype)) == 2
    sched = sample["tail_schedule"]
    assert (sched["tiles"], sched["units"], sched["ctas"]) == (100, 3200, 2 * fe.SMS)
    work = torch.zeros(sched["ctas"], dtype=torch.int64)
    for k, _, c_lo, c_hi, _ in fe.tail_segments(sched):
        work[k] += c_hi - c_lo
    assert (int(work.min()), int(work.max()), int(work.sum())) == (12, 13, 3200)
    assert sample["qkv_grid"][0] * sample["qkv_grid"][1] >= fe.SMS
    q_tiles, heads, chains = sample["attention_grid"]
    assert q_tiles * heads * chains >= fe.SMS
    plan = fet.train_bwd_plan(64, 100, 72, 12, 2048)
    assert plan["tail_schedule"]["ctas"] == 2 * fe.SMS
    assert plan["tail_schedule"]["units"] == 6400
    for key, (_, slices) in plan["slices"].items():
        rows, cols = fet.WEIGHT_PRODUCTS[key](72, 2048)
        tiles = -(-rows // fe.GEMM_BM) * -(-cols // fe.GEMM_BN)
        assert tiles * slices >= fe.SMS, key


@pytest.mark.parametrize("d_model", [264, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wide_layers_take_the_wide_tail(dtype, d_model) -> None:
    """Past the tail's 256 register columns, B1 and B4 run the wide tail
    (five launches through device memory) instead of raising: 7 launches
    for B1 (4 on the fused route), 20 for B4 (17). Up to 256 the fused
    tail's plan fits."""
    assert fe.tail_plan(fe.MAX_TAIL_D, dtype)["wide"] == 0
    check_tail(fe.tail_plan(fe.MAX_TAIL_D, dtype), 100, fe.MAX_TAIL_D,
               torch.finfo(dtype).bits // 8)
    tail = fe.tail_plan(d_model, dtype)
    assert tail["wide"] == 1 and fe.sample_plan(3, 17, d_model, 6, 512, dtype)["launches"] == 7
    plan = fet.train_bwd_plan(3, 17, d_model, 6, 512)
    assert plan["launches"] == 20 and plan["struct"].tail.wide == 1
    # the wide tail's workspace in B4: pre in dx1, x1, h (N x F)
    assert plan["x1"] + 51 * d_model <= plan["xhat1"] and plan["h"] + 51 * 512 <= plan["dh"]


# ---- the fp32 product form -------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits to the magnitude)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    sign, mag = bits & ~0x7FFFFFFF, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~0x1FFF
    return (sign | mag).to(torch.int32).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """A tf32 operand as the tensor core reads an fp32 register: its low 13
    bits dropped."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return (bits & ~0x1FFF).to(torch.int32).view(torch.float32)


def test_tf32_rounding_emulation() -> None:
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12])
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2 * 2.0**-10, -(1.0 + 2.0**-10), 1.0])
    assert torch.equal(tf32_rna(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    assert ((tf32_rna(y) - y).abs() <= y.abs() * 2.0**-11).all()
    assert torch.equal(tf32_trunc(x), torch.tensor([1.0, 1.0, 1.0 + 2.0**-10, -1.0, 1.0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_products_hold_fp32_accuracy_and_one_does_not(seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(100, 72, generator=g)
    w = (torch.rand(72, 2048, generator=g) * 2 - 1) / 72**0.5  # nn.Linear's init
    exact = a.double() @ w.double()
    scale = exact.abs().max().item()
    a_hi, w_hi = tf32_rna(a), tf32_rna(w)
    a_lo, w_lo = tf32_trunc(a - a_hi), tf32_trunc(w - w_hi)
    three = (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi
    one = a_hi @ w_hi
    assert (three.double() - exact).abs().max().item() / scale <= 1e-6
    assert (one.double() - exact).abs().max().item() / scale > 1e-4


# ---- B2: the attention forward's tiles and its order of operations ----------------------

B2_LENGTHS = (1, 17, 24, 100, 128, 129, 187, 251, 252, 365)
B2_WIDTHS = (1, 6, 8, 12, 16, 22, 32, 33, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("l", B2_LENGTHS)
def test_attention_plan_covers_every_row_and_key(dtype, l) -> None:
    """Every query row in exactly one warp's 16 rows (at most 8 warps, 128
    rows, per CTA), every key in one block of 64, the instance's width
    covering dh in steps of the mma's k, bank-conflict-free strides with
    16-byte rows, and a ring of two stages of a K and a V block whose shared
    memory does not depend on L and stays within 232,448 bytes up to dh 64."""
    size = torch.finfo(dtype).bits // 8
    for dh in B2_WIDTHS:
        plan = fa.attention_fwd_plan(l, dh, dtype)
        assert 1 <= plan["warps"] <= fa.MAX_WARPS
        seen = torch.zeros(l, dtype=torch.int64)
        for y in range(plan["q_tiles"]):
            for w in range(plan["warps"]):
                r0 = y * fa.TILE_ROWS + w * fa.WARP_ROWS
                seen[r0:min(l, r0 + fa.WARP_ROWS)] += 1
        assert bool((seen == 1).all()), dh
        keys = torch.zeros(l, dtype=torch.int64)
        for kb in range(plan["key_blocks"]):
            keys[kb * fa.KEY_BLOCK:(kb + 1) * fa.KEY_BLOCK] += 1
        assert bool((keys == 1).all()) and (plan["key_blocks"] - 1) * fa.KEY_BLOCK < l
        assert plan["kdh"] >= dh and plan["kdh"] % (8 if size == 4 else 16) == 0
        assert plan["kdh"] < 2 * max(dh, 8 if size == 4 else 16)
        assert plan["stride"] >= plan["kdh"] and plan["stride"] * size % 16 == 0
        assert plan["stride"] % 8 == 4 if size == 4 else plan["stride"] % 16 == 8
        assert plan["stage"] == 2 * fa.KEY_BLOCK * plan["stride"]
        assert plan["bytes"] == fa.FWD_STAGES * plan["stage"] * size
        assert plan["bytes"] == fa.attention_fwd_plan(100_000, dh, dtype)["bytes"]
        assert plan["bytes"] <= fe.SMEM_LIMIT
        struct = plan["struct"]
        assert [getattr(struct, k) for k, _ in struct._fields_] == [
            plan[k] for k, _ in fa.AttnFwdPlan._fields_]


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three TF32 products with fp32 sums (lo hi + hi lo + hi hi)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def b2_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """B2's order of operations over (B, H, L, dh) heads: pass 1 over key
    blocks of 64 keeps each row's running max and its sum of exp(s - max),
    rescaled as the max grows (the fast form: the sum of exp(s), s clamped
    to +-60, q pre-scaled); pass 2 recomputes S block by block, forms P,
    rounds it to the input type and adds P V. fp32 products as 3xTF32, bf16
    products exact in fp32."""
    dtype, (l, dh) = q.dtype, q.shape[-2:]
    fast = fa._fast(q)
    scale = 1.0 / math.sqrt(dh)
    mm = mm_3xtf32 if dtype == torch.float32 else torch.matmul
    qf = (fa._prescale(q) if fast else q).float()
    kf, vf = k.float(), v.float()
    blocks = [(j0, min(l, j0 + fa.KEY_BLOCK)) for j0 in range(0, l, fa.KEY_BLOCK)]

    def scores(j0: int, j1: int) -> torch.Tensor:
        s = mm(qf, kf[..., j0:j1, :].transpose(-1, -2))
        return s.clamp(-fa.SCORE_CLAMP, fa.SCORE_CLAMP) if fast else s * scale

    m = torch.full(q.shape[:-1] + (1,), torch.finfo(torch.float32).min)
    total = torch.zeros_like(m)
    for j0, j1 in blocks:
        s = scores(j0, j1)
        if fast:
            total = total + torch.exp(s).sum(-1, keepdim=True)
        else:
            mb = torch.maximum(m, s.amax(-1, keepdim=True))
            total = total * torch.exp(m - mb) + torch.exp(s - mb).sum(-1, keepdim=True)
            m = mb
    out = torch.zeros_like(qf)
    for j0, j1 in blocks:
        s = scores(j0, j1)
        p = torch.exp(s) * (1.0 / total) if fast else torch.exp(s - m) / total
        out = out + mm(p.to(dtype).float(), vf[..., j0:j1, :])
    return out.to(dtype)


B2_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2.0**-5, rtol=0.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [6, 12, 16])
@pytest.mark.parametrize("l", [24, 100, 365])
def test_attention_two_pass_order_matches_jax(dtype, dh, l) -> None:
    """B2's two passes against JAX's ``_fwd_kernel`` (fp32; bf16 at dh 16)
    and ``_fast_fwd_kernel`` (bf16 below dh 16), in interpret mode."""
    rng = np.random.default_rng(l * 100 + dh)
    q, k, v = (rng.normal(size=(1, 2, l, dh)).astype(np.float32) for _ in range(3))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
                     .astype(jnp.float32))
    ours = b2_emulation(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    np.testing.assert_allclose(ours.float().numpy(), ref, **B2_TOL[dtype])
