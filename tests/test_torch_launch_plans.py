"""The launch plans of the tensor-core kernels B1 (``ops/fused_encoder.py``:
``sample_plan``, ``tail_plan``), B3 and B4 (``ops/fused_encoder_train.py``:
``train_fwd_plan``, ``train_bwd_plan``), B2, B6-fwd (B2's fp32 plan, up
to L=3616) and B5/B6-bwd (``ops/flash_attention.py``:
``attention_fwd_plan``, ``attention_bwd_plan``), B7 and B8 (``ops/fused_encoder.py``:
``int8_plan``), and the fp32 product form they use, on the CPU.

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
P V, the products as 3xTF32 in fp32; B6-fwd: P times its keep factors
before it is rounded) is emulated in plain torch and held against the JAX
package's ``_fwd_kernel``, ``_fast_fwd_kernel`` and ``_dropout_fwd_kernel``
in interpret mode, with ``tests/test_torch_attention.py``'s tolerances: fp32
1e-5 absolute and relative (the same arithmetic in other sum orders; 3xTF32
is within ~1e-6 of fp32, above), bf16 2**-5 absolute (one flipped bf16
rounding of P or O moves an output by one bf16 ulp).
"""

from __future__ import annotations

import ctypes
import itertools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierdiffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from fourierdiffusion_tpu.ops.flash_attention import flash_attention_dropout as jax_flash_dropout
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
               ("off_ring", plan["slots"] * plan["slot"] * size),
               ("off_pre", plan["tm"] * plan["dn"] * 4),
               ("off_run", plan["tm"] * plan["dn"] * 4)]
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
    one unit of the even share, a tile's first segment folding its chunks
    into one partial at the plane of its last chunk and every later one
    writing each chunk's partial at its chunk's plane (``parts`` planes),
    and each row tile's segments in CTA order, as the finish reads them."""
    assert sched["tiles"] == len(fe.row_tiles(n_rows, tm))
    assert sched["chunks"] == len(fe.row_tiles(d_ff, fc))
    assert 1 <= sched["ctas"] <= min(2 * fe.SMS, sched["units"])
    seen = torch.zeros(sched["tiles"], sched["chunks"], dtype=torch.int64)
    work = torch.zeros(sched["ctas"], dtype=torch.int64)
    by_tile = {}
    assert sched["parts"] == sched["chunks"]
    for k, tile, c_lo, c_hi, parts in fe.tail_segments(sched):
        assert 0 <= c_lo < c_hi <= sched["chunks"]
        seen[tile, c_lo:c_hi] += 1
        work[k] += c_hi - c_lo
        assert parts == (((c_hi - 1, 0, c_hi),) if c_lo == 0 else
                         tuple((c, c, c + 1) for c in range(c_lo, c_hi)))
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
    assert plan["tail_part"] + plan["tail_schedule"]["parts"] * n * d <= plan["part"]
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
    assert plan["dx1p"] + slices * n * d <= plan["x1t"]
    assert plan["x1t"] == plan["tail_part"]  # fp32: the products read the fp32 buffers
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


# The lengths and widths the training layer serves: the synthetic runs,
# ECG and USDroughts at d_model 72, and ECG at d_model 128 (fast.yaml).
TRAIN_ATTENTION_SHAPES = [(64, 100, 72, 12), (8, 187, 72, 12), (8, 365, 72, 12),
                          (8, 187, 128, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,l,d,h", TRAIN_ATTENTION_SHAPES,
                         ids=[f"L{l}-D{d}" for _, l, d, _ in TRAIN_ATTENTION_SHAPES])
def test_training_attention_launches_fit_and_cover(dtype, b, l, d, h) -> None:
    """The training layer's attention stages run B2's and B5's tiles over
    the packed qkv: B3 (and B4's recompute) one forward launch, B4's
    backward two, each a CTA per (chain, head) and 128 rows, a warp per 16
    rows; the forward on B2's plan (``check_fwd_plan``: a ring of two
    stages of 64 rows whose shared memory fits whatever L, in bf16 the head
    resident where it fits and S kept at L=100), the backward on B5's plan
    (``check_bwd_plan``: launch 1 resident where the head fits, S kept in
    bf16 at L=100); the plans the kernels are given are those of B2 and B5
    at the head width, and the launch counts stay 4 and 17."""
    fwd = fet.train_fwd_plan(b, l, d, h, 2048, dtype=dtype)
    bwd = fet.train_bwd_plan(b, l, d, h, 2048, dtype=dtype)
    dh, size = d // h, torch.finfo(dtype).bits // 8
    attn = fwd["attention"]
    assert bwd["attention"] == attn
    fp, bp = attn["fwd_plan"], attn["bwd_plan"]
    assert fp == fa.attention_fwd_plan(l, dh, dtype)
    assert bp == fa.attention_bwd_plan(l, dh, dtype)
    check_bwd_plan(bp, l, dh, dtype)
    check_fwd_plan(fp, l, dh, dtype)
    assert (fp["resident"], fp["kept"]) == (1, int(size == 2 and l <= 128 and dh <= 16))
    tiles = -(-l // 128)
    assert attn["fwd"] == [("attention_fwd_mma_kernel", (b * h, tiles), fp["bytes"])]
    assert attn["bwd"] == [("attention_bwd_dq_mma_kernel", (b * h, tiles), bp["dq_bytes"]),
                           ("attention_bwd_dkv_mma_kernel", (b * h, tiles), bp["bytes"])]
    for plan in (fp, bp):
        assert plan["kdh"] >= dh and plan["kdh"] % (8 if size == 4 else 16) == 0
        assert plan["stride"] >= plan["kdh"] and plan["bytes"] <= fe.SMEM_LIMIT
    assert bp["bytes"] == 2 * bp["stage"] * size
    assert fp["warps"] == bp["warps"] == min(8, -(-l // 16))
    assert fp["q_tiles"] == bp["tiles"] == tiles
    assert fp["key_blocks"] * 64 >= l
    assert fp["stage"] == 2 * 64 * fp["stride"]
    assert bp["stage"] == 2 * 64 * bp["stride"] + 64 * 3 * 4 // size
    assert (fwd["launches"], bwd["launches"]) == (4, 17)
    # what the kernels are given, and the statistics' (B, H, L, 3) region
    assert [getattr(fwd["struct"].attn_fwd, k) for k, _ in fa.AttnFwdPlan._fields_] == [
        fp[k] for k, _ in fa.AttnFwdPlan._fields_]
    assert [getattr(bwd["struct"].attn_fwd, k) for k, _ in fa.AttnFwdPlan._fields_] == [
        fp[k] for k, _ in fa.AttnFwdPlan._fields_]
    assert [getattr(bwd["struct"].attn_bwd, k) for k, _ in fa.AttnBwdPlan._fields_] == [
        bp[k] for k, _ in fa.AttnBwdPlan._fields_]
    assert bwd["stats"] + 3 * b * h * l <= bwd["dx1p"]


@pytest.mark.parametrize("d,h", [(380, 4), (384, 1)], ids=["dh95", "dh384"])
def test_training_layer_refuses_heads_wider_than_its_attention(d, h) -> None:
    """The attention stages' instances reach head dim 64 (B2's and B5's);
    wider heads are refused before any launch, never sent elsewhere."""
    x = torch.zeros(2, 9, d)
    torch.manual_seed(0)
    layer = fet.pack_encoder_layer_train(fet.TransformerEncoderLayer(d, h, 64), h)
    with pytest.raises(ValueError, match="head dims up to 64"):
        fet._dims(x, layer, h)


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
             "tail_part": plan["tail_schedule"]["parts"] * n * d}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("widths", WIDTHS[:3], ids=[f"D{d}-F{f}" for d, _, f in WIDTHS[:3]])
def test_tail_partials_depend_only_on_the_chunk(dtype, widths) -> None:
    """A row's FFN sum in the fused tail (B1, B3, B4's forward stage) is the
    fold of its chunks' partials in chunk order, (p0 + p1) + p2 ..., at 1,
    16, 32 and 64 chains and on cards of 132, 114 and 7 SMs, though the
    CTAs that hold a row tile's units change with both: the tile's first
    segment folds chunks [0, e) and writes the fold at plane e - 1, and the
    finish continues it over chunks e, e + 1, ..., one partial each, at
    their own planes. (A segment's partial once went to slot tile + CTA and
    the finish added whole segments: chains 0-15 of one call then summed
    otherwise at 32 chains than at 16.)"""
    d, _, f = widths
    l = 100
    ctas_of_tile0 = set()
    for b, sms in itertools.product((1, 16, 32, 64), (fe.SMS, 114, 7)):
        sched = fe.tail_schedule(b * l, d, f, dtype, sms)
        order = fe.tail_partials(sched)
        assert sorted(order) == list(range(sched["tiles"]))
        for tile, parts in order.items():
            (slot, lo, hi), *rest = parts
            assert (lo, slot) == (0, hi - 1), (b, sms, tile)
            assert rest == [(c, c, c + 1) for c in range(hi, sched["chunks"])], (b, sms, tile)
        ctas_of_tile0.add(tuple(k for k, tile, *_ in fe.tail_segments(sched) if tile == 0))
    assert len(ctas_of_tile0) > 1  # the schedule itself does depend on the batch


@pytest.mark.parametrize("widths,b,l", [((72, 12, 2048), 64, 100), ((72, 12, 2048), 8, 365),
                                        ((128, 8, 512), 8, 187), ((24, 4, 64), 3, 19),
                                        ((264, 6, 512), 3, 17)],
                         ids=["flagship", "L365", "D128-F512", "small", "D264-wide"])
def test_bf16_backward_plan_holds_its_operands(widths, b, l) -> None:
    """B4 in bf16: qkv, attn and h in bf16, and the bf16 operands of its
    products (x1t, df2t, dht, daot, dqkvt) in regions of their own, in the
    kernel's order, 16-byte aligned and not overlapping; the forward stage
    is B3's bf16 plan."""
    d, h, f = widths
    n = b * l
    plan = fet.train_bwd_plan(b, l, d, h, f, dtype=torch.bfloat16)
    fwd = fet.train_fwd_plan(b, l, d, h, f, dtype=torch.bfloat16)
    assert plan["tail"] == fe.tail_plan(d, torch.bfloat16) == fwd["tail"]
    halves = {"qkv": 3 * n * d, "attn": n * d, "h": n * f, "x1t": n * d, "df2t": n * d,
              "dht": n * f, "daot": n * d, "dqkvt": 3 * n * d}
    sizes = {k: n * d for k in fet.WS_FIELDS}
    sizes.update({k: -(-c // 2) for k, c in halves.items()}, dh=n * f, dqkv=3 * n * d,
                 inv1=n, inv2=n, stats=3 * n * h, dx1p=plan["dx1_slices"][1] * n * d,
                 tail_part=0 if plan["tail"]["wide"] else plan["tail_schedule"]["parts"] * n * d)
    end = 0
    for k in fet.WS_FIELDS:
        assert plan[k] >= end and plan[k] % 4 == 0, k
        end = plan[k] + sizes[k]
    assert end <= plan["part"]
    assert [getattr(plan["struct"], k) for k in fet.WS_FIELDS] == [plan[k] for k in
                                                                   fet.WS_FIELDS]
    fwd_sizes = {"qkv": -(-3 * n * d // 2), "attn": -(-n * d // 2), "x1": n * d}
    end = 0
    for k in ("qkv", "attn", "x1"):
        assert fwd[k] >= end and fwd[k] % 4 == 0, k
        end = fwd[k] + fwd_sizes[k]


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


# ---- the int8 layers B7 and B8 -----------------------------------------------------------

INT8_WIDTHS = [(72, 12, 2048), (128, 8, 2048), (128, 8, 512), (24, 4, 64), (72, 12, 1040)]
INT8_LENGTHS = (24, 100, 187, 365)
INT8_CASES = list(itertools.product(INT8_WIDTHS, (1, 8, 32), INT8_LENGTHS))
INT8_IDS = [f"D{d}-F{f}-B{b}-L{l}" for (d, _, f), b, l in INT8_CASES]


def check_int8_layer_plan(layer: dict[str, int], d_model: int, size: int, level: int) -> None:
    """Shared memory within the opt-in limit; the tail's regions in order,
    16-byte aligned and apart; every tile of codes with a bank-spreading
    stride (a multiple of 16 bytes, 16 past a multiple of 32) and room for D
    padded to 32; a ring slot that holds each weight tile of the stream."""
    assert layer["bytes"] <= fe.SMEM_LIMIT
    assert layer["tm"] == (32 if d_model <= 128 else 16)
    attn8 = level == 2
    regions = [("off_a", layer["tm"] * layer["sa"] * (1 if attn8 else size)),
               ("off_pre", layer["tm"] * d_model * 4), ("off_q", layer["tm"] * layer["sq"]),
               ("off_h", layer["tm"] * layer["sh"]), ("off_sc", 11 * layer["tm"] * 4),
               ("off_par", 5 * d_model * 4), ("off_ring", layer["slots"] * layer["slot"])]
    end = 0
    for name, nbytes in regions:
        assert layer[name] >= end and layer[name] % 16 == 0, name
        end = layer[name] + nbytes
    assert end <= layer["bytes"]
    assert layer["kq"] == -(-d_model // 32) * 32 and layer["kd"] >= d_model
    for stride in (layer["sq"], layer["sh"], layer["sw2"]):
        assert stride % 32 == 16
    assert layer["sq"] >= layer["kq"] and layer["sh"] >= fe.INT8_FFN_CHUNK
    assert (layer["wt"], layer["slots"]) in fe.INT8_TAIL_LAYOUTS and layer["sw2"] >= layer["wt"]
    tiles = [layer["wt"] * layer["sq"], d_model * layer["sw2"],
             d_model * layer["sq"] if attn8 else fe.INT8_OUT_KT * layer["swo"] * size]
    assert layer["slot"] >= max(tiles) and layer["slot"] % 16 == 0
    if attn8:
        assert layer["sa"] == layer["sq"]
        assert layer["attn_bytes"] <= fe.SMEM_LIMIT and layer["qkv_bytes"] <= fe.SMEM_LIMIT
    else:
        assert layer["sa"] >= layer["kd"] and layer["swo"] >= d_model


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("widths,b,l", INT8_CASES, ids=INT8_IDS)
def test_int8_plan_fits_and_covers_every_chunk(level, dtype, widths, b, l) -> None:
    """B7/B8's plan at every (L, D) the int8 kernels served before their
    redesign: it fits shared memory, its tail covers every (row tile,
    512-unit chunk) exactly once with one partial slot per chunk (B*L x D
    floats each, so the finish adds them in chunk order), B8's attention
    covers every query row and key, and a call makes four CUDA launches."""
    d, h, f = widths
    size = torch.finfo(dtype).bits // 8
    plan = fe.int8_plan(b, l, d, h, f, dtype, level)
    layer, sched, n = plan["layer"], plan["tail_schedule"], b * l
    check_int8_layer_plan(layer, d, size, level)
    assert sched["chunks"] == -(-f // fe.INT8_FFN_CHUNK) == sched["parts"]
    assert sched["tiles"] == len(fe.row_tiles(n, layer["tm"]))
    assert 1 <= sched["ctas"] <= min(plan["tail_ctas_per_sm"] * fe.SMS, sched["units"])
    cap = min(plan["tail_ctas_per_sm"] * fe.SMS, sched["units"])
    assert -(-sched["units"] // sched["ctas"]) == -(-sched["units"] // cap)
    seen = torch.zeros(sched["tiles"], sched["chunks"], dtype=torch.int64)
    for _, tile, c_lo, c_hi, _ in fe.tail_segments(sched):
        seen[tile, c_lo:c_hi] += 1
    assert bool((seen == 1).all())
    ws = plan["workspaces"]
    assert ws["part"] == (sched["chunks"] * n * d, torch.float32)
    assert ws["x1"] == (n * d, torch.float32)
    names = [k for k, _, _ in plan["kernels"]]
    assert plan["launches"] == len(names) == 4
    assert names[2:] == ["int8_tail_kernel", "int8_finish_kernel"]
    assert plan["kernels"][2][1] == (sched["ctas"],) and plan["kernels"][3][1] == (-(-n // 8),)
    if level == 2:
        assert names[:2] == ["qkv_int8_kernel", "attention_int8_kernel"]
        assert ws["qkv"] == (n * 2 * d, dtype) and ws["o"] == (n * d, torch.float32)
        assert ws["v"] == (n * d, torch.float32)
        assert layer["kdh"] >= d // h and layer["kdh"] % (8 if size == 4 else 16) == 0
        assert layer["q_tiles"] * 128 >= l and layer["key_blocks"] * 64 >= l
        assert layer["warps"] == min(8, -(-l // 16))
        qkv_grid = plan["kernels"][0][1]
        assert qkv_grid[0] * 64 >= n and qkv_grid[1] * 64 >= 3 * d
        assert plan["kernels"][1][1] == (b * h, layer["q_tiles"])
    else:
        assert names[:2] == ["gemm_kernel", "attention_fwd_kernel"]
        assert ws["qkv"] == (n * 3 * d, dtype) and ws["o"] == (n * d, dtype)
        assert ws["v"] is None


def test_int8_flagship_plan_keeps_two_ctas_per_sm() -> None:
    """At the flagship's sampling shape (B=32, L=100, D=72, F=2048) the int8
    tail's shared memory fits twice on an SM, as B1's does; its 400 (row
    tile, chunk) units need two a CTA on 264 CTAs, so 200 CTAs take two
    each, both of one row tile: one out projection and LN1 per CTA. So it
    does at D=128."""
    for dtype, level, d in itertools.product((torch.float32, torch.bfloat16), (1, 2), (72, 128)):
        plan = fe.int8_plan(32, 100, d, 8 if d == 128 else 12, 2048, dtype, level)
        sched = plan["tail_schedule"]
        assert plan["tail_ctas_per_sm"] == 2, (dtype, level, d)
        assert (sched["units"], sched["ctas"]) == (400, 200)
        segments = fe.tail_segments(sched)
        assert len(segments) == 200 and all(c_hi - c_lo == 2 for _, _, c_lo, c_hi, _ in segments)


@pytest.mark.parametrize("layout,d_model,n_head", [((256, 2), 72, 12), ((128, 3), 128, 8),
                                                    ((128, 2), 192, 4)])
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_plan_takes_each_tail_layout_where_it_keeps_two_ctas(
        layout, d_model, n_head, level, dtype) -> None:
    """Each of ``INT8_TAIL_LAYOUTS`` is the first whose shared memory fits
    twice on an SM at some width: 256-wide tiles at D=72, 128-wide in a ring
    of three at D=128, of two at D=192, where those before it fit once."""
    plan = fe.int8_plan(32, 100, d_model, n_head, 2048, dtype, level)
    assert (plan["layer"]["wt"], plan["layer"]["slots"]) == layout
    assert plan["tail_ctas_per_sm"] == 2
    for earlier in fe.INT8_TAIL_LAYOUTS[:fe.INT8_TAIL_LAYOUTS.index(layout)]:
        tail = fe.int8_tail_layout(d_model, dtype, level, plan["layer"]["tm"], *earlier)
        assert 2 * (tail["bytes"] + 1024) > fe.SM_SMEM


@pytest.mark.parametrize("layout", [(16, 128, 2), (16, 256, 3), (32, 128, 3), (32, 256, 2)])
def test_int8_plan_takes_a_given_tail_layout(layout) -> None:
    """A layout given to the plan (as ``scripts/int8_tail_sweep.py`` gives
    it) replaces its choice, and its tail still covers every (row tile,
    chunk) once; one that does not fit shared memory is refused."""
    plan = fe.int8_plan(8, 100, 72, 12, 2048, torch.bfloat16, 2, layout=layout)
    layer, sched = plan["layer"], plan["tail_schedule"]
    assert (layer["tm"], layer["wt"], layer["slots"]) == layout
    assert layer["bytes"] == fe.int8_tail_layout(72, torch.bfloat16, 2, *layout)["bytes"]
    assert layer["bytes"] <= fe.SMEM_LIMIT and layer["attn_bytes"] > 0
    seen = torch.zeros(sched["tiles"], sched["chunks"], dtype=torch.int64)
    for _, tile, c_lo, c_hi, _ in fe.tail_segments(sched):
        seen[tile, c_lo:c_hi] += 1
    assert sched["tiles"] == len(fe.row_tiles(800, layout[0])) and bool((seen == 1).all())
    with pytest.raises(ValueError):  # more shared memory than a CTA may take
        fe.int8_plan(8, 100, 256, 8, 2048, torch.float32, 1, layout=(16, 256, 8))
    with pytest.raises(ValueError):  # 32-row tiles hold up to 128 columns
        fe.int8_plan(8, 100, 192, 8, 2048, torch.float32, 1, layout=(32, 128, 2))


@pytest.mark.parametrize("d_model,n_head,level", [(264, 8, 1), (20, 4, 1), (72, 1, 2)])
def test_int8_plan_refuses_what_no_kernel_serves(d_model, n_head, level) -> None:
    """Wider than the tail's register tiles (256), a width not divisible by
    8, or (B8) heads wider than its attention's 64: a ValueError, never a
    launch."""
    with pytest.raises(ValueError):
        fe.int8_plan(2, 19, d_model, n_head, 512, torch.float32, level)


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

def check_fwd_plan(plan: dict, l: int, dh: int, dtype: torch.dtype,
                   fast: bool = False) -> None:
    """What every forward plan holds: every query row in exactly one warp's
    16 rows and every key in one block of 64; the ring's shared memory the
    same at every L and within 232,448 bytes; resident exactly where the
    head's K and V take at most half of that (so two CTAs share an SM), its
    shared memory then theirs, and S kept exactly where resident in bf16's
    exact form at most KEPT_BLOCKS key blocks at kdh 16; the struct the
    fields in order."""
    size = torch.finfo(dtype).bits // 8
    assert plan["warps"] == min(fa.MAX_WARPS, -(-l // fa.WARP_ROWS))
    seen = torch.zeros(l, dtype=torch.int64)
    for y in range(plan["q_tiles"]):
        for w in range(plan["warps"]):
            r0 = y * fa.TILE_ROWS + w * fa.WARP_ROWS
            seen[r0:min(l, r0 + fa.WARP_ROWS)] += 1
    assert bool((seen == 1).all())
    assert (plan["key_blocks"] - 1) * fa.KEY_BLOCK < l <= plan["key_blocks"] * fa.KEY_BLOCK
    assert plan["kdh"] >= dh and plan["stride"] >= plan["kdh"]
    ring = fa.FWD_STAGES * plan["stage"] * size
    assert ring == fa.FWD_STAGES * fa.attention_fwd_plan(19, dh, dtype)["stage"] * size
    assert ring <= fe.SMEM_LIMIT
    head = 2 * plan["key_blocks"] * fa.KEY_BLOCK * plan["stride"] * size
    assert plan["resident"] == int(head <= fe.SMEM_LIMIT // 2)
    assert plan["bytes"] == (head if plan["resident"] else ring)
    assert plan["bytes"] <= (fe.SMEM_LIMIT // 2 if plan["resident"] else fe.SMEM_LIMIT)
    assert plan["kept"] == int(plan["resident"] == 1 and size == 2 and not fast
                               and plan["key_blocks"] <= fa.KEPT_BLOCKS
                               and plan["kdh"] == fa.KEPT_DH)
    struct = plan["struct"]
    assert [getattr(struct, k) for k, _ in struct._fields_] == [
        plan[k] for k, _ in fa.AttnFwdPlan._fields_]


B2_LENGTHS = (1, 17, 24, 100, 128, 129, 187, 251, 252, 365)
B2_WIDTHS = (1, 6, 8, 12, 16, 22, 32, 33, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("l", B2_LENGTHS)
def test_attention_plan_covers_every_row_and_key(dtype, l) -> None:
    """Every query row in exactly one warp's 16 rows (at most 8 warps, 128
    rows, per CTA), every key in one block of 64, the instance's width
    covering dh in steps of the mma's k, bank-conflict-free strides with
    16-byte rows, and shared memory (``check_fwd_plan``) within 232,448
    bytes up to dh 64: the ring's, two stages of a K and a V block, the same
    at every L, or where resident the head's K and V."""
    size = torch.finfo(dtype).bits // 8
    for dh in B2_WIDTHS:
        plan = fa.attention_fwd_plan(l, dh, dtype)
        check_fwd_plan(plan, l, dh, dtype)
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
        struct = plan["struct"]
        assert [getattr(struct, k) for k, _ in struct._fields_] == [
            plan[k] for k, _ in fa.AttnFwdPlan._fields_]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [6, 12, 16, 33, 64])
def test_attention_fwd_plan_is_resident_where_the_head_fits(dtype, dh) -> None:
    """At every L from 1 to 3616 (the longest the unfused path is checked
    at): the plan covers every row and key (``check_fwd_plan``); it holds
    the head's K and V exactly where they take at most half the shared
    memory, from L=1 up to its last resident length and at no L past it
    (every L to 1152 at dh <= 16 in bf16 and at dh 6 in fp32, as B5's launch
    1), the fast form on the same tiles and in the same form; bf16's exact
    form keeps S exactly at L <= 128 and dh <= 16, fp32 and the fast form
    never."""
    resident, kept = [], []
    for l in range(1, 3617):
        plan = fa.attention_fwd_plan(l, dh, dtype)
        check_fwd_plan(plan, l, dh, dtype)
        resident.append(plan["resident"])
        kept.append(plan["kept"])
        if dtype == torch.bfloat16 and dh < fa.DH_PAD and l % 97 == 0:
            fast = fa.attention_fwd_plan(l, dh, dtype, fast=True)
            check_fwd_plan(fast, l, dh, dtype, fast=True)
            assert {**fast, "struct": None} == {**plan, "kept": 0, "struct": None}
    last = max(i + 1 for i, r in enumerate(resident) if r)
    assert all(resident[:last]) and not any(resident[last:])
    bf16 = dtype == torch.bfloat16
    assert kept == [int(bf16 and dh <= 16 and l <= 128) for l in range(1, 3617)]
    if (bf16 and dh <= 16) or dh == 6:
        assert last == 1152
    assert last == max(l for l in range(1, 3617)
                       if fa.attention_bwd_plan(l, dh, dtype)["resident"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("l", [1, 100, 128, 129, 365, 1152, 1153, 2048])
def test_attention_fwd_forms_are_the_plan_in_another_form(dtype, l) -> None:
    """``attention_fwd_form``: the ring form streams the plan's tiles (two
    stages of shared memory, neither resident nor kept), the resident form
    holds the head's K and V without keeping S, and exists exactly where the
    head fits in half the shared memory; the tiles stay the plan's."""
    plan = fa.attention_fwd_plan(l, 16, dtype)
    size = torch.finfo(dtype).bits // 8
    ring = fa.attention_fwd_form(l, 16, dtype, "ring")
    resident = fa.attention_fwd_form(l, 16, dtype, "resident")
    tiles = ("kdh", "warps", "q_tiles", "key_blocks", "stride", "stage")
    assert {k: ring[k] for k in tiles} == {k: plan[k] for k in tiles}
    assert (ring["resident"], ring["kept"]) == (0, 0)
    assert ring["bytes"] == fa.FWD_STAGES * plan["stage"] * size
    head = 2 * plan["key_blocks"] * fa.KEY_BLOCK * plan["stride"] * size
    assert (resident is None) == (head > fe.SMEM_LIMIT // 2)
    if resident is not None:
        assert {k: resident[k] for k in tiles} == {k: plan[k] for k in tiles}
        assert (resident["resident"], resident["kept"], resident["bytes"]) == (1, 0, head)
    for form in (ring, resident):
        if form is not None:
            assert [getattr(form["struct"], k) for k, _ in fa.AttnFwdPlan._fields_] == [
                form[k] for k, _ in fa.AttnFwdPlan._fields_]
    with pytest.raises(ValueError):
        fa.attention_fwd_form(l, 16, dtype, "kept")


def _c_struct_fields(name: str) -> list[str]:
    """The field names of ``struct name`` in ``csrc/attention_mma.cuh``, in order."""
    text = (Path(fa.__file__).resolve().parents[1] / "csrc" / "attention_mma.cuh").read_text()
    body = text.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    return [m.group(1) for m in re.finditer(r"^\s*int\s+(\w+);", body, re.MULTILINE)]


@pytest.mark.parametrize("name", ["AttnFwdPlan", "AttnBwdPlan"])
def test_plan_structs_match_the_kernels_structs(name) -> None:
    """The ``ctypes`` plan structs hold the C structs' int fields in the same
    order (the training layer's plans embed them, so a field added on one
    side only would read as another on the other)."""
    ours = getattr(fa, name)
    theirs = _c_struct_fields(name)
    assert [f for f, _ in ours._fields_] == theirs
    assert all(t is ctypes.c_int for _, t in ours._fields_)
    assert ctypes.sizeof(ours) == 4 * len(theirs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_forward_launch_takes_a_given_plan(dtype, monkeypatch) -> None:
    """``_launch_fwd`` hands the kernel the plan it is given (another form
    of the plan, for the checks that every form gives the same bits), else
    the plan of its shape."""
    recorder = _PlanRecorder()
    monkeypatch.setattr(fa, "_library", lambda: recorder)
    monkeypatch.setattr(fa, "_dropout_args", lambda q, seed, rate: [
        None if seed is None else 1, 0, 1.0, 1, 0])
    monkeypatch.setattr(fa, "dropout_fwd_launches", 0)
    q = torch.zeros(1, 2, 100, 16, dtype=dtype)
    ring = fa.attention_fwd_form(100, 16, dtype, "ring")
    fa._launch_fwd(q, q, q, torch.tensor([5]), 0.1, plan=ring)
    fa._launch_fwd(q, q, q, torch.tensor([5]), 0.1)
    (_, given, _), (_, own, _) = recorder.calls
    plan = fa.attention_fwd_plan(100, 16, dtype)
    assert given == {k: ring[k] for k, _ in fa.AttnFwdPlan._fields_}
    assert own == {k: plan[k] for k, _ in fa.AttnFwdPlan._fields_}
    assert fa.dropout_fwd_launches == 2


# ---- B6-fwd: B2's kernel with the keep factors, on B2's fp32 plan ---------------------------

# Up to the longest L B2 is checked at on the card; 1607 was the longest L
# at dh 16 of B6-fwd's earlier body, which staged the whole head.
DROPOUT_LENGTHS = (19, 100, 365, 1607, 1608, 2048, 3616)


class _PlanRecorder:
    """Stands in for the built library: records the plan that
    ``fdiff_attention_fwd`` is given and reports success."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []

    def fdiff_attention_fwd(self, variant, *args) -> int:
        plan = args[9]._obj  # ctypes.byref(AttnFwdPlan)
        self.calls.append((variant, {k: getattr(plan, k) for k, _ in plan._fields_}, args[10]))
        return 0


@pytest.mark.parametrize("l", [19, 365, 2048])
def test_dropout_forward_launch_takes_b2_fp32_plan(l, monkeypatch) -> None:
    """The B6-fwd wrapper hands the kernel B2's fp32 plan at the call's L
    and dh (variant 0, the seed's pointer set), as B2's own launch gets it."""
    recorder = _PlanRecorder()
    monkeypatch.setattr(fa, "_library", lambda: recorder)
    monkeypatch.setattr(fa, "_dropout_args", lambda q, seed, rate: [
        None if seed is None else 1, 0, 1.0, 1, 0])
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fa, "dropout_fwd_launches", 0)
    q = torch.zeros(1, 2, l, 6)
    fa._launch_fwd(q, q, q, torch.tensor([5]), 0.1)
    fa._launch_fwd(q, q, q)
    (variant, plan, seed), (b2_variant, b2_plan, b2_seed) = recorder.calls
    fp32 = fa.attention_fwd_plan(l, 6, torch.float32)
    assert (variant, seed, b2_variant, b2_seed) == (0, 1, 0, None)
    assert plan == b2_plan == {k: fp32[k] for k, _ in fa.AttnFwdPlan._fields_}
    assert (fa.dropout_fwd_launches, fa.launches) == (1, 1)


@pytest.mark.parametrize("dh", [6, 12, 16, 64])
@pytest.mark.parametrize("l", DROPOUT_LENGTHS)
def test_dropout_forward_plan_covers_every_length(l, dh) -> None:
    """B6-fwd's plan, B2's in fp32, puts every query row in exactly one
    warp's 16 rows and every key in one block of 64 up to L=3616, with
    shared memory within 232,448 bytes at every L: the ring's, which does
    not grow with L, or where resident the head's K and V, at most half of
    it (``check_fwd_plan``; the earlier body's grew as (2 L dh + 4 (L + 64))
    fp32 values and passed 232,448 bytes from L=1608 at dh 16)."""
    plan = fa.attention_fwd_plan(l, dh, torch.float32)
    seen = torch.zeros(l, dtype=torch.int64)
    for y in range(plan["q_tiles"]):
        for w in range(plan["warps"]):
            r0 = y * fa.TILE_ROWS + w * fa.WARP_ROWS
            seen[r0:min(l, r0 + fa.WARP_ROWS)] += 1
    assert bool((seen == 1).all())
    assert (plan["key_blocks"] - 1) * fa.KEY_BLOCK < l <= plan["key_blocks"] * fa.KEY_BLOCK
    check_fwd_plan(plan, l, dh, torch.float32)
    assert plan["bytes"] <= fe.SMEM_LIMIT
    if dh == 16:
        whole_head = (2 * l * dh + 4 * (l + 64)) * 4
        assert (whole_head <= fe.SMEM_LIMIT) == (l <= 1607)


# ---- B5/B6-bwd: the attention backward's tiles ----------------------------------------------


BWD_LENGTHS = [1, 19, 64, 100, 128, 129, 365, 775, 896, 1152, 1153, 3616]


def check_bwd_plan(plan: dict, l: int, dh: int, dtype: torch.dtype) -> None:
    """What both dtypes' backward plans hold: every row (query rows in
    launch 1, keys in launch 2) in exactly one warp's 16 rows, every key
    (launch 1) and query row (launch 2) in one block of 64; the ring's
    shared memory the same at every L and within 232,448 bytes (launch 2's,
    and launch 1's where it streams: the kernel that staged the whole head
    refused L >= 775 at dh 16); launch 1 resident exactly where the head's K
    and V take at most half of that, so two CTAs share an SM; S kept in
    registers exactly where resident in bf16 at L <= 128 and kdh 16."""
    size = torch.finfo(dtype).bits // 8
    assert plan["warps"] == min(fa.MAX_WARPS, -(-l // fa.WARP_ROWS))
    seen = torch.zeros(l, dtype=torch.int64)
    for y in range(plan["tiles"]):
        for w in range(plan["warps"]):
            r0 = y * fa.TILE_ROWS + w * fa.WARP_ROWS
            seen[r0:min(l, r0 + fa.WARP_ROWS)] += 1
    assert bool((seen == 1).all())
    assert (plan["blocks"] - 1) * fa.KEY_BLOCK < l <= plan["blocks"] * fa.KEY_BLOCK
    assert plan["kdh"] >= dh and plan["stride"] >= plan["kdh"]
    assert plan["bytes"] == fa.FWD_STAGES * plan["stage"] * size
    assert plan["bytes"] == fa.attention_bwd_plan(19, dh, dtype)["bytes"] <= fe.SMEM_LIMIT
    head = 2 * plan["blocks"] * fa.KEY_BLOCK * plan["stride"] * size
    assert plan["resident"] == int(head <= fe.SMEM_LIMIT // 2)
    assert plan["dq_bytes"] == (head if plan["resident"] else plan["bytes"])
    assert plan["dq_bytes"] <= (fe.SMEM_LIMIT // 2 if plan["resident"] else fe.SMEM_LIMIT)
    assert plan["kept"] == int(plan["resident"] == 1 and size == 2
                               and plan["blocks"] <= fa.KEPT_BLOCKS and plan["kdh"] == fa.KEPT_DH)
    struct = plan["struct"]
    assert [getattr(struct, k) for k, _ in struct._fields_] == [
        plan[k] for k, _ in fa.AttnBwdPlan._fields_]


@pytest.mark.parametrize("dh", [6, 12, 16, 64])
@pytest.mark.parametrize("l", BWD_LENGTHS)
def test_attention_bwd_plan_covers_every_row_and_key(l, dh) -> None:
    """The fp32 launches (``check_bwd_plan``): the instance's width covering
    dh in steps of 8, bank-conflict-free strides with 16-byte rows, a stage
    of two blocks and 64 rows of fp32 statistics, S never kept."""
    plan = fa.attention_bwd_plan(l, dh)
    check_bwd_plan(plan, l, dh, torch.float32)
    assert plan["kdh"] % 8 == 0 and plan["kdh"] < 2 * max(dh, 8)
    assert plan["stride"] % 8 == 4 and plan["kept"] == 0
    assert plan["stage"] == 2 * fa.KEY_BLOCK * plan["stride"] + fa.KEY_BLOCK * fa.STAT_COLS
    assert plan["stage"] % 4 == 0  # the second stage starts on 16 bytes


@pytest.mark.parametrize("dh", [6, 12, 16, 64])
@pytest.mark.parametrize("l", BWD_LENGTHS)
def test_bf16_attention_bwd_plan_covers_every_row_and_key(l, dh) -> None:
    """The bf16 launches (``check_bwd_plan``): the same tiles and blocks as
    fp32's, the instance's width covering dh in steps of 16 (bf16
    m16n8k16's k), strides of 2-byte elements with S % 16 == 8 (ldmatrix
    rows of 16 bytes in distinct banks), a stage of two bf16 blocks and the
    fp32 statistics of 64 rows (192 floats, 384 bf16 elements; the second
    stage starts on 16 bytes), the ring's shared memory at most fp32's, and
    launch 1 resident wherever fp32's is."""
    plan = fa.attention_bwd_plan(l, dh, torch.bfloat16)
    fp32 = fa.attention_bwd_plan(l, dh)
    check_bwd_plan(plan, l, dh, torch.bfloat16)
    assert {k: plan[k] for k in ("warps", "tiles", "blocks")} == {
        k: fp32[k] for k in ("warps", "tiles", "blocks")}
    assert plan["kdh"] % 16 == 0 and plan["kdh"] < 2 * max(dh, 16)
    assert plan["stride"] % 16 == 8 and plan["stride"] * 2 % 16 == 0
    assert plan["stage"] == 2 * fa.KEY_BLOCK * plan["stride"] + fa.KEY_BLOCK * fa.STAT_COLS * 2
    assert 2 * fa.KEY_BLOCK * plan["stride"] * 2 % 16 == 0  # the statistics' first byte
    assert plan["stage"] * 2 % 16 == 0  # the second stage's first byte
    assert plan["bytes"] <= fp32["bytes"] and plan["resident"] >= fp32["resident"]
    assert plan["kept"] == int(l <= 128 and dh <= 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh,max_len", [(6, 3616), (16, 896), (64, 896)])
def test_attention_bwd_plan_is_resident_where_the_head_fits(dtype, dh, max_len) -> None:
    """At every L from 1 to ``max_len`` (dh 6 to 3616, the longest the
    unfused path is checked at; dh 16 and 64 to 896, the longest that JAX's
    backward serves at dh 16): both launches cover every row once, launch 1
    holds the head's K and V exactly where they take at most half the
    shared memory and streams them through the ring beyond, so every length
    runs. In bf16 at dh <= 16 that is every L to 896 (86,016 bytes there)
    and on to 1152, in fp32 at dh 6 to 1152 too; the flagship's heads (L
    100, dh 6) keep S in bf16."""
    size = torch.finfo(dtype).bits // 8
    resident = []
    for l in range(1, max_len + 1):
        plan = fa.attention_bwd_plan(l, dh, dtype)
        assert (plan["tiles"] - 1) * fa.TILE_ROWS < l <= plan["tiles"] * fa.TILE_ROWS
        assert plan["warps"] * fa.WARP_ROWS >= min(l, fa.TILE_ROWS)
        assert (plan["blocks"] - 1) * fa.KEY_BLOCK < l <= plan["blocks"] * fa.KEY_BLOCK
        head = 2 * plan["blocks"] * fa.KEY_BLOCK * plan["stride"] * size
        assert plan["resident"] == int(head <= fe.SMEM_LIMIT // 2)
        assert plan["dq_bytes"] <= fe.SMEM_LIMIT and plan["bytes"] <= fe.SMEM_LIMIT
        resident.append(plan["resident"])
    last = max(i + 1 for i, r in enumerate(resident) if r)
    assert all(resident[:last]) and not any(resident[last:])
    if dtype == torch.bfloat16 and dh <= 16:
        assert last == min(max_len, 1152)
        assert fa.attention_bwd_plan(896, dh, dtype)["dq_bytes"] == 86016
        assert fa.attention_bwd_plan(1152, dh, dtype)["resident"] == 1
        assert fa.attention_bwd_plan(1153, dh, dtype)["resident"] == 0
    if dtype == torch.float32 and dh == 6:
        assert last == 1152
    assert fa.attention_bwd_plan(100, 6, dtype)["kept"] == int(dtype == torch.bfloat16)


class _BwdPlanRecorder:
    """Stands in for the built library: records the variant and the plan
    that ``fdiff_attention_bwd`` is given and reports success."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []

    def fdiff_attention_bwd(self, variant, *args) -> int:
        plan = args[14]._obj  # ctypes.byref(AttnBwdPlan)
        self.calls.append((variant, {k: getattr(plan, k) for k, _ in plan._fields_}, args[15]))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_backward_launch_takes_the_plan_of_its_dtype(dtype, monkeypatch) -> None:
    """B5 and B6-bwd hand the kernels the variant (0 fp32, 1 bf16) and the
    plan of the tensors' dtype, with and without the seed's pointer; a bf16
    tensor is not refused."""
    recorder = _BwdPlanRecorder()
    monkeypatch.setattr(fa, "_library", lambda: recorder)
    monkeypatch.setattr(fa, "_dropout_args", lambda q, seed, rate: [
        None if seed is None else 1, 0, 1.0, 1, 0])
    monkeypatch.setattr(fa, "bwd_launches", 0)
    monkeypatch.setattr(fa, "dropout_bwd_launches", 0)
    q = torch.zeros(1, 2, 100, 6, dtype=dtype)
    grads = fa._launch_bwd(q, q, q, q, q)
    fa._launch_bwd(q, q, q, q, q, torch.tensor([5]), 0.1)
    want = fa.attention_bwd_plan(100, 6, dtype)
    for (variant, plan, _), seed in zip(recorder.calls, (None, 1)):
        assert variant == (0 if dtype == torch.float32 else 1)
        assert plan == {k: want[k] for k, _ in fa.AttnBwdPlan._fields_}
    assert [c[2] for c in recorder.calls] == [None, 1]
    assert all(g.dtype == dtype for g in grads[:3]) and grads[3].dtype == torch.float32
    assert (fa.bwd_launches, fa.dropout_bwd_launches) == (1, 1)


@pytest.mark.parametrize("l", [19, 365, 2048])
def test_bf16_dropout_forward_launch_takes_b2_bf16_plan(l, monkeypatch) -> None:
    """B6-fwd in bf16 takes the exact form (variant 1, the seed's pointer
    set) on B2's bf16 plan at the call's L and dh (resident and S kept where
    its rules say), where B2 at dh 6 takes the fast form (variant 2) on the
    same plan without S kept."""
    recorder = _PlanRecorder()
    monkeypatch.setattr(fa, "_library", lambda: recorder)
    monkeypatch.setattr(fa, "_dropout_args", lambda q, seed, rate: [
        None if seed is None else 1, 0, 1.0, 1, 0])
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fa, "dropout_fwd_launches", 0)
    q = torch.zeros(1, 2, l, 6, dtype=torch.bfloat16)
    fa._launch_fwd(q, q, q, torch.tensor([5]), 0.1)
    fa._launch_fwd(q, q, q)
    (variant, plan, seed), (b2_variant, b2_plan, b2_seed) = recorder.calls
    bf16 = fa.attention_fwd_plan(l, 6, torch.bfloat16)
    fast = fa.attention_fwd_plan(l, 6, torch.bfloat16, fast=True)
    assert (variant, seed, b2_variant, b2_seed) == (1, 1, 2, None)
    assert plan == {k: bf16[k] for k, _ in fa.AttnFwdPlan._fields_}
    assert b2_plan == {k: fast[k] for k, _ in fa.AttnFwdPlan._fields_} == {**plan, "kept": 0}
    assert (plan["resident"], plan["kept"]) == ((1, int(l <= 128)) if l <= 1152 else (0, 0))
    assert (fa.dropout_fwd_launches, fa.launches) == (1, 1)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three TF32 products with fp32 sums (lo hi + hi lo + hi hi)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def b2_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 keep: torch.Tensor | None = None) -> torch.Tensor:
    """B2's order of operations over (B, H, L, dh) heads: pass 1 over key
    blocks of 64 keeps each row's running max and its sum of exp(s - max),
    rescaled as the max grows (the fast form: the sum of exp(s), s clamped
    to +-60, q pre-scaled); pass 2 recomputes S block by block, forms P,
    multiplies it by ``keep`` (B6-fwd, fp32), rounds it to the input type
    and adds P V. fp32 products as 3xTF32, bf16 products exact in fp32."""
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
        if keep is not None:
            p = p * keep[..., j0:j1]
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


@pytest.mark.parametrize("dh", [6, 16])
@pytest.mark.parametrize("l,seed", [(24, 3), (100, 2**31 - 2), (365, 99)])
def test_dropout_forward_order_matches_jax(dh, l, seed) -> None:
    """B6-fwd's order of operations (B2's two passes, P times the keep
    factors after it is normalised, the products as 3xTF32) against JAX's
    ``_dropout_fwd_kernel`` in interpret mode, at B2's fp32 tolerance."""
    rng = np.random.default_rng(l * 10 + dh)
    q, k, v = (rng.normal(size=(2, 12, l, dh)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_flash_dropout(*(jnp.asarray(a) for a in (q, k, v)),
                                       jnp.asarray(seed, jnp.int32), 0.1))
    keep = fa.attention_keep(2, 12, l, seed, 0.1)
    ours = b2_emulation(*(torch.from_numpy(a) for a in (q, k, v)), keep)
    np.testing.assert_allclose(ours.numpy(), ref, **B2_TOL[torch.float32])
