"""Times B7 and B8 (the int8 sampling layers) under other layouts of their
int8 tail: rows per tile, weight-tile width and ring depth.

For each layout that fits shared memory (``fused_encoder.int8_tail_layout``),
given to ``fused_encoder.launch_int8`` as its ``layout``, the layer at B=32,
L=100 (the flagship's sampling shape, random weights from a seed) is checked
against the plan's own layout's output bit for bit and timed by CUDA events (ms per call), the tail launch alone by
``torch.profiler`` (device us per launch); prints one JSON object with the
card's name and power limit. Layouts are compared within one run only.

    python3 scripts/int8_tail_sweep.py
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer  # noqa: E402
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe  # noqa: E402

B, L, D, H, F = 32, 100, 72, 12, 2048


def ms_per_call(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tail_us(fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    for e in prof.key_averages():
        if "int8_tail_kernel" in e.key and e.device_time_total > 0:
            return e.device_time_total / e.count
    return float("nan")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(D, H, F)
    out = {"card": smi, "shape": f"B={B} L={L} D={D} H={H} F={F}", "runs": []}
    for dtype, level in itertools.product((torch.bfloat16, torch.float32), (1, 2)):
        packed = {k: v.cuda() for k, v in fe.pack_encoder_layer(
            layer, H, dtype, int8_ffn=True, int8_attn=level == 2).items()}
        x = torch.randn(B, L, D, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
        ref = fe.launch_int8(x, packed, H)
        chosen = fe.int8_layer_plan(L, D, H, dtype, level)
        for layout in itertools.product((16, 32), (128, 256), (2, 3)):
            if fe.int8_tail_layout(D, dtype, level, *layout)["bytes"] > fe.SMEM_LIMIT:
                continue
            plan = fe.int8_plan(B, L, D, H, F, dtype, level, fe.sm_count(x.device), layout)
            fn = lambda layout=layout: fe.launch_int8(x, packed, H, layout=layout)
            out["runs"].append({
                "dtype": str(dtype).removeprefix("torch."), "level": level, "tm": layout[0],
                "wt": layout[1], "slots": layout[2], "bytes": plan["layer"]["bytes"],
                "chosen": layout == (chosen["tm"], chosen["wt"], chosen["slots"]),
                "ctas_per_sm": plan["tail_ctas_per_sm"], "bit_identical": bool(
                    torch.equal(fn(), ref)), "ms": ms_per_call(fn), "tail_us": tail_us(fn)})
            print(json.dumps(out["runs"][-1]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
