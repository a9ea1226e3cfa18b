"""Times the attention backward kernels B5 (dropout 0) and B6-bwd (dropout
0.1) at the unfused training path's shape (B=64, H=12, L=100, dh=6, fp32),
in turns, from one or more checkouts of the repository.

    python3 scripts/attention_bwd_timing.py [ROOT ...] [--rounds 5]

Each ROOT (default: this checkout) runs in a process of its own, one after
another, which imports ``fourierdiffusion_tpu_torch`` from that root and
builds its ``csrc/flash_attention.cu``; give ``parent change change parent``
to compare two checkouts on one card. The inputs are ``chip_smoke.py``'s
(phase 10). Each round times each kernel four ways:

* ``after_idle_ms``: ``chip_smoke.py``'s ``time_ms`` (5 calls, then CUDA
  events around 50), started after the card has idled for a second;
* ``steady_ms``: CUDA events around 1000 calls after 200;
* ``host_ms``: the seconds the host takes to issue 200 calls (400 CUDA
  launches, fewer than the launch queue holds, so it never waits on the
  card), per call;
* ``device_ms``: CUDA events around each of 50 single calls, each after a
  synchronise, their median: the card's time for one call, with the
  host's issue of the second launch inside it.

Prints the card's name and power limit, each root's readings and one JSON
object, also written to ``chiprun_out/attention_bwd_timing.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPE = (64, 12, 100, 6)
DROPOUT = 0.1
SMI_FIELDS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def child(root: Path, rounds: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from fourierdiffusion_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")

    def events_ms(fn, iters: int, warmup: int) -> float:
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters: int = 200) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * issued / iters

    def device_ms(fn, iters: int = 50) -> float:
        times = []
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, l, dh = SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g, device="cuda") for _ in range(4))
    seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    calls = {
        "B5": (lambda o: lambda: fa._launch_bwd(q, k, v, o, do, None, 0.0))(
            fa.flash_attention_reference(q, k, v)),
        "B6-bwd": (lambda o: lambda: fa._launch_bwd(q, k, v, o, do, seed, DROPOUT))(
            fa.flash_attention_dropout_reference(q, k, v, seed, DROPOUT)),
    }
    t0 = time.perf_counter()
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0  # the build (or cache load) included
    before = smi(SMI_FIELDS)
    out = []
    for _ in range(rounds):
        r = {}
        for name, fn in calls.items():
            time.sleep(1.0)
            r[name] = {"after_idle_ms": events_ms(fn, 50, 5),
                       "steady_ms": events_ms(fn, 1000, 200),
                       "host_ms": host_ms(fn), "device_ms": device_ms(fn)}
        out.append(r)
    return {"root": str(root), "first_call_s": first_call_s, "smi_before": before,
            "smi_after": smi(SMI_FIELDS), "rounds": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=[str(REPO)])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.roots[0]), args.rounds)), flush=True)
        return 0
    print(smi("name,power.limit"), flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", "--rounds", str(args.rounds), root],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ""},
        )
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        summary = {
            name: {mode: [round(r[name][mode], 5) for r in run["rounds"]]
                   for mode in run["rounds"][0][name]}
            for name in run["rounds"][0]
        }
        print(f"{root}: first call {run['first_call_s']:.1f} s; "
              f"smi ({SMI_FIELDS}) {run['smi_before']} -> {run['smi_after']}; "
              f"{json.dumps(summary)}", flush=True)
    result = {"device": smi("name,power.limit"), "shape": SHAPE, "runs": runs}
    out = REPO / "chiprun_out" / "attention_bwd_timing.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": result["device"], "roots": args.roots}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
