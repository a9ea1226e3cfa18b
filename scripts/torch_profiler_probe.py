"""How often ``torch.profiler`` returns a trace with no device event.

Takes ``--traces`` traces in one process, each of ten calls of a small
``torch.mm`` with CUDA activity only (as ``chip_smoke.py``'s
``device_us_by_kernel`` takes them), the host idle for each of ``--pad-ms``
in turn at both ends of the trace's window, and prints one JSON object: the
traces taken, the kernel launches each should hold, and, for every trace
that held another number, its index, its pad, its start in seconds from
the first, and what it held.

    python3 scripts/torch_profiler_probe.py --traces 1200 --pad-ms 0 5
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 10


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=600)
    parser.add_argument("--pad-ms", type=float, nargs="+", default=[0.0])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    a = torch.randn((64, 64), device="cuda")
    odd, t0 = [], time.perf_counter()
    for i in range(args.traces):
        pad = args.pad_ms[i % len(args.pad_ms)] / 1e3
        for _ in range(3):
            torch.mm(a, a)
        torch.cuda.synchronize()
        start = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(CALLS):
                torch.mm(a, a)
            torch.cuda.synchronize()
            time.sleep(pad)
        held = sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0.0) > 0)
        if held != CALLS:
            odd.append({"trace": i, "pad_ms": pad * 1e3, "start_s": start, "launches": held})
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0), "traces": args.traces, "pad_ms": args.pad_ms,
                      "launches_expected": CALLS, "seconds": time.perf_counter() - t0,
                      "other_traces": odd}))


if __name__ == "__main__":
    main()
