"""Times the training layer's kernels B3 (forward) and B4 (backward) at the
flagship's training shape (B=64, L=100, D=72, H=12, F=2048, dropout 0.1),
in fp32 and bf16, in turns, from one or more checkouts of the repository.

    python3 scripts/train_attention_timing.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own, one after
another, which imports ``fourierdiffusion_tpu_torch`` and ``chip_smoke``
from that root and builds its two training libraries; give ``parent change
change parent`` to compare two checkouts on one card. The layer is a
seed-0 ``TransformerEncoderLayer``; its inputs are drawn from seed 2. Per
dtype, with ``chip_smoke.py``'s own timers:

* ``b3_ms``, ``b4_ms``: CUDA events around 50 (B3) and 20 (B4) calls after
  5 (``time_ms``);
* ``b4_stage_ms``: B4's milliseconds per stage (``BWD_STAGES``: CUDA events
  between its launches), the mean of 10 calls (``bwd_stage_ms``);
* ``b3_device_us``, ``b4_device_us``: device microseconds per call by
  kernel from ``torch.profiler`` (``device_us_by_kernel``), and the kernel
  launches per call;
* ``attention_ms``: the unfused path's attention kernels, which share
  ``csrc/attention_mma.cuh`` with the training layer, at the same heads
  (B=64, H=12, L=100, dh=6; seed-5 inputs): B2 (in bf16 its fast form),
  B6-fwd, B5 and B6-bwd, and B2's exact form at fast.yaml's heads (B=64,
  H=8, L=100, dh=16: ``B2 exact``), each by ``time_ms`` (50 calls);
* ``attention_device_us``: device microseconds per launch of B2, ``B2
  exact`` and B6-fwd there (``device_us_by_kernel``);
* ``digests``: sha256 of the outputs' bytes on those fixed-seed inputs, to
  hold the roots' outputs bit for bit against each other: B3's output;
  B4's dx, its 12 gradients and its attention stage's dq, dk, dv
  (``dqkv``); B5's and B6-bwd's dq, dk, dv and launch 1's statistics (m, l,
  D) at each of ``chip_smoke.BWD_SHAPES`` (phase 10's; seed-5 heads there
  too); B6-fwd's output at each of ``chip_smoke.DROPOUT_FWD_SHAPES`` and
  B2's at each of ``chip_smoke.B2_SHAPES`` (phase 9's), seed-5 heads.

Prints the card's name and power limit, each root's readings, whether
every digest is the same in all roots, and one JSON object, also written
to ``chiprun_out/train_attention_timing.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH, MAX_LEN, D_MODEL, N_HEAD, D_FF, DROPOUT = 64, 100, 72, 12, 2048, 0.1
SEED = 123456789
SMI_FIELDS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
    from fourierdiffusion_tpu_torch.ops import _build
    from fourierdiffusion_tpu_torch.ops import flash_attention as fa
    from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet

    for module in (cs, fet):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise RuntimeError(f"imported {module.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(_build.build, [*fet.DTYPES.values(), "flash_attention"]))
    build_s = time.perf_counter() - t0
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(D_MODEL, N_HEAD, D_FF, DROPOUT).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x32 = torch.randn((BATCH, MAX_LEN, D_MODEL), generator=g, device="cuda")
    dy32 = torch.randn((BATCH, MAX_LEN, D_MODEL), generator=g, device="cuda")
    out = {"root": str(root), "build_s": build_s, "smi_before": smi(SMI_FIELDS)}
    ga = torch.Generator(device="cuda").manual_seed(5)
    heads = [torch.randn((BATCH, N_HEAD, MAX_LEN, D_MODEL // N_HEAD), generator=ga,
                         device="cuda") for _ in range(4)]
    heads16 = [torch.randn((BATCH, 8, MAX_LEN, 16), generator=ga, device="cuda")
               for _ in range(3)]
    attn_seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
    for dtype in fet.DTYPES:
        lay = {k: t.detach() for k, t in fet.pack_encoder_layer_train(layer, N_HEAD,
                                                                      dtype).items()}
        x, dy = x32.to(dtype), dy32.to(dtype)

        def fwd():
            return fet._launch_fwd(x, lay, SEED, N_HEAD, DROPOUT)

        def bwd():
            return fet._launch_bwd(x, dy, lay, SEED, N_HEAD, DROPOUT)

        q, k, v, do = (t.to(dtype) for t in heads)
        o = fa.flash_attention_reference(q, k, v)
        o_drop = fa.flash_attention_dropout_reference(q, k, v, attn_seed, DROPOUT)
        q16 = [t.to(dtype) for t in heads16]
        attention = {
            "B2": lambda: fa._launch_fwd(q, k, v),
            "B6-fwd": lambda: fa._launch_fwd(q, k, v, attn_seed, DROPOUT),
            "B5": lambda: fa._launch_bwd(q, k, v, o, do),
            "B6-bwd": lambda: fa._launch_bwd(q, k, v, o_drop, do, attn_seed, DROPOUT),
            "B2 exact": lambda: fa._launch_fwd(*q16),
        }
        dx, grads, ws = fet._launch_bwd(x, dy, lay, SEED, N_HEAD, DROPOUT, stages=True)
        digests = {"B3": digest([fwd()]), "B4": digest([dx, *grads, ws["dqkv"]])}
        for name, shapes, sd in (("B6-fwd", cs.DROPOUT_FWD_SHAPES, attn_seed),
                                 ("B2", cs.B2_SHAPES, None)):
            for b, h, l, dh in shapes:
                gs = torch.Generator(device="cuda").manual_seed(5)
                qs, ks, vs = (torch.randn((b, h, l, dh), generator=gs, device="cuda").to(dtype)
                              for _ in range(3))
                digests[f"{name} B={b} H={h} L={l} dh={dh}"] = digest(
                    [fa._launch_fwd(qs, ks, vs, sd, DROPOUT if sd is not None else 0.0)])
        for b, h, l, dh in cs.BWD_SHAPES:
            gs = torch.Generator(device="cuda").manual_seed(5)
            qs, ks, vs, dos = (torch.randn((b, h, l, dh), generator=gs, device="cuda").to(dtype)
                               for _ in range(4))
            for name, sd, rate in (("B5", None, 0.0), ("B6-bwd", attn_seed, DROPOUT)):
                os_ = (fa.flash_attention_reference(qs, ks, vs) if sd is None else
                       fa.flash_attention_dropout_reference(qs, ks, vs, attn_seed, rate))
                digests[f"{name} B={b} H={h} L={l} dh={dh}"] = digest(
                    fa._launch_bwd(qs, ks, vs, os_, dos, sd, rate))
        b3 = cs.device_us_by_kernel(fwd)
        b4 = cs.device_us_by_kernel(bwd, calls=5)
        out[str(dtype).removeprefix("torch.")] = {
            "b3_ms": cs.time_ms(fwd, iters=50),
            "b4_ms": cs.time_ms(bwd, iters=20),
            "b4_stage_ms": cs.bwd_stage_ms(x, dy, lay, SEED, N_HEAD, calls=10),
            "b3_device_us": b3.us_by_kernel, "b3_launches": b3.launches,
            "b4_device_us": b4.us_by_kernel, "b4_launches": b4.launches,
            "attention_ms": {name: cs.time_ms(fn) for name, fn in attention.items()},
            "attention_device_us": {name: cs.device_us_by_kernel(attention[name]).us_per_launch
                                    for name in ("B2", "B2 exact", "B6-fwd")},
            "digests": digests,
        }
    out["smi_after"] = smi(SMI_FIELDS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=[str(REPO)])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.roots[0]))), flush=True)
        return 0
    card = smi("name,power.limit")
    print(card, flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", root],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ""},
        )
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        summary = {dt: {k: (round(v, 4) if isinstance(v, float) else
                            {n: round(t, 4) for n, t in v.items()}) for k, v in run[dt].items()
                        if k.endswith("_ms") or k.endswith("stage_ms")}
                   for dt in ("float32", "bfloat16")}
        print(f"{root}: build {run['build_s']:.1f} s; smi ({SMI_FIELDS}) {run['smi_before']} -> "
              f"{run['smi_after']}; {json.dumps(summary)}", flush=True)
        for dt in ("float32", "bfloat16"):
            for k in ("b3", "b4"):
                us = run[dt][f"{k}_device_us"]
                print(f"  {dt} {k.upper()} device us by kernel ({run[dt][f'{k}_launches']} "
                      f"launches per call): {json.dumps({n: round(t, 1) for n, t in us.items()})}"
                      f"; total {sum(us.values()):.1f}", flush=True)
            print(f"  {dt} attention device us per launch: " + json.dumps(
                {name: {n: round(t, 2) for n, t in us.items()}
                 for name, us in run[dt]["attention_device_us"].items()}), flush=True)
    differ = sorted({f"{dt} {name}" for dt in ("float32", "bfloat16")
                     for name in runs[0][dt]["digests"]
                     if len({run[dt]["digests"].get(name) for run in runs}) > 1})
    print(f"outputs bit for bit across roots: {not differ}"
          + (f"; differ: {differ}" if differ else ""), flush=True)
    result = {"device": card, "shape": [BATCH, MAX_LEN, D_MODEL, N_HEAD, D_FF, DROPOUT],
              "runs": runs, "outputs_differ": differ}
    out = REPO / "chiprun_out" / "train_attention_timing.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": card, "roots": args.roots}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
