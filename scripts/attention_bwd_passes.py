"""Where launch 1 of the attention backward (B5, B6-bwd) spends its time:
times it whole and cut down pass by pass, in bf16 and fp32, at the unfused
training path's shape (B=64, H=12, L=100, dh=6), at (1, 8, 896, 16) and at
(1, 2, 438, 64).

    python3 scripts/attention_bwd_passes.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own, which
imports ``fourierdiffusion_tpu_torch`` from that root, copies the root's
``csrc/`` into a temporary directory once per variant, edits the copy's
``attention_mma.cuh`` inside ``attention_bwd_dq_mma_kernel`` only, and
builds ``flash_attention.cu`` from it (the package's nvcc flags, ``-Xptxas
-v`` among them). The variants:

* ``full``: the source as it is;
* ``pass1``: the statistics pass alone (steps = blocks; the later passes'
  loops run no step);
* ``pass12``: the statistics and, in bf16, O = P_used V for D (fp32 has no
  such pass: there it equals ``pass1``);
* ``compute``: every pass, but the ring staged once (its two stages) and
  no barrier or ``cp.async`` wait after: the passes' arithmetic without
  their staging (results wrong, times only).

The cuts edit the three-pass ring form of launch 1 (one ring of two key
blocks, a barrier per step); where a root's launch 1 has another form they
do not apply, and its ``full`` build is timed instead in each form its plan
can take (``FORMS``: the plan as chosen, ``ring`` with the head streamed,
``resident`` without S kept), each form's outputs held bit for bit to the
plan's. The outputs of the cut variants are not checked.

For each variant (or form), dtype, shape and kernel (B5 at dropout 0,
B6-bwd at 0.1): ``ms`` by CUDA events around 50 calls after 5, device
microseconds per launch from ``torch.profiler``
(``chip_smoke.device_us_by_kernel``) and, for ``full``, a digest of dq,
dk, dv and the statistics, compared across roots (give ``parent change``
to hold the two bit for bit). Prints the card's name and power limit,
ptxas's registers, shared memory and spills of every backward instance of
each build, one line per reading and one JSON object, also written to
``chiprun_out/attention_bwd_passes.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((64, 12, 100, 6), (1, 8, 896, 16), (1, 2, 438, 64))
DROPOUT = 0.1
DQ_START, DQ_END = "attention_bwd_dq_mma_kernel(", "// Launch 2 over the same heads"
STEPS = "steps = (kF32 ? 2 : 3) * nb;"
PASS_O_LOOP = "for (int s = nb; s < 2 * nb; ++s) {"
DQ_LOOP = "for (int s = steps - nb; s < steps; ++s) {"
RING_STEP = "ring_begin(ring, p.stage, s, steps, load)"
FIRST_LOAD = "load(0);\n  tc::cp_async_commit();"
# Each cut: (old, new, count) edits of launch 1's body, every one required.
CUTS = {
    "pass1": [(STEPS, "steps = nb;", 1), (PASS_O_LOOP, "for (int s = nb; s < nb; ++s) {", 1),
              (DQ_LOOP, "for (int s = steps; s < steps; ++s) {", 1)],
    "pass12": [(STEPS, "steps = (kF32 ? 1 : 2) * nb;", 1),
               (DQ_LOOP, "for (int s = steps; s < steps; ++s) {", 1)],
    "compute": [("__syncthreads();\n", ";\n", None),
                (RING_STEP, "(ring + (s % kRingStages) * p.stage)", 3),
                (FIRST_LOAD, FIRST_LOAD + "\n  load(1);\n  tc::cp_async_commit();\n"
                 "  tc::cp_async_wait<0>();\n  __syncthreads();", 1)],
}


# Other forms launch 1 can take, as changes to the plan's fields: streamed
# through the ring, and resident without S kept.
FORMS = {
    "ring": lambda p: {"resident": 0, "kept": 0, "dq_bytes": p["bytes"]},
    "resident": lambda p: {"kept": 0},
}


def form_plan(struct, plan: dict, form: str) -> dict | None:
    """``plan`` in ``form``, or None where that is the plan itself."""
    p = {k: v for k, v in plan.items() if k != "struct"}
    new = {**p, **FORMS[form](p)}
    return None if new == p else {**new, "struct": struct(**new)}


def output_digest(outputs) -> str:
    """sha256 of the bytes of dq, dk, dv and the statistics."""
    import torch

    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cut_source(text: str, edits: list) -> str | None:
    """``text`` with ``edits`` made inside launch 1's body, or None where one
    does not match as often as it should."""
    start = text.find(DQ_START)
    end = text.find(DQ_END, start)
    if start < 0 or end < 0:
        return None
    body = text[start:end]
    for old, new, count in edits:
        found = body.count(old)
        if found == 0 or (count is not None and found != count):
            return None
        body = body.replace(old, new)
    return text[:start] + body + text[end:]


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import ctypes

    import torch

    import chip_smoke as cs
    from fourierdiffusion_tpu_torch.ops import _build
    from fourierdiffusion_tpu_torch.ops import flash_attention as fa

    for module in (cs, fa):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise RuntimeError(f"imported {module.__file__}, not from {root}")
    header = (_build.CSRC_DIR / "attention_mma.cuh").read_text()
    variants = {"full": header}
    for name, edits in CUTS.items():
        cut = cut_source(header, edits)
        if cut is not None:
            variants[name] = cut
    tmp = Path(tempfile.mkdtemp(prefix="attention_bwd_passes-"))

    def build(item: tuple[str, str]) -> tuple[str, Path, str]:
        name, text = item
        csrc = tmp / name / "csrc"
        shutil.copytree(_build.CSRC_DIR, csrc)
        (csrc / "attention_mma.cuh").write_text(text)
        lib = tmp / name / "libflash_attention.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                               str(csrc / "flash_attention.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        return name, lib, proc.stdout + proc.stderr

    try:
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(build, variants.items()))
        out = {"root": str(root), "variants": list(variants), "ptxas": {}, "readings": []}
        real_load, bind, chosen = (_build.load_library, fa._library.__wrapped__,
                                   fa.attention_bwd_plan)
        for name, lib, log in built:
            out["ptxas"][name] = [f"{k}: {u}" for k, u in cs.ptxas_usage(log)
                                  if "attention_bwd" in k]
            _build.load_library = lambda _name, _lib=lib: ctypes.CDLL(str(_lib))
            bound = bind()
            _build.load_library = real_load
            fa._library = lambda _bound=bound: _bound
            forms = ("plan", *FORMS) if name == "full" and "resident" in dict(
                fa.AttnBwdPlan._fields_) else ("plan",)
            for b, h, l, dh in SHAPES:
                g = torch.Generator(device="cuda").manual_seed(5)
                heads = [torch.randn((b, h, l, dh), generator=g, device="cuda")
                         for _ in range(4)]
                seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")
                for dtype in (torch.bfloat16, torch.float32):
                    q, k, v, do = (t.to(dtype) for t in heads)
                    for kernel, sd, rate in (("B5", None, 0.0), ("B6-bwd", seed, DROPOUT)):
                        o = (fa.flash_attention_reference(q, k, v) if sd is None else
                             fa.flash_attention_dropout_reference(q, k, v, seed, rate))
                        call = (lambda _o=o, _sd=sd, _r=rate, _q=q, _k=k, _v=v, _do=do:
                                fa._launch_bwd(_q, _k, _v, _o, _do, _sd, _r))
                        first = None
                        for form in forms:
                            plan = None if form == "plan" else form_plan(
                                fa.AttnBwdPlan, chosen(l, dh, dtype), form)
                            if form != "plan" and plan is None:
                                continue
                            fa.attention_bwd_plan = (lambda *_a, _p=plan: _p) if plan else chosen
                            digest = output_digest(call())
                            first = first or digest
                            prof = cs.device_us_by_kernel(call, launches=2)
                            out["readings"].append({
                                "variant": name if form == "plan" else f"{name}:{form}",
                                "dtype": str(dtype).removeprefix("torch."),
                                "shape": [b, h, l, dh], "kernel": kernel,
                                "ms": cs.time_ms(call),
                                "device_us_per_launch": prof.us_per_launch,
                                "launches_per_call": prof.launches, "digest": digest,
                                "as_plan": digest == first})
                            fa.attention_bwd_plan = chosen
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
        proc = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"{root}: variants {run['variants']}", flush=True)
        for name, lines in run["ptxas"].items():
            for line in lines:
                print(f"  ptxas {name}: {line}", flush=True)
        for r in run["readings"]:
            us = {re.sub(r"<.*", "", k): round(t, 1) for k, t in
                  r["device_us_per_launch"].items()}
            same = "" if not r["variant"].startswith("full") else (
                f"; outputs {r['digest']}" + ("" if r["as_plan"] else " (NOT as the plan's)"))
            print(f"  {r['variant']:13s} {r['dtype']:8s} {r['shape']} {r['kernel']:6s} "
                  f"{r['ms']:.4f} ms; device us per launch {json.dumps(us)}; "
                  f"{r['launches_per_call']} launches per call{same}", flush=True)
    digests: dict = {}
    for run in runs:
        for r in run["readings"]:
            if r["variant"] == "full":
                key = f"{r['dtype']} {r['shape']} {r['kernel']}"
                digests.setdefault(key, []).append(r["digest"])
    for key, ds in digests.items():
        print(f"outputs of {key} across roots: {ds} "
              f"{'bit for bit' if len(set(ds)) == 1 else 'DIFFER'}", flush=True)
    result = {"device": card, "shapes": SHAPES, "runs": runs, "digests": digests}
    out = REPO / "chiprun_out" / "attention_bwd_passes.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": card, "roots": args.roots}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
