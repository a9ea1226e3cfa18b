"""Where the attention forward spends its time: B6-fwd (dropout 0.1) and B2
over (B, H, L, dh) heads at the unfused training path's shape (64, 12, 100,
6), at USDroughts' L (8, 12, 365, 6), at (1, 8, 896, 16) and at (1, 8,
2048, 16), in bf16 and fp32, and the
training layer's attention launch in B3 at the flagship's training shape
(B=64, L=100, D=72, H=12, F=2048, dropout 0.1), all on
``attention_fwd_mma_kernel``.

    python3 scripts/attention_fwd_passes.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own, which
imports ``fourierdiffusion_tpu_torch`` and ``chip_smoke`` from that root,
copies the root's ``csrc/`` into a temporary directory once per variant,
edits the copy's ``attention_mma.cuh`` inside ``attention_fwd_mma_kernel``
only, and builds ``flash_attention.cu`` and ``fused_encoder_train_bf16.cu``
from it (``fused_encoder_train.cu`` too for ``full``; the package's nvcc
flags, ``-Xptxas -v`` among them). The variants:

* ``full``: the source as it is;
* ``pass1``: the statistics pass alone (steps = key blocks: the second
  pass's loop runs no step and nothing of V is staged; the row statistics
  are added to the output so that the pass is not dropped);
* ``compute``: both passes, but the ring staged once (its two stages) and
  no barrier or ``cp.async`` wait after: the passes' arithmetic without
  their staging (results wrong, times only).

The cuts edit the two-pass ring form (one ring of two key blocks, a barrier
per step). Where a root's forward has other forms (``AttnFwdPlan`` with
``resident``) they do not apply, and its ``full`` build is timed instead in
each form its plan can take (``ring``: K and V streamed; ``resident``: staged
once, S not kept; and the plan's own, which may keep S), each form's
outputs held bit for bit to the plan's. The outputs of the cut variants are
not checked.

For each variant (or form), dtype, shape and kernel: ``ms`` by CUDA events
around 50 calls after 5 (``chip_smoke.time_ms``), device microseconds per
launch of the forward kernel from ``torch.profiler``
(``chip_smoke.device_us_by_kernel``; B3: its attention launch among its
four) and, for ``full``, a digest of the output, compared across roots
(give ``parent change`` to hold the two bit for bit). Prints the card's
name and power limit; ptxas's registers, shared memory and spills of every
forward instance of each build with the CTAs per SM that its registers
allow at 7 warps (the flagship's tiles); one line per reading; and one
JSON object, also written to ``chiprun_out/attention_fwd_passes.json``.
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
SHAPES = ((64, 12, 100, 6), (8, 12, 365, 6), (1, 8, 896, 16), (1, 8, 2048, 16))
TRAIN = (64, 100, 72, 12, 2048)  # B, L, D, H, F of B3
DROPOUT, SEED = 0.1, 123456789
FWD_START, FWD_END = "attention_fwd_mma_kernel(", "// Checks the plan against the shape"
STEPS = "steps = 2 * nb;"
RING_STEP = "ring_begin(ring, p.stage, s, steps, load)"
FIRST_LOAD = "load(0);\n  tc::cp_async_commit();"
# Each cut: (old, new, count) edits of the forward's body, every one required.
STORE = "  if (!live) return;\n  store_rows(o + at.o"
CUTS = {
    # The row statistics go into the output, or the compiler drops pass 1.
    "pass1": [(STEPS, "steps = nb;", 1),
              (STORE, "  if (!live) return;\n  acc[0][0] += m[0] + l[0] + m[1] + l[1];\n"
               "  store_rows(o + at.o", 1)],
    "compute": [("__syncthreads();\n", ";\n", None),
                (RING_STEP, "(ring + (s % kRingStages) * p.stage)", 2),
                (FIRST_LOAD, FIRST_LOAD + "\n  load(1);\n  tc::cp_async_commit();\n"
                 "  tc::cp_async_wait<0>();\n  __syncthreads();", 1)],
}
# The registers a warp is given come in units of 256; an SM has 65,536.
WARPS, REG_UNIT, SM_REGS = 7, 256, 65536


def ctas_by_registers(regs: int, warps: int = WARPS) -> int:
    """CTAs of ``warps`` warps that ``regs`` registers a thread let share an SM."""
    return SM_REGS // (-(-regs * 32 // REG_UNIT) * REG_UNIT * warps)


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cut_source(text: str, edits: list) -> str | None:
    """``text`` with ``edits`` made inside the forward's body, or None where
    one does not match as often as it should."""
    start = text.find(FWD_START)
    end = text.find(FWD_END, start)
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
    from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
    from fourierdiffusion_tpu_torch.ops import _build
    from fourierdiffusion_tpu_torch.ops import flash_attention as fa
    from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet

    for module in (cs, fa, fet):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise RuntimeError(f"imported {module.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    header = (_build.CSRC_DIR / "attention_mma.cuh").read_text()
    variants = {"full": header}
    has_forms = "resident" in dict(fa.AttnFwdPlan._fields_)
    for name, edits in CUTS.items():
        cut = None if has_forms else cut_source(header, edits)
        if cut is not None:
            variants[name] = cut
    tmp = Path(tempfile.mkdtemp(prefix="attention_fwd_passes-"))
    jobs = [(name, lib) for name in variants
            for lib in ("flash_attention", "fused_encoder_train_bf16",
                        *(("fused_encoder_train",) if name == "full" else ()))]

    def build(job: tuple[str, str]) -> tuple[str, str, Path, str]:
        name, lib = job
        csrc = tmp / name / "csrc"
        out = tmp / name / f"lib{lib}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                               str(csrc / f"{lib}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{proc.stdout}{proc.stderr}")
        return name, lib, out, proc.stdout + proc.stderr

    for name in variants:  # one copy per variant before the builds start
        csrc = tmp / name / "csrc"
        shutil.copytree(_build.CSRC_DIR, csrc)
        (csrc / "attention_mma.cuh").write_text(variants[name])
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(build, jobs))
        out = {"root": str(root), "variants": list(variants), "ptxas": {}, "readings": []}
        libs: dict[str, dict[str, Path]] = {}
        for name, lib, path, log in built:
            libs.setdefault(name, {})[lib] = path
            for kernel, usage in cs.ptxas_usage(log):
                if "attention_fwd" in kernel:
                    regs = int(re.search(r"(\d+) registers", usage).group(1))
                    out["ptxas"].setdefault(name, []).append(
                        f"{lib}: {kernel}: {usage}; {ctas_by_registers(regs)} CTAs of {WARPS} "
                        f"warps per SM by registers")
        real_load, chosen_fwd = _build.load_library, fa.attention_fwd_plan
        torch.manual_seed(0)
        layer = TransformerEncoderLayer(TRAIN[2], TRAIN[3], TRAIN[4], DROPOUT).to("cuda")
        gx = torch.Generator(device="cuda").manual_seed(2)
        x32 = torch.randn(TRAIN[:3], generator=gx, device="cuda")
        seed = torch.tensor([2**31 - 3], dtype=torch.int64, device="cuda")

        def reading(variant, dtype, shape, kernel, call, form, first):
            got = call()
            prof = cs.device_us_by_kernel(call)
            us = {k: t for k, t in prof.us_per_launch.items() if "attention_fwd" in k}
            d = digest([got])
            out["readings"].append({
                "variant": variant if form == "plan" else f"{variant}:{form}",
                "dtype": str(dtype).removeprefix("torch."), "shape": list(shape),
                "kernel": kernel, "ms": cs.time_ms(call), "device_us_per_launch": us,
                "launches_per_call": prof.launches, "digest": d,
                "as_plan": first is None or d == first})
            return d

        def given(plan):  # a root without forms takes no plan
            return {} if plan is None else {"plan": plan}

        def b3_call(x, lay, plan):
            """B3 with its attention launch on ``plan`` (None: its own)."""
            if plan is not None:
                fa.attention_fwd_plan = lambda *_a, **_k: plan
                fet.train_fwd_plan.cache_clear()
            try:
                return fet._launch_fwd(x, lay, SEED, TRAIN[3], DROPOUT)
            finally:
                fa.attention_fwd_plan = chosen_fwd
                fet.train_fwd_plan.cache_clear()

        for name in variants:
            _build.load_library = lambda lib, _libs=libs[name]: ctypes.CDLL(str(_libs[lib]))
            fa._library.cache_clear()
            fet._library.cache_clear()
            forms = ("plan", "ring", "resident") if name == "full" and has_forms else ("plan",)
            for dtype in (torch.bfloat16, torch.float32):
                calls = []  # (shape, kernel, L, dh, fast, fn(plan))
                for b, h, l, dh in SHAPES:
                    g = torch.Generator(device="cuda").manual_seed(5)
                    q, k, v = (torch.randn((b, h, l, dh), generator=g, device="cuda").to(dtype)
                               for _ in range(3))
                    calls.append(((b, h, l, dh), "B6-fwd", l, dh, False,
                                  lambda plan, _q=q, _k=k, _v=v: fa._launch_fwd(
                                      _q, _k, _v, seed, DROPOUT, **given(plan))))
                    calls.append(((b, h, l, dh), "B2", l, dh,
                                  dtype == torch.bfloat16 and dh < fa.DH_PAD,
                                  lambda plan, _q=q, _k=k, _v=v: fa._launch_fwd(
                                      _q, _k, _v, **given(plan))))
                if dtype == torch.bfloat16 or name == "full":
                    lay = {kk: t.detach() for kk, t in fet.pack_encoder_layer_train(
                        layer, TRAIN[3], dtype).items()}
                    calls.append((TRAIN[:4], "B3", TRAIN[1], TRAIN[2] // TRAIN[3], False,
                                  lambda plan, _x=x32.to(dtype), _lay=lay: b3_call(
                                      _x, _lay, plan)))
                for shape, kernel, l, dh, fast, fn in calls:
                    first = None
                    for form in forms:
                        plan = None
                        if form != "plan":
                            plan = fa.attention_fwd_form(l, dh, dtype, form, fast)
                            own = chosen_fwd(l, dh, dtype, fast)
                            if plan is None or all(plan[k] == own[k]
                                                   for k, _ in fa.AttnFwdPlan._fields_):
                                continue
                        try:
                            d = reading(name, dtype, shape, kernel, lambda _p=plan: fn(_p),
                                        form, first)
                        except RuntimeError as e:  # a form this root's kernels refuse
                            if form == "plan":
                                raise
                            print(f"{form} {dtype} {shape} {kernel}: {e}", file=sys.stderr)
                            continue
                        first = first or d
        _build.load_library = real_load
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
            us = {re.sub(r"^fdiff::attn::", "", k): round(t, 2)
                  for k, t in r["device_us_per_launch"].items()}
            same = "" if not r["variant"].startswith("full") else (
                f"; output {r['digest']}" + ("" if r["as_plan"] else " (NOT as the plan's)"))
            print(f"  {r['variant']:13s} {r['dtype']:8s} {r['shape']} {r['kernel']:6s} "
                  f"{r['ms']:.4f} ms; device us per launch {json.dumps(us)}; "
                  f"{r['launches_per_call']} launches per call{same}", flush=True)
    digests: dict = {}
    for run in runs:
        for r in run["readings"]:
            if r["variant"] == "full":
                digests.setdefault(f"{r['dtype']} {r['shape']} {r['kernel']}", []).append(
                    r["digest"])
    for key, ds in digests.items():
        print(f"outputs of {key} across roots: {ds} "
              f"{'bit for bit' if len(set(ds)) == 1 else 'DIFFER'}", flush=True)
    result = {"device": card, "shapes": SHAPES, "train": TRAIN, "runs": runs,
              "digests": digests}
    out = REPO / "chiprun_out" / "attention_fwd_passes.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": card, "roots": args.roots}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
