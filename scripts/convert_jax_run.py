#!/usr/bin/env python3
"""Convert a JAX package run directory into the PyTorch port's layout.

    python scripts/convert_jax_run.py runs/<run_id> --out <dir>

reads ``runs/<run_id>/checkpoints/epoch=*`` (orbax: ``params`` and
``constants``) and ``checkpoints/last`` (orbax: the full training state),
and writes ``<dir>/<run_id>/`` as ``fourierdiffusion_tpu_torch`` writes a
run (``fourierdiffusion_tpu_torch/utils/checkpoint.py``):

* ``checkpoints/epoch=*/model.pt``: the weights as the port's state dict
  (``utils/weights.state_dict_from_jax``: a transformer, MLP or LSTM run),
  and ``metadata.json`` copied;
* ``checkpoints/last/train_state.pt``: ``params``, ``constants``,
  ``ema_params``, the AdamW ``mu``/``nu``/``count`` (and, for a run with
  gradient accumulation, ``optax.MultiSteps``' accumulator and counters)
  and ``step``, each tree mapped onto the port's parameter names;
* ``train_config.yaml`` and ``metrics.jsonl`` copied.

The port's ``fdiff-torch-sample model_id=<run_id> model_path=<dir>`` then
samples the converted run, and ``fdiff-torch-train resume=<run_id>
run_dir=<dir>`` continues it (where ``train_config.yaml``'s ``run_dir``
names ``<dir>``). This script imports JAX and orbax and runs on the CPU;
the port never imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path
from typing import Any

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fourierdiffusion_tpu_torch.utils.weights import (  # noqa: E402
    num_layers_of,
    state_dict_from_jax,
)


def restore_on_cpu(path: Path) -> dict:
    """An orbax checkpoint restored onto the CPU, whatever devices wrote it
    (the tree's own metadata is the restore target)."""
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    path = Path(path).resolve()
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.metadata(path).item_metadata.tree
        target = jax.tree_util.tree_map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu), tree
        )
        restored = ckptr.restore(path, target)
    return jax.tree_util.tree_map(np.asarray, restored)


def named(tree: dict, layers: int) -> dict[str, torch.Tensor]:
    """A params-shaped tree (weights, moments or gradients) on the port's
    parameter names."""
    return state_dict_from_jax({"params": tree}, layers)


def _find(tree: Any, keys: set[str]) -> dict | None:
    """The first dict of ``tree`` (depth first) that holds all ``keys``."""
    if isinstance(tree, dict):
        if keys <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def convert_opt_state(opt_state: Any, layers: int) -> dict:
    """optax ``chain(clip_by_global_norm, adamw)`` state, optionally inside
    ``MultiSteps``, in the port's layout (``utils/checkpoint.py``)."""
    multi = _find(opt_state, {"mini_step", "gradient_step", "acc_grads"})
    adam = _find(multi["inner_opt_state"] if multi else opt_state, {"count", "mu", "nu"})
    if adam is None:
        raise ValueError("no AdamW state (count, mu, nu) in the optimiser state")
    out = {"count": int(adam["count"]), "mu": named(adam["mu"], layers),
           "nu": named(adam["nu"], layers)}
    if multi is None:
        return out
    return {"mini_step": int(multi["mini_step"]), "gradient_step": int(multi["gradient_step"]),
            "acc": named(multi["acc_grads"], layers), "inner": out}


def convert_run(run_dir: Path, out_root: Path) -> Path:
    run_dir = Path(run_dir)
    out = Path(out_root) / run_dir.name
    (out / "checkpoints").mkdir(parents=True, exist_ok=True)
    for name in ("train_config.yaml", "metrics.jsonl"):
        if (run_dir / name).exists():
            shutil.copy2(run_dir / name, out / name)
    for ckpt in sorted((run_dir / "checkpoints").glob("epoch=*")):
        variables = restore_on_cpu(ckpt)
        dst = out / "checkpoints" / ckpt.name
        dst.mkdir(exist_ok=True)
        torch.save(state_dict_from_jax(variables, num_layers_of(variables["params"])),
                   dst / "model.pt")
        shutil.copy2(ckpt / "metadata.json", dst / "metadata.json")
        print(f"converted {ckpt.name}", flush=True)
    last = run_dir / "checkpoints" / "last"
    if last.exists():
        state = restore_on_cpu(last)
        layers = num_layers_of(state["params"])
        ema = state.get("ema_params")
        train_state = {
            "params": named(state["params"], layers),
            "constants": {"time_encoder.W": torch.from_numpy(
                np.array(state["constants"]["time_encoder"]["W"]))},
            "ema_params": named(ema, layers) if ema else {},
            "opt_state": convert_opt_state(state["opt_state"], layers),
            "step": int(state["step"]),
        }
        dst = out / "checkpoints" / "last"
        dst.mkdir(exist_ok=True)
        torch.save(train_state, dst / "train_state.pt")
        shutil.copy2(last / "metadata.json", dst / "metadata.json")
        print(f"converted last (epoch {json.loads((last / 'metadata.json').read_text())['epoch']})",
              flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run_dir", type=Path, help="a JAX run directory, runs/<run_id>")
    parser.add_argument("--out", type=Path, required=True,
                        help="where <run_id>/ is written in the port's layout")
    args = parser.parse_args(argv)
    print(convert_run(args.run_dir, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
