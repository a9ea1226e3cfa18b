"""Guards of the PyTorch/CUDA port.

* The port and ``chip_smoke.py`` import no JAX, flax, optax, orbax, YAML,
  omegaconf or ``fourierdiffusion_tpu`` module: the machine with the card
  has none of them.
* ``chip_smoke.py`` fails, and prints no result, where CUDA is absent.
* A CPU tensor never reaches the kernel, and the public sampler's default
  device is CUDA, which it does not trade for the CPU.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler
from fourierdiffusion_tpu_torch.schedulers import VPScheduler

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fourierdiffusion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "omegaconf",
             "fourierdiffusion_tpu")

_BLOCKED_IMPORTS = f"""
import importlib, pkgutil, sys

FORBIDDEN = {FORBIDDEN!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError(f"forbidden import: {{name}}")
        return None

sys.meta_path.insert(0, Blocker())
import fourierdiffusion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print("imported", len(names) + 2)
"""


def _env() -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_nothing_of_jax() -> None:
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _source_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _source_files(), ids=lambda p: p.name)
def test_sources_name_no_forbidden_module(path: Path) -> None:
    """Also catches imports inside functions, which an import run misses."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_chip_smoke_fails_without_cuda() -> None:
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cpu_tensor_never_launches_the_kernel() -> None:
    layer = TransformerEncoderLayer(24, 4, 64)
    packed = fe.pack_encoder_layer(layer, 4, torch.float32)
    before = fe.launches
    out = fe.fused_encoder_layer(torch.randn(2, 19, 24), packed, n_head=4)
    assert out.shape == (2, 19, 24)
    assert fe.launches == before


def test_sampler_default_device_raises_without_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    model = ScoreModelConfig(d_model=24, n_head=4, num_layers=1, dim_feedforward=64).build(1, 19)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionSampler(model, VPScheduler(), max_len=19, n_channels=1)
