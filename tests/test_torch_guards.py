"""Guards of the PyTorch/CUDA port.

* The port, ``chip_smoke.py`` and the scripts that run on the card
  (``CARD_SCRIPTS``) import no JAX, flax, optax, orbax, YAML,
  omegaconf, pandas or ``fourierdiffusion_tpu`` module: the machine with
  the card has none of them. The one exception is pandas inside
  ``data/preprocessing.py::mimic_preprocess``, which reads MIMIC-III's
  HDF5 file (and needs PyTables besides).
* ``chip_smoke.py`` fails, and prints no result, where CUDA is absent.
* A CPU tensor never reaches a kernel, and the public sampler's and the
  trainer's default device is CUDA, which they do not trade for the CPU.
* The kernel wrappers check the dtype before they look at the device and
  hold no ``try`` that could fall back to the plain version. The
  CUDA-tensor cases are in ``tests/test_torch_cuda.py``.
* ``parallel/distributed.py`` and ``parallel/mesh.py`` hold no ``try``
  either, and a rank asked for CUDA where there is none raises instead of
  joining over gloo or running alone.
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
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder as fe
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.parallel import distributed
from fourierdiffusion_tpu_torch.parallel import mesh as parallel_mesh
from fourierdiffusion_tpu_torch.parallel.launch import free_port
from fourierdiffusion_tpu_torch.sampling import DiffusionSampler
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fourierdiffusion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "omegaconf", "pandas",
             "fourierdiffusion_tpu")
# Scripts of scripts/ that run on the card, beside chip_smoke.py.
CARD_SCRIPTS = ("c2_train_quality.py", "train_attention_timing.py", "attention_bwd_passes.py",
                "attention_fwd_passes.py")
# The one function of the port that may import pandas, inside its body.
PANDAS_EXCEPTION = ("preprocessing.py", "mimic_preprocess")

_BLOCKED_IMPORTS = f"""
import importlib, importlib.util, pkgutil, sys

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
for script in {CARD_SCRIPTS!r}:
    spec = importlib.util.spec_from_file_location(script[:-3], "scripts/" + script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len(names) + 2)
print("modules", " ".join(names))
"""

# Modules the import walk must reach (pkgutil walks only packages with an
# ``__init__.py``): the entry points, the config, checkpoint and logging
# utilities, the dataset readers and the LSTM layer, and the data mesh.
WALKED = ("cli.train", "cli.sample", "utils.yamlio", "utils.config", "utils.instantiate",
          "utils.logging", "utils.profiling", "utils.checkpoint", "training.callbacks",
          "data.csvio", "data.preprocessing", "data.raw_formats", "models.lstm",
          "parallel.distributed", "parallel.mesh", "parallel.launch", "parallel.dryrun")


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
    walked = proc.stdout.split("modules", 1)[1].split()
    missing = [m for m in WALKED if f"fourierdiffusion_tpu_torch.{m}" not in walked]
    assert not missing, f"the import walk missed {missing}"


def _source_files() -> list[Path]:
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + [REPO / "scripts" / s for s in CARD_SCRIPTS])


def _imports(path: Path) -> list[tuple[str, int, str | None]]:
    """Every module ``path`` imports: (name, line, the function whose body
    holds the import, or None at module level)."""
    out = []

    def visit(node: ast.AST, function: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((a.name, child.lineno, function) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append((child.module or "", child.lineno, function))
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else function
            visit(child, inner)

    visit(ast.parse(path.read_text(), filename=str(path)), None)
    return out


@pytest.mark.parametrize("path", _source_files(), ids=lambda p: p.name)
def test_sources_name_no_forbidden_module(path: Path) -> None:
    """Also catches imports inside functions, which an import run misses."""
    for name, line, function in _imports(path):
        root = name.split(".")[0]
        if root == "pandas" and (path.name, function) == PANDAS_EXCEPTION:
            continue
        assert root not in FORBIDDEN, f"{path.name}:{line} imports {name}"


def test_pandas_is_imported_only_by_mimic_preprocess() -> None:
    found = [(p.name, function) for p in _source_files() for name, _, function in _imports(p)
             if name.split(".")[0] == "pandas"]
    assert found == [PANDAS_EXCEPTION]


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


def test_trainer_default_device_raises_without_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    model = ScoreModelConfig(d_model=24, n_head=4, num_layers=1, dim_feedforward=64).build(1, 19)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, VPScheduler())


@pytest.mark.parametrize(
    "module", [fa, fe, fet, distributed, parallel_mesh],
    ids=["flash_attention", "fused_encoder", "fused_encoder_train", "parallel_distributed",
         "parallel_mesh"],
)
def test_kernel_wrappers_hold_no_fallback(module) -> None:
    tree = ast.parse(Path(module.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_rank_asked_for_cuda_without_a_card_raises(monkeypatch, device) -> None:
    """No gloo on the CPU and no one-process run in its place: the rank
    raises before it joins anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("FDIFF_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("FDIFF_NUM_PROCESSES", "2")
    monkeypatch.setenv("FDIFF_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.maybe_initialize_distributed(device=device)
    assert not torch.distributed.is_initialized()
    assert distributed.rank_device() is None and distributed.world_size() == 1


def test_nccl_is_never_asked_to_run_on_the_cpu(monkeypatch) -> None:
    monkeypatch.setenv("FDIFF_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("FDIFF_NUM_PROCESSES", "2")
    monkeypatch.setenv("FDIFF_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="NCCL"):
        distributed.maybe_initialize_distributed(device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def test_wrappers_check_dtype_before_device() -> None:
    layer = TransformerEncoderLayer(24, 4, 64)
    packed = fet.pack_encoder_layer_train(layer, 4)
    x = torch.zeros(2, 19, 24, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fet.fused_encoder_layer_train(x, packed, 1, n_head=4, rate=0.1)
    q = torch.zeros(1, 2, 5, 6, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)


def test_wrappers_run_only_on_cuda_or_cpu() -> None:
    q = torch.zeros(1, 2, 5, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)
    layer = TransformerEncoderLayer(24, 4, 64).to("meta")
    packed = fet.pack_encoder_layer_train(layer, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fet.fused_encoder_layer_train(
            torch.zeros(2, 19, 24, device="meta"), packed, 1, n_head=4, rate=0.1
        )


def test_cpu_attention_gradients_never_launch_a_kernel() -> None:
    q, k, v = (torch.randn(1, 2, 5, 6, requires_grad=True) for _ in range(3))
    counts = ("launches", "bwd_launches", "dropout_fwd_launches", "dropout_bwd_launches")
    before = [getattr(fa, c) for c in counts]
    (fa.flash_attention(q, k, v).sum() + fa.flash_attention_dropout(q, k, v, 3, 0.1).sum()
     ).backward()
    assert [getattr(fa, c) for c in counts] == before
    assert all(t.grad is not None for t in (q, k, v))


def test_cpu_tensors_never_launch_the_training_kernels() -> None:
    layer = TransformerEncoderLayer(24, 4, 64)
    packed = fet.pack_encoder_layer_train(layer, 4)
    before = (fet.fwd_launches, fet.bwd_launches, fa.launches)
    x = torch.randn(2, 19, 24, requires_grad=True)
    fet.fused_encoder_layer_train(x, packed, 3, n_head=4, rate=0.1).sum().backward()
    with torch.no_grad():
        layer.self_attn(x)
    assert (fet.fwd_launches, fet.bwd_launches, fa.launches) == before
