"""The port's config system (``utils/yamlio.py``, ``utils/config.py``) against
PyYAML and the JAX package's ``utils/config.py``, on the CPU.

* The port's YAML reader gives what ``yaml.safe_load`` gives, type for type,
  on every YAML file of the JAX package's config tree and of the port's
  copy, on every committed ``runs/*/train_config.yaml`` and on some
  committed ``results.yaml`` files; an override value is typed as JAX's
  ``parse_override_value`` (``yaml.safe_load``) types it, YAML 1.1's quirks
  included. What the reader does not know raises.
* ``compose`` equals JAX's ``compose`` on every ``score_model`` x
  ``datamodule`` x ``noise_scheduler`` option and on dotted overrides; the
  comparison leaves out only ``device``, which the port's roots add.
* Every ``datamodule`` and ``score_model`` option builds (``utils/instantiate.py``)
  the class the JAX package's builders build, with the same settings.
* The writer's output reads back equal to the value through ``yaml.safe_load``
  and through the port's reader (hypothesis over nested dicts of scalars
  and float lists).

Every comparison is exact: the same types and values (NaN equal to NaN).
"""

from __future__ import annotations

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from fourierdiffusion_tpu.utils import config as jax_config
from fourierdiffusion_tpu.utils import instantiate as jax_instantiate
from fourierdiffusion_tpu_torch.utils import config, instantiate, yamlio

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = REPO / "fourierdiffusion_tpu" / "configs"
PORT_CONFIGS = REPO / "fourierdiffusion_tpu_torch" / "configs"


def same(a, b) -> bool:
    """Equal values of equal types, keys in the same order, NaN == NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def _yaml_files() -> list[Path]:
    files = sorted(JAX_CONFIGS.rglob("*.yaml")) + sorted(PORT_CONFIGS.rglob("*.yaml"))
    files += sorted((REPO / "runs").glob("*/train_config.yaml"))
    files += sorted((REPO / "runs_reference").glob("*/*.yaml"))
    files += sorted((REPO / "runs").glob("*_10k_*/results.yaml"))[:4]
    return files


@pytest.mark.parametrize("path", _yaml_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_reader_equals_safe_load(path: Path) -> None:
    text = path.read_text()
    assert same(yamlio.loads(text), yaml.safe_load(text))


def test_every_config_file_is_covered() -> None:
    """The port's tree is the JAX tree, file for file; only train.yaml and
    sample.yaml differ, by ``device: cuda``."""
    jax_files = sorted(p.relative_to(JAX_CONFIGS) for p in JAX_CONFIGS.rglob("*.yaml"))
    port_files = sorted(p.relative_to(PORT_CONFIGS) for p in PORT_CONFIGS.rglob("*.yaml"))
    assert jax_files == port_files
    for rel in jax_files:
        jax_cfg = yaml.safe_load((JAX_CONFIGS / rel).read_text())
        port_cfg = yaml.safe_load((PORT_CONFIGS / rel).read_text())
        if rel.name in ("train.yaml", "sample.yaml") and rel.parent == Path("."):
            assert port_cfg.pop("device") == "cuda"
        assert same(port_cfg, jax_cfg), rel


# Override strings and YAML 1.1's typing of each (the JAX CLIs type them with
# yaml.safe_load): exponents without a dot are strings, yes/no/on/off are
# booleans, 0x and leading-0 octal are ints, underscores are dropped.
OVERRIDE_VALUES = [
    "1e-3", "1.0e-3", "1.0E+3", "1e3", "0.001", ".5", "-.5", "+1.5", "1.", "1_000",
    "1_000.5", "0x1f", "0X1F", "017", "08", "0o17", "0b101", "-0", "+7", "190:20:30",
    "1:30.5", "yes", "Yes", "YES", "no", "on", "off", "On", "OFF", "y", "n", "true",
    "True", "TRUE", "false", "FALSE", "tRUE", "~", "null", "Null", "NULL", "", ".inf",
    "-.inf", "+.inf", ".Inf", ".NaN", ".nan", "nan", "inf", "${fourier_transform}",
    "${score_model.fourier_noise_scaling}", "???", "runs", "/tmp/a b", "ecg", "a:b",
    "'quoted'", "'it''s'", '"double"', '"tab\\tnew\\nline"', '"\\u00e9"', "'1e-3'",
    "'yes'", "value # comment", "12abc", "1.2.3", "-", "--x", "x y z", "foo:",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_override_value_typed_as_jax(raw: str) -> None:
    try:
        want = jax_config.parse_override_value(raw)
    except yaml.YAMLError:
        with pytest.raises(yamlio.YamlSubsetError):
            config.parse_override_value(raw)
        return
    assert same(config.parse_override_value(raw), want)


# YAML the reader does not know: each raises instead of being guessed at.
UNSUPPORTED = [
    "[1, 2]", "{a: 1}", "a: [1, 2]", "a: {b: 1}", "a: &x 1\nb: *x", "a: !!str 1",
    "a: |\n  text\n", "a: >\n  text\n", "%YAML 1.1\n---\na: 1", "---\na: 1",
    "a: 2001-12-14", "<<: 1", "a: =", "? complex\n: key", "a: b: c",
    "a: plain\n  continued", "a:\n\tb: 1", "a: 'open", "a: 1\n  b: 2",
]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_unsupported_yaml_raises(text: str) -> None:
    with pytest.raises(yamlio.YamlSubsetError):
        yamlio.loads(text)


def _drop_device(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k != "device"}


_SCORE_MODELS = sorted(p.stem for p in (JAX_CONFIGS / "score_model").glob("*.yaml"))
_DATAMODULES = sorted(p.stem for p in (JAX_CONFIGS / "datamodule").glob("*.yaml"))
_SCHEDULERS = sorted(p.stem for p in (JAX_CONFIGS / "score_model" / "noise_scheduler").glob("*.yaml"))


@pytest.mark.parametrize("scheduler", _SCHEDULERS)
@pytest.mark.parametrize("datamodule", _DATAMODULES)
@pytest.mark.parametrize("score_model", _SCORE_MODELS)
def test_compose_equals_jax(score_model: str, datamodule: str, scheduler: str) -> None:
    overrides = [f"score_model={score_model}", f"datamodule={datamodule}",
                 f"score_model/noise_scheduler={scheduler}"]
    port = config.compose("train", overrides)
    assert port["device"] == "cuda"
    assert same(_drop_device(port), jax_config.compose("train", overrides))


@pytest.mark.parametrize("datamodule", _DATAMODULES)
def test_every_datamodule_option_builds_its_jax_twin(datamodule: str, tmp_path: Path) -> None:
    overrides = [f"datamodule={datamodule}", f"datamodule.data_dir={tmp_path}"]
    port = instantiate.build_datamodule(config.compose("train", overrides)["datamodule"])
    ref = jax_instantiate.build_datamodule(jax_config.compose("train", overrides)["datamodule"])
    assert type(port).__name__ == type(ref).__name__
    settings = {k: v for k, v in vars(ref).items() if not k.startswith(("X_", "y_"))}
    assert settings == {k: v for k, v in vars(port).items() if k in settings}
    assert not tmp_path.exists() or not any(tmp_path.iterdir())  # built, nothing read


@pytest.mark.parametrize("score_model", _SCORE_MODELS)
def test_every_score_model_option_builds_its_jax_twin(score_model: str) -> None:
    overrides = [f"score_model={score_model}"]
    port = instantiate.build_model_config(config.compose("train", overrides)["score_model"])
    ref = jax_instantiate.build_model_config(jax_config.compose("train", overrides)["score_model"])
    assert {k: v for k, v in vars(ref).items() if k != "use_pallas"} == vars(port)
    network = port.build(n_channels=2, max_len=12, seed=0)
    assert type(network).__name__ == type(ref.build(n_channels=2, max_len=12)).__name__


DOTTED = [
    ["score_model.lr_max=1e-3"],
    ["fourier_transform=true", "datamodule=synthetic", "trainer.ema_decay=0.999"],
    ["trainer.max_epochs=5", "datamodule.batch_size=16", "trainer.init_seed=3"],
    ["trainer.callbacks.sampling.enabled=off", "random_seed=0x10", "run_dir=/tmp/r"],
    ["standardize=no", "score_model.d_model=16", "trainer.new.key=1_000"],
    ["device=cpu", "fourier_transform=yes", "score_model.fourier_noise_scaling=false"],
]


@pytest.mark.parametrize("overrides", DOTTED, ids=lambda o: " ".join(o))
def test_compose_dotted_overrides_equal_jax(overrides: list[str]) -> None:
    port = config.compose("train", overrides)
    jax_cfg = jax_config.compose("train", overrides)
    if "device=cpu" in overrides:
        assert port["device"] == "cpu"
        jax_cfg.pop("device")
    assert same(_drop_device(port), jax_cfg)


@pytest.mark.parametrize("overrides", [
    ["model_id=4ffeaa7e"],
    ["model_id=abc", "num_samples=64", "sampler.method=pc", "sampler.divergence_threshold=8.0",
     "metrics.include_baselines=false", "checkpoint=last"],
], ids=["model_id", "sampler and metrics"])
def test_compose_sample_equals_jax(overrides: list[str]) -> None:
    assert same(_drop_device(config.compose("sample", overrides)),
                jax_config.compose("sample", overrides))


def test_compose_errors_match_jax() -> None:
    for overrides in (["score_model=missing"], ["nokey"]):
        with pytest.raises(Exception) as port:
            config.compose("train", overrides)
        with pytest.raises(Exception) as jax_err:
            jax_config.compose("train", overrides)
        assert type(port.value) is type(jax_err.value)


def test_saved_config_reads_back(tmp_path: Path) -> None:
    cfg = config.compose("train", ["datamodule=synthetic", "fourier_transform=true"])
    config.save_config(cfg, tmp_path / "train_config.yaml")
    assert same(config.load_config(tmp_path / "train_config.yaml"), cfg)
    assert same(yaml.safe_load((tmp_path / "train_config.yaml").read_text()), cfg)
    assert config.dict_to_str(cfg) == jax_config.dict_to_str(cfg)
    assert config.flatten_config(cfg) == jax_config.flatten_config(cfg)


def test_results_yaml_round_trips() -> None:
    path = REPO / "runs" / "001b4ff5_10k_off" / "results.yaml"
    results = yaml.safe_load(path.read_text())
    text = yamlio.dumps(results)
    assert same(yaml.safe_load(text), results)
    assert same(yamlio.loads(text), results)


_text = st.text(st.characters(min_codepoint=1, max_codepoint=0x2FFF,
                              blacklist_categories=("Cs",)), max_size=12)
_scalars = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
            | st.floats(allow_nan=True, allow_infinity=True) | _text)
_float_lists = st.lists(st.floats(allow_nan=True, allow_infinity=True), max_size=6)
_values = st.recursive(
    _scalars | _float_lists,
    lambda children: st.dictionaries(_text, children, max_size=5),
    max_leaves=25,
)


@settings(max_examples=300, deadline=None, database=None)
@given(st.dictionaries(_text, _values, max_size=6))
def test_writer_round_trips(value: dict) -> None:
    text = yamlio.dumps(value)
    assert same(yaml.safe_load(text), value)
    assert same(yamlio.loads(text), value)
