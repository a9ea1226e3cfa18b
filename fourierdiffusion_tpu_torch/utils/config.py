"""YAML config composition with groups and CLI overrides (port of
``fourierdiffusion_tpu/utils/config.py``, with the same semantics):

* composition roots (``train.yaml``, ``sample.yaml``) declare a
  ``defaults`` mapping of group -> option (e.g. ``score_model: default``);
* ``group=option`` overrides swap the whole group file
  (``score_model=lstm``, ``datamodule=nasa``);
* dotted ``a.b.c=value`` overrides set individual leaves
  (``datamodule.batch_size=16``) with YAML-parsed values;
* ``${path.to.key}`` interpolations resolve against the composed root —
  the reference's ``${fourier_transform}`` switch threads identically;
* the resolved config is saved per run and reloaded by the sampling CLI
  as the source of truth.

Files and override values go through ``utils/yamlio.py``, which resolves
scalars as ``yaml.safe_load`` does (so ``score_model.lr_max=1e-3`` is the
string ``"1e-3"`` here too, as it is in the JAX package); the port needs no
YAML library.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from fourierdiffusion_tpu_torch.utils import yamlio

_INTERP = re.compile(r"^\$\{([^}]+)\}$")

DEFAULT_CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def _load_yaml(path: Path) -> dict:
    data = yamlio.load(path)
    return data if data is not None else {}


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _compose_group(config_dir: Path, group: str, option: str) -> dict:
    """Load a group option file, recursing into its own ``defaults``."""
    path = config_dir / group / f"{option}.yaml"
    if not path.exists():
        available = sorted(p.stem for p in (config_dir / group).glob("*.yaml"))
        raise FileNotFoundError(
            f"No option {option!r} in group {group!r}; available: {available}"
        )
    data = _load_yaml(path)
    defaults = data.pop("defaults", {})
    for sub_group, sub_option in defaults.items():
        data[sub_group] = _compose_group(
            config_dir, f"{group}/{sub_group}", sub_option
        )
    return data


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_dotted(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def _resolve_interpolations(cfg: dict) -> dict:
    """Fixpoint resolution of ``${...}`` string leaves against the root."""

    def resolve_node(node: Any) -> tuple[Any, bool]:
        if isinstance(node, dict):
            changed = False
            out = {}
            for k, v in node.items():
                out[k], c = resolve_node(v)
                changed |= c
            return out, changed
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                try:
                    target = _get_dotted(cfg, m.group(1))
                except (KeyError, TypeError):
                    raise KeyError(
                        f"Cannot resolve interpolation ${{{m.group(1)}}}"
                    ) from None
                return target, True
        return node, False

    for _ in range(10):
        cfg, changed = resolve_node(cfg)
        if not changed:
            return cfg
    raise RuntimeError("Interpolation did not converge (cycle?)")


def parse_override_value(raw: str) -> Any:
    """An override's value, typed as ``yaml.safe_load`` types it."""
    return yamlio.loads(raw)


def compose(
    config_name: str,
    overrides: list[str] | None = None,
    config_dir: Path | str = DEFAULT_CONFIG_DIR,
) -> dict:
    """Compose ``<config_dir>/<config_name>.yaml`` with overrides applied."""
    config_dir = Path(config_dir)
    cfg = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults: dict[str, str] = cfg.pop("defaults", {})

    overrides = list(overrides or [])
    group_overrides: dict[str, str] = {}
    nested_group_overrides: list[tuple[str, str]] = []
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must have the form key=value")
        key, raw = ov.split("=", 1)
        if key in defaults and "." not in key:
            group_overrides[key] = raw
        elif "/" in key and "." not in key:
            # Nested group override, e.g. score_model/noise_scheduler=vesde.
            nested_group_overrides.append((key, raw))
        else:
            value_overrides.append((key, parse_override_value(raw)))

    for group, option in {**defaults, **group_overrides}.items():
        cfg[group] = _merge(cfg.get(group, {}), _compose_group(config_dir, group, option))

    for group_path, option in nested_group_overrides:
        sub_cfg = _compose_group(config_dir, group_path, option)
        _set_dotted(cfg, group_path.replace("/", "."), sub_cfg)

    for key, value in value_overrides:
        _set_dotted(cfg, key, value)

    return _resolve_interpolations(cfg)


def save_config(cfg: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    yamlio.dump(cfg, path)


def load_config(path: Path) -> dict:
    return _load_yaml(Path(path))


def flatten_config(cfg: dict) -> dict[str, Any]:
    """Flatten for logging, keeping leaf names only (reference
    ``extraction.py:20-55`` drops the group prefixes)."""
    out: dict[str, Any] = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(flatten_config(v))
        else:
            out[k] = v
    return out


def dict_to_str(d: dict[str, Any]) -> str:
    """Pretty one-per-line printer (reference ``extraction.py:101-121``)."""
    flat = flatten_config(d) if any(isinstance(v, dict) for v in d.values()) else d
    if not flat:
        return ""
    width = max(len(k) for k in flat)
    lines = []
    for k, v in flat.items():
        if isinstance(v, list) and len(v) > 3:
            v = v[:3] + ["..."]
        lines.append(f"\t {k: <{width + 5}} : \t  {v}")
    return "\n".join(lines)
