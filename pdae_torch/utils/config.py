"""Config loading with the reference's overlay semantics: the port's copy of
``pdae_tpu/utils/config.py``.

Configs are dicts; ``load_yaml`` reads a file. ``yaml`` (PyYAML) is imported
only when a file is not JSON: the port writes its config snapshots as JSON
text (``save_yaml``), which every YAML loader reads too, so a run on a machine
without PyYAML reads its own snapshots.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any


def apply_overrides(config: dict, overrides, dotted: bool = True) -> dict:
    """Apply CLI ``key=value`` overrides to a config dict in place.

    Keys may be dotted paths into nested mappings when ``dotted``; values
    parse as Python literals when possible (numbers, lists, bools), else raw
    strings. An empty YAML section header parses to None and is treated as an
    empty mapping."""
    for kv in overrides:
        if "=" not in kv:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        key, val = kv.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        parts = key.split(".") if dotted else [key]
        node = config
        for part in parts[:-1]:
            child = node.get(part)
            if child is None:
                child = node[part] = {}
            if not isinstance(child, dict):
                raise SystemExit(f"--set path {key!r}: {part!r} is not a "
                                 f"mapping in the config")
            node = child
        node[parts[-1]] = val
    return config


def load_yaml(path: str) -> dict:
    """A config file: JSON text as it is, anything else through PyYAML."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml
        return yaml.safe_load(text)


def save_yaml(obj: Any, path: str) -> None:
    """Write ``obj`` as JSON text (a YAML document too), keys in order."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
        f.write("\n")


def overlay_eval_dataset_config(config: dict) -> dict:
    """eval_dataset_config = train_dataset_config updated by the eval keys."""
    merged = dict(config["train_dataset_config"])
    merged.update(config.get("eval_dataset_config") or {})
    return merged


def parse_adam_betas(value) -> tuple:
    """'(0.9, 0.999)' -> (0.9, 0.999); already-parsed sequences pass through."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    b1, b2 = value
    return (float(b1), float(b2))
