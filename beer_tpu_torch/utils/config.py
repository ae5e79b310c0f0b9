"""YAML configuration loading (the recipes' ``conf/*.yml``).

Counterpart of ``beer_tpu/utils/config.py``: PyYAML when it is
installed, else a minimal parser of flat ``key: value`` files, which is
all the recipes' configurations use.
"""

from __future__ import annotations

from pathlib import Path


def _coerce(value: str):
    value = value.strip()
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value.strip("'\"")


def load_yaml(path) -> dict:
    try:
        import yaml

        with open(path) as fh:
            return yaml.safe_load(fh) or {}
    except ImportError:
        out = {}
        for line in Path(path).read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                key, _, value = line.partition(":")
                if value.strip():
                    out[key.strip()] = _coerce(value)
        return out
