"""confy-style layered TOML config (the port's copy of the JAX package's
``utils.config``; the same directory, so a config serves either package).

Parity: reference src/args.rs:6-47 (``ConfigArgs``): each tool loads/saves a
per-subcommand TOML file under ``~/.config/audio-matcher/{name}.toml`` unless
``--config FILE`` overrides the path. Values are plain scalars/tables.

Reading uses stdlib ``tomllib``; writing uses a minimal serializer adequate
for the flat configs this framework persists.
"""

from __future__ import annotations

import os
import tomllib
from pathlib import Path
from typing import Any

from .. import APP_NAME


def config_dir() -> Path:
    xdg = os.environ.get("XDG_CONFIG_HOME")
    base = Path(xdg) if xdg else Path.home() / ".config"
    return base / APP_NAME


def default_config_path(sub_config: str) -> Path:
    return config_dir() / f"{sub_config}.toml"


def _toml_escape(s: str) -> str:
    s = (
        s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\t", "\\t")
        .replace("\r", "\\r")
    )
    # any remaining control char is invalid inside a TOML basic string —
    # an unescaped one would make every later load_config raise
    return "".join(
        c if ord(c) >= 0x20 or c in "\\" else f"\\u{ord(c):04X}"
        for c in s
    )


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (str, Path)):
        return f'"{_toml_escape(str(v))}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"can't serialize {type(v)} to TOML")


def dumps_toml(data: dict[str, Any]) -> str:
    lines: list[str] = []
    tables: list[tuple[str, dict]] = []
    for k, v in data.items():
        if v is None:
            continue
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {_toml_value(v)}")
    for name, tbl in tables:
        lines.append(f"\n[{name}]")
        for k, v in tbl.items():
            if v is None:
                continue
            lines.append(f"{k} = {_toml_value(v)}")
    return "\n".join(lines) + "\n"


def load_config(sub_config: str, config_path: str | Path | None = None) -> dict:
    """Load the TOML config; missing files yield an empty dict (confy default)."""
    path = Path(config_path) if config_path else default_config_path(sub_config)
    try:
        with open(path, "rb") as f:
            return tomllib.load(f)
    except FileNotFoundError:
        return {}


def save_config(
    sub_config: str, data: dict, config_path: str | Path | None = None
) -> Path:
    path = Path(config_path) if config_path else default_config_path(sub_config)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dumps_toml(data))
    return path
