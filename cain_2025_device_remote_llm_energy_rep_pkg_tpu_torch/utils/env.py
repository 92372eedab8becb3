"""Minimal ``.env`` loader.

The reference reads the remote server address from a ``.env`` via
python-dotenv (experiment/RunnerConfig.py:125-126; README.md:25-28). Here the
equivalent knobs (e.g. ``SERVER_IP``, the remote generation server) load
through this dependency-free parser: KEY=VALUE lines, ``#`` comments,
optional ``export`` prefix, single/double quotes stripped.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional


def parse_dotenv(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export ") :]
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        if key:
            out[key] = value
    return out


def load_dotenv(
    path: Optional[Path] = None, override: bool = False
) -> Dict[str, str]:
    """Load ``.env`` (default: cwd) into ``os.environ``; returns the parsed map."""
    path = Path(path) if path else Path(".env")
    if not path.exists():
        return {}
    values = parse_dotenv(path.read_text())
    for key, value in values.items():
        if override or key not in os.environ:
            os.environ[key] = value
    return values
