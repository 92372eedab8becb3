"""Console + structured logging.

Reference: ``ProgressManager/Output/OutputProcedure.py`` (ANSI-colored
``[EXPERIMENT_RUNNER]:`` console logger, :21-58, and the interactive yes/no
prompt :61-88) and ``ExperimentOrchestrator/Misc/BashHeaders.py``. Added over
the reference: per-run structured JSONL event logs (SURVEY.md §5 calls out the
reference's lack of any log file).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

PREFIX = "[RUNNER]"

_COLORS = {
    "ok": "\033[92m",
    "warn": "\033[93m",
    "fail": "\033[91m",
    "bold": "\033[1m",
}
_RESET = "\033[0m"


def _emit(msg: str, color: Optional[str] = None) -> None:
    if color and sys.stdout.isatty():
        print(f"{_COLORS[color]}{PREFIX} {msg}{_RESET}")
    else:
        print(f"{PREFIX} {msg}")


def log(msg: str) -> None:
    _emit(msg)


def log_ok(msg: str) -> None:
    _emit(msg, "ok")


def log_warn(msg: str) -> None:
    _emit(msg, "warn")


def log_fail(msg: str) -> None:
    _emit(msg, "fail")


def query_yes_no(question: str, default: Optional[bool] = True) -> bool:
    """Interactive y/n prompt (reference OutputProcedure.py:61-88).

    Non-interactive stdin (CI, batch jobs) returns the default instead of looping.
    """
    suffix = {True: " [Y/n] ", False: " [y/N] ", None: " [y/n] "}[default]
    if not sys.stdin.isatty():
        if default is None:
            raise RuntimeError("yes/no prompt with no default on non-tty stdin")
        return default
    valid = {"yes": True, "y": True, "no": False, "n": False}
    while True:
        choice = input(question + suffix).strip().lower()
        if choice == "" and default is not None:
            return default
        if choice in valid:
            return valid[choice]
        print("Please answer 'y' or 'n'.")


class JsonlLogger:
    """Append-only structured event log (one JSON object per line)."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def event(self, kind: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "event": kind}
        record.update(fields)
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=str) + "\n")


def format_table(rows: Dict[str, Any], title: str = "") -> str:
    """Two-column ASCII table for config echo (reference uses tabulate,
    ConfigValidator.py:56-62); dependency-free here."""
    if not rows:
        return ""
    key_w = max(len(str(k)) for k in rows)
    val_w = max(len(str(v)) for v in rows.values())
    bar = "+" + "-" * (key_w + 2) + "+" + "-" * (val_w + 2) + "+"
    lines = [bar]
    if title:
        lines = [title, bar]
    for k, v in rows.items():
        lines.append(f"| {str(k):<{key_w}} | {str(v):<{val_w}} |")
    lines.append(bar)
    return "\n".join(lines)
