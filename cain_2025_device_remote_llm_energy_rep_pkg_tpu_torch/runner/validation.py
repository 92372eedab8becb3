"""Config validation: types, paths, hook signatures; echo the config.

Reference: ``ConfigValidator/Config/Validation/ConfigValidator.py:23-65``
(sets ``experiment_path = results_output_path/name`` with ``~`` expansion,
checks attribute types and path writability, prints the config as a table,
raises on failure) plus ``Misc/PathValidation.py`` (portable creatability
probe — here a direct ``os.access`` / mkdir probe, POSIX-only by design).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict

from . import term
from .config import ExperimentConfig, OperationType
from .errors import ConfigError


def _path_writable_or_creatable(path: Path) -> bool:
    probe = path
    while not probe.exists():
        parent = probe.parent
        if parent == probe:
            return False
        probe = parent
    return os.access(probe, os.W_OK)


def validate_config(config: ExperimentConfig, echo: bool = True) -> ExperimentConfig:
    """Validate settings, derive ``experiment_path``, optionally echo config."""
    if not isinstance(config.name, str) or not config.name:
        raise ConfigError("config.name must be a non-empty string")
    if os.sep in config.name:
        raise ConfigError(f"config.name must not contain path separators: {config.name!r}")
    if not isinstance(config.operation_type, OperationType):
        raise ConfigError(
            f"config.operation_type must be an OperationType, got {config.operation_type!r}"
        )
    if not isinstance(config.time_between_runs_in_ms, int) or config.time_between_runs_in_ms < 0:
        raise ConfigError(
            "config.time_between_runs_in_ms must be a non-negative int, got "
            f"{config.time_between_runs_in_ms!r}"
        )
    out = Path(config.results_output_path).expanduser()
    if not _path_writable_or_creatable(out):
        raise ConfigError(f"results_output_path is not writable/creatable: {out}")
    config.experiment_path = out / config.name

    from ..profilers.base import Profiler  # local import: the runner imports no profiler at load

    for profiler in config.profilers:
        if not isinstance(profiler, Profiler):
            raise ConfigError(f"config.profilers entry is not a Profiler: {profiler!r}")

    if echo:
        summary: Dict[str, Any] = {
            "name": config.name,
            "results_output_path": out,
            "experiment_path": config.experiment_path,
            "operation_type": config.operation_type.name,
            "time_between_runs_in_ms": config.time_between_runs_in_ms,
            "isolate_runs": config.isolate_runs,
            "profilers": ", ".join(type(p).__name__ for p in config.profilers) or "-",
        }
        term.log("experiment config:\n" + term.format_table(summary))
    return config
