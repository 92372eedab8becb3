"""Per-run context handed to every lifecycle hook.

Reference: ``ConfigValidator/Config/Models/RunnerContext.py:4-9`` (run_variation,
run_nr, run_dir). Extended with the total run count (the reference prints
``[n/total]`` from the controller instead, IRunController.py:31), the
experiment dir, and a free-form scratch dict so hooks can pass state to later
hooks without mutating the config object (the reference stashes state on
``self`` across hooks, e.g. experiment/RunnerConfig.py:103,133).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict


@dataclasses.dataclass
class RunContext:
    run_id: str
    run_nr: int  # 1-based position in the run table
    total_runs: int
    variation: Dict[str, Any]  # factor name -> treatment for this run
    run_dir: Path  # per-run artifact directory (created before BEFORE_RUN)
    experiment_dir: Path
    scratch: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def factor(self, name: str) -> Any:
        return self.variation[name]
