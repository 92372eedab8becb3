"""The config-as-code contract: an ExperimentConfig subclass defines the study.

Reference: ``ConfigValidator/Config/RunnerConfig.py`` — class attributes
(name/results_output_path/operation_type/time_between_runs_in_ms, :20-32), the
run-table factory, and the 9 lifecycle hooks (:69-120). The reference requires
the class to be literally named ``RunnerConfig`` (__main__.py:62-71); here any
subclass of ``ExperimentConfig`` in the config module is accepted.

Profilers are a first-class ``profilers`` attribute rather than the
reference's class-decorator monkey-patching (CodecarbonWrapper.py:31-41): the
controller subscribes each profiler's three phases onto the same event bus as
the user hooks, so composition is ordered and inspectable.
"""

from __future__ import annotations

import enum
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, TYPE_CHECKING

from .context import RunContext
from .factors import RunTableModel

if TYPE_CHECKING:  # pragma: no cover
    from ..profilers.base import Profiler


class OperationType(enum.Enum):
    """AUTO continues between runs automatically; SEMI raises CONTINUE and
    waits on the user's callback (reference OperationType.py:3-10)."""

    AUTO = "auto"
    SEMI = "semi"


class ExperimentConfig:
    """Base class for experiment definitions. Subclass and override hooks.

    Every hook is optional (no-op by default); ``create_run_table_model`` is
    the one required override. Hooks receive the per-run :class:`RunContext`
    except the experiment-scoped pair.
    """

    # -- settings (reference Config/RunnerConfig.py:20-32) --------------------
    name: str = "new_experiment"
    results_output_path: Path = Path("experiments_output")
    operation_type: OperationType = OperationType.AUTO
    time_between_runs_in_ms: int = 0
    # New over the reference: first-class knobs that its design hardcodes.
    isolate_runs: bool = True  # run each run in a forked subprocess
    retry_failed_on_resume: bool = True
    # Immutable default on purpose: a shared class-level list would leak
    # profiler instances (and their per-run state) across configs. Subclasses
    # assign their own sequence (or do self.profilers = [...] in __init__).
    profilers: Sequence["Profiler"] = ()

    # Populated by the validator (reference ConfigValidator.py:26-28).
    experiment_path: Optional[Path] = None

    # -- run table ------------------------------------------------------------
    def create_run_table_model(self) -> RunTableModel:
        raise NotImplementedError(
            "ExperimentConfig subclasses must implement create_run_table_model()"
        )

    # -- lifecycle hooks (reference Config/RunnerConfig.py:69-120) ------------
    def before_experiment(self) -> None:
        """Once, before the first run."""

    def before_run(self, context: RunContext) -> None:
        """Before each run, in the parent process (cheap setup only)."""

    def start_run(self, context: RunContext) -> None:
        """Start the measured activity (e.g. launch generation)."""

    def start_measurement(self, context: RunContext) -> None:
        """Measurement window opens (profilers start just before this hook)."""

    def interact(self, context: RunContext) -> None:
        """Interact with the running activity; return when it completes."""

    def continue_experiment(self) -> None:
        """SEMI mode only: block until the operator allows the next run."""

    def stop_measurement(self, context: RunContext) -> None:
        """Measurement window closes (profilers stop just after this hook)."""

    def stop_run(self, context: RunContext) -> None:
        """Tear down the activity."""

    def populate_run_data(self, context: RunContext) -> Optional[Dict[str, Any]]:
        """Return a dict of data-column values for this run's row."""
        return None

    def after_experiment(self) -> None:
        """Once, after the last run."""
