"""Experiment kernel: run tables, events, config contract, persistence, control.

Rebuilds reference layers L1–L5 (``experiment-runner/``, see SURVEY.md §1)
idiomatically: instance-scoped multi-subscriber event bus (the reference's
``EventSubscriptionController.py:8-9`` silently drops extra subscribers),
dataclass factors, typed CSV round-tripping (the reference's
``CSVOutputManager.py:21-22`` leaves floats as strings), and a controller with
optional per-run process isolation.
"""

from .config import ExperimentConfig, OperationType
from .context import RunContext
from .controller import ExperimentController
from .events import EventBus, LifecycleEvent
from .factors import Factor, RunTableModel
from .progress import RunProgress

__all__ = [
    "ExperimentConfig",
    "OperationType",
    "RunContext",
    "ExperimentController",
    "EventBus",
    "LifecycleEvent",
    "Factor",
    "RunTableModel",
    "RunProgress",
]
