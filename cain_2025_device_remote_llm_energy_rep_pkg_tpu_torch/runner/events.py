"""Lifecycle event bus.

Reference: ``EventManager/Models/RunnerEvents.py:3-13`` (the 10 events) and
``EventSubscriptionController.py`` (static, single-slot registry — a later
subscription silently overwrites the earlier one, :8-9). This rebuild keeps the
10-event lifecycle contract but the bus is an *instance* (no cross-experiment
global state) and supports ordered multi-subscriber dispatch, which is what
lets profiler plugins and the user config hook the same event without the
decorator monkey-patching the reference needs (CodecarbonWrapper.py:31-41).
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional


class LifecycleEvent(enum.Enum):
    """The experiment lifecycle, in raise order (per run: BEFORE_RUN..POPULATE_RUN_DATA)."""

    BEFORE_EXPERIMENT = "before_experiment"
    BEFORE_RUN = "before_run"
    START_RUN = "start_run"
    START_MEASUREMENT = "start_measurement"
    INTERACT = "interact"
    CONTINUE = "continue"
    STOP_MEASUREMENT = "stop_measurement"
    STOP_RUN = "stop_run"
    POPULATE_RUN_DATA = "populate_run_data"
    AFTER_EXPERIMENT = "after_experiment"


class EventBus:
    """Ordered multi-subscriber event dispatch.

    ``raise_event`` invokes every subscriber in subscription order and returns
    the list of their return values (empty list when nobody is subscribed —
    the reference returns a bare ``None`` there,
    EventSubscriptionController.py:21-22).
    """

    def __init__(self) -> None:
        self._subscribers: Dict[LifecycleEvent, List[Callable[..., Any]]] = {}

    def subscribe(self, event: LifecycleEvent, callback: Callable[..., Any]) -> None:
        self._subscribers.setdefault(event, []).append(callback)

    def subscribe_many(
        self, events: List[LifecycleEvent], callback: Callable[..., Any]
    ) -> None:
        for event in events:
            self.subscribe(event, callback)

    def unsubscribe(self, event: LifecycleEvent, callback: Callable[..., Any]) -> None:
        callbacks = self._subscribers.get(event, [])
        if callback in callbacks:
            callbacks.remove(callback)

    def subscribers(self, event: LifecycleEvent) -> List[Callable[..., Any]]:
        return list(self._subscribers.get(event, []))

    def raise_event(self, event: LifecycleEvent, *args: Any) -> List[Any]:
        return [cb(*args) for cb in self._subscribers.get(event, [])]

    def raise_and_merge(
        self, event: LifecycleEvent, *args: Any
    ) -> Optional[Dict[str, Any]]:
        """Raise an event whose subscribers return data dicts; merge them.

        Used for POPULATE_RUN_DATA where the user hook and each profiler all
        contribute run-table columns. Later subscribers win on key conflict
        (profilers are subscribed after the user hook, matching the reference's
        wrapper-after-user composition, CodecarbonWrapper.py:82-99).
        """
        merged: Dict[str, Any] = {}
        saw_any = False
        for result in self.raise_event(event, *args):
            if result is None:
                continue
            if not isinstance(result, dict):
                raise TypeError(
                    f"{event.name} subscriber returned {type(result).__name__}, "
                    "expected dict or None"
                )
            merged.update(result)
            saw_any = True
        return merged if saw_any else None
