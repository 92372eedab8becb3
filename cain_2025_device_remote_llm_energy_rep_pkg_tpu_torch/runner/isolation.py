"""Per-run process isolation with exception marshalling.

Reference: ``ExperimentOrchestrator/Architecture/Processify.py`` (:17-103):
run a function in a forked ``multiprocessing.Process``, send back the return
value or ``(type, value, formatted_traceback)`` over a Queue, re-raise in the
parent with the child traceback attached. The reference stacks *two* fork
boundaries per run (ExperimentController.py:127 + the @processify on
RunController.do_run:9); one is enough and this rebuild uses one.

Fork start method is required so event-bus subscriptions and config state
made in the parent survive into the child (reference __main__.py:58).

Limitation: a forked child cannot use CUDA once the parent has. A config
whose runs touch the card keeps ``isolate_runs = False`` (the study does,
``experiments/llm_energy.py``), so the engine lives in the parent.
"""

from __future__ import annotations

import multiprocessing
import traceback
from typing import Any, Callable, Tuple


class ChildProcessError_(Exception):
    """Raised in the parent when the child function raised; carries child tb."""

    def __init__(self, child_traceback: str):
        super().__init__(f"(in subprocess)\n{child_traceback}")
        self.child_traceback = child_traceback


def _child_main(queue: "multiprocessing.Queue", fn: Callable[..., Any], args: Tuple[Any, ...]) -> None:
    try:
        result = fn(*args)
        queue.put(("ok", result))
    except BaseException as exc:  # noqa: BLE001 — marshal everything to parent
        queue.put(("err", "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))))


def run_isolated(fn: Callable[..., Any], *args: Any) -> Any:
    """Run ``fn(*args)`` in a forked child; return its result or re-raise.

    The result must be picklable (run-data dicts are). A child that dies
    without reporting (SIGKILL, OOM) surfaces as ChildProcessError_ with the
    exit code.
    """
    ctx = multiprocessing.get_context("fork")
    queue: "multiprocessing.Queue" = ctx.Queue()
    proc = ctx.Process(target=_child_main, args=(queue, fn, args))
    proc.start()
    # Read before join: a large result could fill the queue's pipe buffer and
    # deadlock a join-first parent (the reference reads first too,
    # Processify.py:62-64). Poll so a child that dies without reporting
    # (SIGKILL, OOM, unpicklable result killing the feeder thread) surfaces
    # as an error instead of hanging the sweep.
    import queue as queue_mod

    while True:
        try:
            status, payload = queue.get(timeout=0.2)
            break
        except queue_mod.Empty:
            if not proc.is_alive():
                # Drain race: the child may have exited right after putting.
                try:
                    status, payload = queue.get(timeout=0.5)
                    break
                except queue_mod.Empty:
                    proc.join()
                    raise ChildProcessError_(
                        f"child exited without reporting a result "
                        f"(exit code {proc.exitcode}; killed by OOM/signal, "
                        "or its return value was unpicklable)"
                    ) from None
    proc.join()
    if status == "ok":
        return payload
    raise ChildProcessError_(payload)
