"""Experiment and run orchestration.

Reference: ``ExperimentOrchestrator/Experiment/ExperimentController.py`` (ctor
with fresh/resume branches :33-108; ``do_experiment`` main loop :110-146) and
``Run/RunController.py`` (per-run event sequence :13-44). Differences by
design:

- One fork boundary per run, not two (reference stacks Process + @processify,
  ExperimentController.py:127 + RunController.py:9).
- The run-table row is written by the *parent* after the child reports its
  data over the queue — a single CSV writer instead of the child mutating the
  table (reference RunController.py:43-44).
- A failed run is marked FAILED in the table before the error propagates, so
  restart retries exactly that run (the reference leaves it TODO and aborts).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import term
from .config import ExperimentConfig, OperationType
from .context import RunContext
from .errors import RunFailedError
from .events import EventBus, LifecycleEvent as E
from .factors import DONE_COLUMN, RUN_ID_COLUMN
from .isolation import ChildProcessError_, run_isolated
from .persistence import MetadataStore, RunTableStore
from .progress import RunProgress
from .resume import config_ast_hash, reconcile_run_tables
from .term import JsonlLogger
from .validation import validate_config


class ExperimentController:
    """Drives a validated ExperimentConfig through the full lifecycle."""

    def __init__(
        self,
        config: ExperimentConfig,
        config_source: Optional[str] = None,
        echo: bool = True,
    ) -> None:
        self.config = validate_config(config, echo=echo)
        self.config_hash = config_ast_hash(config_source) if config_source else None
        self.bus = EventBus()
        self._wire_bus()

        model = config.create_run_table_model()
        for profiler in config.profilers:
            model.add_data_columns(profiler.data_columns)
        self._factor_names = model.factor_names
        rows = model.generate()

        self.experiment_dir = config.experiment_path
        assert self.experiment_dir is not None
        self.store = RunTableStore(self.experiment_dir)
        self.metadata = MetadataStore(self.experiment_dir)

        if self.store.exists():
            rows = self._resume(rows)
        else:
            self.experiment_dir.mkdir(parents=True, exist_ok=True)
            self.store.write(rows)
            self.metadata.write(self._metadata_dict())
            term.log(f"new experiment at {self.experiment_dir}")
        self.rows = rows
        self.jsonl = JsonlLogger(self.experiment_dir / "experiment_log.jsonl")

    # -- wiring ---------------------------------------------------------------
    def _wire_bus(self) -> None:
        """Subscribe config hooks and profiler phases in deterministic order.

        Profilers open before and close after the user's measurement hooks so
        the measurement window encloses user work — the composition the
        reference gets from decorator wrapping (CodecarbonWrapper.py:43-68).
        """
        cfg = self.config
        self.bus.subscribe(E.BEFORE_EXPERIMENT, cfg.before_experiment)
        self.bus.subscribe(E.BEFORE_RUN, cfg.before_run)
        self.bus.subscribe(E.START_RUN, cfg.start_run)
        for profiler in cfg.profilers:
            self.bus.subscribe(E.START_MEASUREMENT, profiler.on_start)
        self.bus.subscribe(E.START_MEASUREMENT, cfg.start_measurement)
        self.bus.subscribe(E.INTERACT, cfg.interact)
        self.bus.subscribe(E.CONTINUE, cfg.continue_experiment)
        self.bus.subscribe(E.STOP_MEASUREMENT, cfg.stop_measurement)
        for profiler in cfg.profilers:
            self.bus.subscribe(E.STOP_MEASUREMENT, profiler.on_stop)
        self.bus.subscribe(E.STOP_RUN, cfg.stop_run)
        self.bus.subscribe(E.POPULATE_RUN_DATA, cfg.populate_run_data)
        for profiler in cfg.profilers:
            self.bus.subscribe(E.POPULATE_RUN_DATA, profiler.collect)
        self.bus.subscribe(E.AFTER_EXPERIMENT, cfg.after_experiment)

    def _metadata_dict(self) -> Dict[str, Any]:
        from .. import __version__

        return {
            "config_ast_hash": self.config_hash,
            "framework_version": __version__,
            "experiment_name": self.config.name,
        }

    def _resume(self, generated: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Restart branch (reference ExperimentController.py:41-108)."""
        term.log_warn(f"existing experiment found at {self.experiment_dir}; resuming")
        stored_meta = self.metadata.read() or {}
        stored_hash = stored_meta.get("config_ast_hash")
        if self.config_hash and stored_hash and self.config_hash != stored_hash:
            if not term.query_yes_no(
                "config changed since the stored experiment (AST hash mismatch). "
                "Resume anyway?",
                default=False,
            ):
                from .errors import ResumeError

                raise ResumeError(
                    "config AST hash mismatch; refusing to resume "
                    "(delete the experiment dir or restore the config)"
                )
            self.metadata.write(self._metadata_dict())
        stored = self.store.read()
        merged = reconcile_run_tables(
            generated, stored, retry_failed=self.config.retry_failed_on_resume
        )
        todo = sum(1 for r in merged if r[DONE_COLUMN] != RunProgress.DONE)
        term.log(f"resume: {len(merged) - todo}/{len(merged)} runs done, {todo} to go")
        self.store.write(merged)
        return merged

    # -- main loop ------------------------------------------------------------
    def do_experiment(self) -> None:
        self.jsonl.event("experiment_start", name=self.config.name, runs=len(self.rows))
        self.bus.raise_event(E.BEFORE_EXPERIMENT)
        total = len(self.rows)
        try:
            for idx, row in enumerate(self.rows):
                if row[DONE_COLUMN] == RunProgress.DONE:
                    continue
                context = self._make_context(row, idx + 1, total)
                self._execute_run(context, row)
                more_to_do = any(
                    r[DONE_COLUMN] != RunProgress.DONE for r in self.rows[idx + 1 :]
                )
                if not more_to_do:
                    break  # no cooldown/CONTINUE gate after the final run
                if self.config.time_between_runs_in_ms > 0:
                    term.log(
                        f"cooldown {self.config.time_between_runs_in_ms} ms before next run"
                    )
                    time.sleep(self.config.time_between_runs_in_ms / 1000.0)
                if self.config.operation_type is OperationType.SEMI:
                    self.bus.raise_event(E.CONTINUE)
        finally:
            self.bus.raise_event(E.AFTER_EXPERIMENT)
            self.jsonl.event("experiment_end", name=self.config.name)
        term.log_ok(f"experiment complete: {self.experiment_dir}")

    def _make_context(self, row: Dict[str, Any], run_nr: int, total: int) -> RunContext:
        run_id = row[RUN_ID_COLUMN]
        run_dir = self.experiment_dir / run_id
        run_dir.mkdir(parents=True, exist_ok=True)
        return RunContext(
            run_id=run_id,
            run_nr=run_nr,
            total_runs=total,
            variation={name: row[name] for name in self._factor_names},
            run_dir=run_dir,
            experiment_dir=self.experiment_dir,
        )

    def _execute_run(self, context: RunContext, row: Dict[str, Any]) -> None:
        term.log(f"run {context.run_id} [{context.run_nr}/{context.total_runs}]")
        self.jsonl.event("run_start", run_id=context.run_id, variation=context.variation)
        t0 = time.monotonic()
        self.bus.raise_event(E.BEFORE_RUN, context)
        try:
            if self.config.isolate_runs:
                run_data = run_isolated(self._run_lifecycle, context)
            else:
                run_data = self._run_lifecycle(context)
        except ChildProcessError_ as exc:
            self.store.update_row(context.run_id, {DONE_COLUMN: RunProgress.FAILED})
            row[DONE_COLUMN] = RunProgress.FAILED
            self.jsonl.event("run_failed", run_id=context.run_id)
            raise RunFailedError(context.run_id, exc.child_traceback) from None
        except Exception:
            self.store.update_row(context.run_id, {DONE_COLUMN: RunProgress.FAILED})
            row[DONE_COLUMN] = RunProgress.FAILED
            self.jsonl.event("run_failed", run_id=context.run_id)
            raise
        updates = dict(run_data)
        updates[DONE_COLUMN] = RunProgress.DONE
        self.store.update_row(context.run_id, updates)
        row.update(updates)
        self.jsonl.event(
            "run_done", run_id=context.run_id, wall_s=round(time.monotonic() - t0, 3)
        )

    def _run_lifecycle(self, context: RunContext) -> Dict[str, Any]:
        """The per-run event sequence (reference RunController.py:13-41).

        Runs in the forked child when ``isolate_runs`` is set; returns the
        merged POPULATE_RUN_DATA dict for the parent to persist.
        """
        self.bus.raise_event(E.START_RUN, context)
        self.bus.raise_event(E.START_MEASUREMENT, context)
        self.bus.raise_event(E.INTERACT, context)
        self.bus.raise_event(E.STOP_MEASUREMENT, context)
        self.bus.raise_event(E.STOP_RUN, context)
        return self.bus.raise_and_merge(E.POPULATE_RUN_DATA, context) or {}
