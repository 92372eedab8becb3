"""Resume semantics: config AST hashing and run-table reconciliation.

Reference: ``experiment-runner/__main__.py:27-49`` (``calc_ast_md5sum`` — a
location/docstring-insensitive md5 of the config source so cosmetic edits keep
resume valid) and ``ExperimentOrchestrator/Experiment/ExperimentController.py``
restart branch (:41-108): abort when nothing is TODO (:50-52), column-set
equality (:60-63), md5 check with interactive override (:65-73), reorder
generated rows to disk order and copy data columns back (:79-101).
"""

from __future__ import annotations

import ast
import hashlib
from typing import Any, Dict, List, Sequence

from .errors import AllRunsCompletedError, ResumeError
from .factors import DONE_COLUMN, RUN_ID_COLUMN
from .progress import RunProgress


def config_ast_hash(source: str) -> str:
    """md5 of the config module's AST, insensitive to formatting/comments/docstrings.

    Mirrors the reference's approach (__main__.py:27-49): parse, blank every
    docstring, then hash a dump that omits source locations (``ast.dump``
    without attributes is location-free, so no per-node zeroing is needed).
    """
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (
            isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            body[0].value.value = ""
    dump = ast.dump(tree, annotate_fields=True, include_attributes=False)
    return hashlib.md5(dump.encode()).hexdigest()


def reconcile_run_tables(
    generated: Sequence[Dict[str, Any]],
    stored: Sequence[Dict[str, Any]],
    retry_failed: bool = True,
) -> List[Dict[str, Any]]:
    """Merge a freshly generated run table with the persisted one on restart.

    Returns rows in *stored* order with the stored data columns and progress
    copied in — the reference's reorder-and-copy branch
    (ExperimentController.py:79-101). Raises :class:`ResumeError` on column or
    row-id mismatch and :class:`AllRunsCompletedError` when there is nothing
    left to do.
    """
    if not stored:
        raise ResumeError("stored run table is empty")
    gen_cols = set(generated[0].keys())
    stored_cols = set(stored[0].keys())
    removed = stored_cols - gen_cols
    if removed:
        raise ResumeError(
            "run table columns were removed since the stored experiment: "
            f"{sorted(removed)} (data would be dropped; refusing)"
        )
    added = gen_cols - stored_cols
    if added:
        # New data columns (e.g. a profiler upgrade) must not strand a
        # half-finished sweep: completed rows get None for the new columns.
        from . import term

        term.log_warn(
            f"resuming with new data columns {sorted(added)}; completed runs "
            "will have empty values for them"
        )
    by_id = {row[RUN_ID_COLUMN]: row for row in generated}
    if len(by_id) != len(generated):
        raise ResumeError("generated run table has duplicate run ids")
    stored_ids = [row[RUN_ID_COLUMN] for row in stored]
    if set(stored_ids) != set(by_id):
        raise ResumeError(
            "run ids changed since the stored experiment "
            "(factors/repetitions differ?)"
        )

    merged: List[Dict[str, Any]] = []
    for stored_row in stored:
        row = dict(by_id[stored_row[RUN_ID_COLUMN]])
        for name, value in stored_row.items():
            if name == RUN_ID_COLUMN:
                continue
            if name == DONE_COLUMN:
                progress = value
                if progress == RunProgress.FAILED and retry_failed:
                    progress = RunProgress.TODO
                row[DONE_COLUMN] = progress
            else:
                gen_value = row.get(name)
                if gen_value is None:
                    # Data column: copy the stored measurement back in.
                    row[name] = value
                else:
                    # Factor column: the CSV round-trip is lossy for
                    # numeric-looking string treatments ('32' comes back as
                    # int 32), so compare by string form and keep the
                    # generated (config-typed) value as the source of truth.
                    if str(value) != str(gen_value) and not (
                        value is None and gen_value == ""
                    ):
                        raise ResumeError(
                            f"factor value changed for {stored_row[RUN_ID_COLUMN]!r} "
                            f"column {name!r}: stored {value!r} vs generated {gen_value!r}"
                        )
        merged.append(row)

    if all(row[DONE_COLUMN] == RunProgress.DONE for row in merged):
        raise AllRunsCompletedError(
            "all runs are already DONE; nothing to resume"
        )
    return merged
