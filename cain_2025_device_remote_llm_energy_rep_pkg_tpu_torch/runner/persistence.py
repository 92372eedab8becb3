"""Crash-safe experiment persistence: run_table.csv + metadata.json + JSONL.

Reference: ``ProgressManager/Output/CSVOutputManager.py`` (full write :33-42,
typed read :13-31, atomic single-row update via NamedTemporaryFile +
shutil.move :48-65) and ``JSONOutputManager.py`` (jsonpickled Metadata, :9-16).

Fixes over the reference, kept deliberately (SURVEY.md §7 "quirks worth not
copying"): CSV values round-trip as int/float/bool/None/str (the reference's
``isnumeric()`` coercion leaves floats as strings, CSVOutputManager.py:21-22);
metadata is plain JSON instead of jsonpickle; the atomic replace uses
``os.replace`` in the same directory so it never crosses filesystems.
"""

from __future__ import annotations

import csv
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .errors import PersistenceError
from .factors import DONE_COLUMN, RUN_ID_COLUMN
from .progress import RunProgress

RUN_TABLE_FILENAME = "run_table.csv"
METADATA_FILENAME = "metadata.json"


def _encode_cell(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, RunProgress):
        return value.value
    if isinstance(value, float):
        return repr(value)  # shortest round-trip representation
    return str(value)


def _decode_cell(column: str, text: str) -> Any:
    if column == DONE_COLUMN:
        return RunProgress(text)
    if text == "":
        return None
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


class RunTableStore:
    """run_table.csv persistence with atomic whole-file and per-row updates."""

    def __init__(self, experiment_dir: Path) -> None:
        self.experiment_dir = Path(experiment_dir)
        self.path = self.experiment_dir / RUN_TABLE_FILENAME

    def exists(self) -> bool:
        return self.path.exists()

    def write(self, rows: Sequence[Mapping[str, Any]]) -> None:
        if not rows:
            raise PersistenceError("refusing to write an empty run table")
        columns = list(rows[0].keys())
        self._atomic_write(columns, rows)

    def read(self) -> List[Dict[str, Any]]:
        if not self.path.exists():
            raise PersistenceError(f"run table not found: {self.path}")
        with self.path.open(newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise PersistenceError(f"run table has no header: {self.path}")
            return [
                {col: _decode_cell(col, row[col]) for col in reader.fieldnames}
                for row in reader
            ]

    def update_row(self, run_id: str, updates: Mapping[str, Any]) -> None:
        """Rewrite exactly one row, atomically (reference CSVOutputManager.py:48-65).

        Reads the current table, applies ``updates`` to the row with
        ``__run_id == run_id``, writes to a temp file in the same directory,
        then ``os.replace``s it over the original so a crash mid-write never
        corrupts the table.
        """
        rows = self.read()
        hit = False
        for row in rows:
            if row[RUN_ID_COLUMN] == run_id:
                unknown = set(updates) - set(row)
                if unknown:
                    raise PersistenceError(
                        f"update for {run_id!r} has unknown columns: {sorted(unknown)}"
                    )
                row.update(updates)
                hit = True
                break
        if not hit:
            raise PersistenceError(f"run id {run_id!r} not in run table")
        self._atomic_write(list(rows[0].keys()), rows)

    def _atomic_write(
        self, columns: Sequence[str], rows: Sequence[Mapping[str, Any]]
    ) -> None:
        self.experiment_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp_path = tempfile.mkstemp(
            dir=self.experiment_dir, prefix=".run_table.", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(columns)
                for row in rows:
                    writer.writerow([_encode_cell(row[c]) for c in columns])
            os.replace(tmp_path, self.path)
        except BaseException:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            raise


class MetadataStore:
    """metadata.json: the config AST hash + framework version for resume checks."""

    def __init__(self, experiment_dir: Path) -> None:
        self.path = Path(experiment_dir) / METADATA_FILENAME

    def write(self, metadata: Mapping[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp_path = tempfile.mkstemp(
            dir=self.path.parent, prefix=".metadata.", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(dict(metadata), f, indent=2, default=str)
            os.replace(tmp_path, self.path)
        except BaseException:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            raise

    def read(self) -> Optional[Dict[str, Any]]:
        if not self.path.exists():
            return None
        with self.path.open() as f:
            return json.load(f)
