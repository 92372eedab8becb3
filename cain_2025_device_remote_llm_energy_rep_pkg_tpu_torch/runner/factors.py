"""Experiment factors and full-factorial run-table generation.

Reference: ``ConfigValidator/Config/Models/FactorModel.py`` (named factor +
unique treatments, :8-13) and ``RunTableModel.py`` (cartesian product via
itertools.product :72, exclusion filters :46-69, repetition expansion with
``run_{i}_repetition_{j}`` ids :84-93, optional shuffle :95-96).

Differences by design: exclusions are declarative dicts rather than opaque
lambda-over-tuple filters; shuffling takes an explicit seed so a shuffled
table is reproducible (the reference uses global ``random.shuffle``); rows are
plain dicts with ``__run_id``/``__done`` bookkeeping columns first, matching
the reference's on-disk layout so resume semantics carry over.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from .errors import RunTableError
from .progress import RunProgress

RUN_ID_COLUMN = "__run_id"
DONE_COLUMN = "__done"


@dataclasses.dataclass(frozen=True)
class Factor:
    """A named factor with its treatment levels.

    Treatments may be any value with a stable ``str()`` (the reference's
    ``SupportsStr`` protocol, ExtendedTyping/Typing.py:5-12).
    """

    name: str
    treatments: Sequence[Any]

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise RunTableError("factor name must be a non-empty string")
        if self.name.startswith("__"):
            raise RunTableError(
                f"factor name {self.name!r} collides with bookkeeping columns"
            )
        if len(self.treatments) == 0:
            raise RunTableError(f"factor {self.name!r} has no treatments")
        seen = []
        for t in self.treatments:
            if t in seen:
                raise RunTableError(
                    f"factor {self.name!r} has duplicate treatment {t!r}"
                )
            seen.append(t)

    def __len__(self) -> int:
        return len(self.treatments)


class RunTableModel:
    """Full-factorial design: factors × repetitions, minus excluded variations.

    ``exclusions`` is a list of dicts ``{factor_name: iterable-of-levels}``; a
    variation is excluded when, for *every* key in one dict, the variation's
    level for that factor is in the listed levels (conjunction within a dict,
    disjunction across dicts — same expressive power as the reference's
    ``exclude_variations``, RunTableModel.py:46-69, but inspectable).
    """

    def __init__(
        self,
        factors: Sequence[Factor],
        repetitions: int = 1,
        data_columns: Sequence[str] = (),
        exclusions: Sequence[Mapping[str, Iterable[Any]]] = (),
        shuffle: bool = False,
        shuffle_seed: Optional[int] = 0,
    ) -> None:
        if not factors:
            raise RunTableError("at least one factor is required")
        names = [f.name for f in factors]
        if len(set(names)) != len(names):
            raise RunTableError(f"duplicate factor names: {names}")
        if repetitions < 1:
            raise RunTableError(f"repetitions must be >= 1, got {repetitions}")
        overlap = set(names) & set(data_columns)
        if overlap:
            raise RunTableError(
                f"data columns collide with factor names: {sorted(overlap)}"
            )
        if len(set(data_columns)) != len(data_columns):
            raise RunTableError(f"duplicate data columns: {list(data_columns)}")
        for excl in exclusions:
            unknown = set(excl) - set(names)
            if unknown:
                raise RunTableError(
                    f"exclusion references unknown factors: {sorted(unknown)}"
                )
        self.factors = list(factors)
        self.repetitions = repetitions
        self.data_columns = list(data_columns)
        self.exclusions = [dict(e) for e in exclusions]
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed

    @property
    def factor_names(self) -> List[str]:
        return [f.name for f in self.factors]

    @property
    def columns(self) -> List[str]:
        return (
            [RUN_ID_COLUMN, DONE_COLUMN] + self.factor_names + self.data_columns
        )

    def add_data_columns(self, columns: Sequence[str]) -> None:
        """Append plugin-owned data columns (reference: CodecarbonWrapper.py:70-80)."""
        for col in columns:
            if col in self.columns:
                raise RunTableError(f"data column {col!r} already exists")
            self.data_columns.append(col)

    def _is_excluded(self, variation: Dict[str, Any]) -> bool:
        for excl in self.exclusions:
            if all(variation[name] in levels for name, levels in excl.items()):
                return True
        return False

    def variations(self) -> List[Dict[str, Any]]:
        """All non-excluded factor combinations, in product order."""
        out = []
        for combo in itertools.product(*(f.treatments for f in self.factors)):
            variation = dict(zip(self.factor_names, combo))
            if not self._is_excluded(variation):
                out.append(variation)
        if not out:
            raise RunTableError("all variations excluded; empty run table")
        return out

    def generate(self) -> List[Dict[str, Any]]:
        """Materialise the run table: one dict per run.

        Row ids are ``run_{variation_index}_repetition_{rep}`` (reference
        RunTableModel.py:87). Repetition is the outer loop, matching the
        reference's row order; with ``shuffle`` the rows are permuted by a
        seeded RNG so two generations of the same model agree (needed for
        resume reconciliation).
        """
        rows: List[Dict[str, Any]] = []
        variations = self.variations()
        for rep in range(self.repetitions):
            for i, variation in enumerate(variations):
                row: Dict[str, Any] = {
                    RUN_ID_COLUMN: f"run_{i}_repetition_{rep}",
                    DONE_COLUMN: RunProgress.TODO,
                }
                row.update(variation)
                for col in self.data_columns:
                    row[col] = None
                rows.append(row)
        if self.shuffle:
            random.Random(self.shuffle_seed).shuffle(rows)
        return rows
