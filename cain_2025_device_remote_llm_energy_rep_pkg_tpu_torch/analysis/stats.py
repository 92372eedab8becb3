"""Statistical primitives mirroring the reference notebook's methods.

Reference cells (data-analysis/analysis-visualization.ipynb): cell 11 IQR
outlier removal, cell 15 mean/median/SD descriptives, cell 33 Shapiro-Wilk,
cell 37 two-sided Wilcoxon + Cliff's delta with thresholds
negligible/small/medium/large = .147/.33/.474, cell 42 Spearman ρ with
significance stars. Implemented on numpy/scipy; Cliff's delta is computed
exactly (the R ``effsize`` package's definition) rather than approximated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy import stats as _scipy_stats
except ImportError:  # pragma: no cover - scipy is installed beside numpy
    _scipy_stats = None


def _as_clean_array(values: Sequence[float]) -> np.ndarray:
    arr = np.asarray([v for v in values if v is not None], dtype=np.float64)
    return arr[~np.isnan(arr)]


def iqr_mask(values: Sequence[float], k: float = 1.5) -> np.ndarray:
    """True where the value is inside [Q1 - k·IQR, Q3 + k·IQR] (nb cell 11)."""
    arr = np.asarray(values, dtype=np.float64)
    q1, q3 = np.nanpercentile(arr, [25, 75])
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    with np.errstate(invalid="ignore"):
        return (arr >= lo) & (arr <= hi)


@dataclasses.dataclass
class Descriptives:
    n: int
    mean: float
    median: float
    sd: float
    minimum: float
    maximum: float
    cv: float = math.nan  # coefficient of variation sd/|mean| (BASELINE.md's
    # "≤5% run-to-run variance" target is stated as a CV)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def descriptives(values: Sequence[float]) -> Descriptives:
    arr = _as_clean_array(values)
    if arr.size == 0:
        return Descriptives(
            0, math.nan, math.nan, math.nan, math.nan, math.nan, math.nan
        )
    mean = float(np.mean(arr))
    sd = float(np.std(arr, ddof=1)) if arr.size > 1 else 0.0
    return Descriptives(
        n=int(arr.size),
        mean=mean,
        median=float(np.median(arr)),
        sd=sd,
        minimum=float(np.min(arr)),
        maximum=float(np.max(arr)),
        cv=sd / abs(mean) if mean else math.nan,
    )


def skewness(values: Sequence[float]) -> float:
    """Sample skewness g1 (nb cell 35 uses e1071::skewness to decide which
    subsets need a transform before parametric checks)."""
    arr = _as_clean_array(values)
    if arr.size < 3:
        return math.nan
    if _scipy_stats is not None:
        return float(_scipy_stats.skew(arr))
    m = arr.mean()
    s = arr.std()
    if s == 0:
        return 0.0
    return float(np.mean(((arr - m) / s) ** 3))


def shapiro_wilk(values: Sequence[float]) -> Tuple[float, float]:
    """(W, p). Requires scipy; raises otherwise (nb cell 33)."""
    if _scipy_stats is None:
        raise RuntimeError("scipy is required for shapiro_wilk")
    arr = _as_clean_array(values)
    w, p = _scipy_stats.shapiro(arr)
    return float(w), float(p)


def wilcoxon_rank_sum(
    a: Sequence[float], b: Sequence[float]
) -> Tuple[float, float]:
    """Two-sided unpaired Wilcoxon rank-sum / Mann-Whitney U (nb cell 37:
    R's ``wilcox.test(x, y)`` on independent samples). Returns (U, p)."""
    if _scipy_stats is None:
        raise RuntimeError("scipy is required for wilcoxon_rank_sum")
    aa, bb = _as_clean_array(a), _as_clean_array(b)
    u, p = _scipy_stats.mannwhitneyu(aa, bb, alternative="two-sided")
    return float(u), float(p)


CLIFFS_THRESHOLDS = (
    (0.147, "negligible"),
    (0.33, "small"),
    (0.474, "medium"),
)


def cliffs_delta(a: Sequence[float], b: Sequence[float]) -> Tuple[float, str]:
    """Exact Cliff's delta: P(a>b) − P(a<b), with the effsize magnitude labels
    the notebook uses (.147/.33/.474 — nb cell 37)."""
    aa, bb = _as_clean_array(a), _as_clean_array(b)
    if aa.size == 0 or bb.size == 0:
        return math.nan, "undefined"
    # O(n log n) via ranking rather than the O(n·m) double loop.
    more = 0
    less = 0
    sorted_b = np.sort(bb)
    for x in aa:
        more += np.searchsorted(sorted_b, x, side="left")
        less += bb.size - np.searchsorted(sorted_b, x, side="right")
    delta = (more - less) / (aa.size * bb.size)
    magnitude = "large"
    for threshold, label in CLIFFS_THRESHOLDS:
        if abs(delta) < threshold:
            magnitude = label
            break
    return float(delta), magnitude


def spearman(a: Sequence[float], b: Sequence[float]) -> Tuple[float, float]:
    """Spearman ρ and p (nb cell 42). Pairs with None/NaN are dropped."""
    if _scipy_stats is None:
        raise RuntimeError("scipy is required for spearman")
    pairs = [
        (x, y)
        for x, y in zip(a, b)
        if x is not None and y is not None
        and not (isinstance(x, float) and math.isnan(x))
        and not (isinstance(y, float) and math.isnan(y))
    ]
    if len(pairs) < 3:
        return math.nan, math.nan
    xs, ys = zip(*pairs)
    rho, p = _scipy_stats.spearmanr(xs, ys)
    return float(rho), float(p)


def significance_stars(p: float) -> str:
    """R-style stars (nb cell 42)."""
    if math.isnan(p):
        return ""
    if p < 0.001:
        return "***"
    if p < 0.01:
        return "**"
    if p < 0.05:
        return "*"
    if p < 0.1:
        return "."
    return ""
