"""Plots mirroring the reference notebook's figure set, via matplotlib.

Reference (data-analysis/analysis-visualization.ipynb): violin+density per
metric (cells 21-26), QQ plots (cell 28), scatter + linear fit (cells 39-40).
All functions no-op with a warning when matplotlib is missing (nothing may be
pip-installed in this environment).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Sequence

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover
    plt = None

from ..runner import term


def _groups(
    rows: List[Dict[str, Any]], metric: str, by: str
) -> Dict[Any, List[float]]:
    out: Dict[Any, List[float]] = {}
    for row in rows:
        v = row.get(metric)
        if v is None or (isinstance(v, float) and math.isnan(v)):
            continue
        out.setdefault(row.get(by), []).append(float(v))
    return dict(sorted(out.items(), key=lambda kv: str(kv[0])))


def violin_by(
    rows: List[Dict[str, Any]],
    metric: str,
    by: str,
    out_path: Path,
    title: str = "",
) -> bool:
    """Violin plot of ``metric`` grouped by factor ``by`` (nb cells 21-26)."""
    if plt is None:
        term.log_warn("matplotlib unavailable; skipping violin plot")
        return False
    groups = _groups(rows, metric, by)
    groups = {k: v for k, v in groups.items() if len(v) >= 2}
    if not groups:
        return False
    fig, ax = plt.subplots(figsize=(1.8 * len(groups) + 2, 4))
    ax.violinplot(list(groups.values()), showmedians=True)
    ax.set_xticks(range(1, len(groups) + 1))
    ax.set_xticklabels([str(k) for k in groups], rotation=30, ha="right")
    ax.set_ylabel(metric)
    ax.set_title(title or f"{metric} by {by}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def density_by(
    rows: List[Dict[str, Any]],
    metric: str,
    by: str,
    out_path: Path,
    title: str = "",
) -> bool:
    """Overlaid KDE density curves of ``metric`` per level of ``by``
    (nb cells 21-26 pair every violin with a density panel)."""
    if plt is None:
        term.log_warn("matplotlib unavailable; skipping density plot")
        return False
    import numpy as np

    try:
        from scipy.stats import gaussian_kde
    except ImportError:  # pragma: no cover
        return False
    groups = {
        k: v for k, v in _groups(rows, metric, by).items() if len(v) >= 3
    }
    groups = {k: v for k, v in groups.items() if len(set(v)) > 1}
    if not groups:
        return False
    fig, ax = plt.subplots(figsize=(6, 4))
    lo = min(min(v) for v in groups.values())
    hi = max(max(v) for v in groups.values())
    pad = 0.1 * (hi - lo or 1.0)
    grid = np.linspace(lo - pad, hi + pad, 256)
    for label, vals in groups.items():
        try:
            kde = gaussian_kde(vals)
        except Exception:  # noqa: BLE001 - singular data
            continue
        ax.plot(grid, kde(grid), label=str(label))
        ax.fill_between(grid, kde(grid), alpha=0.15)
    ax.set_xlabel(metric)
    ax.set_ylabel("density")
    ax.set_title(title or f"{metric} density by {by}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def violin_panel_by_model(
    rows: List[Dict[str, Any]],
    metric: str,
    out_path: Path,
    model_factor: str = "model",
    location_factor: str = "location",
    title: str = "",
) -> bool:
    """Per-LLM violin panel: one subplot per model, violins of ``metric``
    per location (nb cells 21-26's per-LLM figures)."""
    if plt is None:
        term.log_warn("matplotlib unavailable; skipping violin panel")
        return False
    models = sorted(
        {str(r.get(model_factor)) for r in rows if r.get(model_factor)}
    )
    panels = []
    for model in models:
        sub = [r for r in rows if str(r.get(model_factor)) == model]
        groups = {
            k: v
            for k, v in _groups(sub, metric, location_factor).items()
            if len(v) >= 2
        }
        if groups:
            panels.append((model, groups))
    if not panels:
        return False
    ncols = min(4, len(panels))
    nrows = -(-len(panels) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(3.2 * ncols, 3.2 * nrows), squeeze=False
    )
    for i, (model, groups) in enumerate(panels):
        ax = axes[i // ncols][i % ncols]
        ax.violinplot(list(groups.values()), showmedians=True)
        ax.set_xticks(range(1, len(groups) + 1))
        ax.set_xticklabels([str(k) for k in groups], rotation=20, ha="right")
        ax.set_title(model, fontsize=9)
        if i % ncols == 0:
            ax.set_ylabel(metric)
    for j in range(len(panels), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.suptitle(title or f"{metric} by {location_factor}, per model")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def qq_plot(values: Sequence[float], out_path: Path, title: str = "") -> bool:
    """Normal QQ plot (nb cell 28)."""
    if plt is None:
        term.log_warn("matplotlib unavailable; skipping QQ plot")
        return False
    import numpy as np

    vals = np.sort(np.asarray([v for v in values if v is not None], dtype=float))
    if vals.size < 3:
        return False
    # Normal quantiles via the probit approximation (Acklam/Beasley-Springer).
    try:
        from scipy import stats as scipy_stats

        theo = scipy_stats.norm.ppf((np.arange(vals.size) + 0.5) / vals.size)
    except ImportError:  # pragma: no cover
        return False
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(theo, vals, s=8)
    mu, sd = float(np.mean(vals)), float(np.std(vals))
    ax.plot(theo, mu + sd * theo, "r-", linewidth=1)
    ax.set_xlabel("theoretical quantiles")
    ax.set_ylabel("sample quantiles")
    ax.set_title(title or "QQ plot")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def scatter_lm(
    rows: List[Dict[str, Any]],
    x_metric: str,
    y_metric: str,
    out_path: Path,
    title: str = "",
) -> bool:
    """Scatter with least-squares line (nb cells 39-40)."""
    if plt is None:
        term.log_warn("matplotlib unavailable; skipping scatter plot")
        return False
    import numpy as np

    pts = [
        (row[x_metric], row[y_metric])
        for row in rows
        if row.get(x_metric) is not None and row.get(y_metric) is not None
    ]
    if len(pts) < 3:
        return False
    xs, ys = map(np.asarray, zip(*pts))
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(xs, ys, s=10, alpha=0.6)
    slope, intercept = np.polyfit(xs, ys, 1)
    grid = np.linspace(xs.min(), xs.max(), 50)
    ax.plot(grid, slope * grid + intercept, "r-", linewidth=1)
    ax.set_xlabel(x_metric)
    ax.set_ylabel(y_metric)
    ax.set_title(title or f"{y_metric} vs {x_metric}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def plot_experiment(
    rows: List[Dict[str, Any]],
    out_dir: Path,
    metrics: Sequence[str] = ("energy_J", "execution_time_s"),
    location_factor: str = "location",
    model_factor: str = "model",
) -> List[Path]:
    """The notebook's figure set for one experiment."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: List[Path] = []
    for metric in metrics:
        for by in (location_factor, model_factor):
            path = out_dir / f"violin_{metric}_by_{by}.png"
            if violin_by(rows, metric, by, path):
                written.append(path)
        path = out_dir / f"density_{metric}_by_{location_factor}.png"
        if density_by(rows, metric, location_factor, path):
            written.append(path)
        path = out_dir / f"violin_{metric}_per_model.png"
        if violin_panel_by_model(
            rows,
            metric,
            path,
            model_factor=model_factor,
            location_factor=location_factor,
        ):
            written.append(path)
        vals = [r.get(metric) for r in rows if r.get(metric) is not None]
        path = out_dir / f"qq_{metric}.png"
        if qq_plot(vals, path, title=f"QQ: {metric}"):
            written.append(path)
    if len(metrics) >= 2:
        path = out_dir / f"scatter_{metrics[1]}_vs_{metrics[0]}.png"
        if scatter_lm(rows, metrics[0], metrics[1], path):
            written.append(path)
    return written
